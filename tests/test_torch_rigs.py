"""The plain versions of the port's measurement rigs
(``semanticsegmentationactivelearning_tpu_torch/tools/rigs.py``) against
a numpy computation of the same contracts, on the CPU, where each rig
wrapper runs its plain version.

The JAX package's rigs (``tools/probe_pallas_overhead.py``,
``tools/probe_mosaic_floor.py``, ``tools/probe_front_packing.py``) build
their Pallas kernels inside ``main()`` and run only on a TPU, so they
cannot be imported and called here, and ``tools/`` stays as it is; the
contracts below are read from their kernels. The CUDA kernels are held
against these plain versions on the card (chip_smoke.py phase 9 and the
``cuda``-marked tests of test_torch_cuda.py).

Tolerances: float32 sums rtol 1e-5 (another summation order); bfloat16
chains exact to rtol 1e-6 after the same round-to-nearest-even at every
step (the float32 products of bf16 values agree to ~1e-7, and a sum that
lands on a rounding boundary would show as one bf16 step)."""

import numpy as np
import pytest
import torch

from semanticsegmentationactivelearning_tpu_torch.tools import (
    probe_front_packing, probe_launch_overhead, probe_matmul_floor, rigs)


def _launch_numpy(y, sw, m1, consts, te):
    """tools/probe_pallas_overhead.py: grid (N, H8/te), the stream tiles
    at row-tile offsets -1/0/+1 clipped to the grid; the body sums the
    centre y tile. ``reads`` adds every tile and constant the cell reads."""
    n, h8 = y.shape[:2]
    tiles = h8 // te
    centre = np.zeros((n, tiles))
    reads = np.zeros((n, tiles))
    for i in range(n):
        for j in range(tiles):
            centre[i, j] = y[i, j * te:(j + 1) * te].sum(dtype=np.float64)
            for x in (y, sw, m1):
                for off in (-1, 0, 1):
                    jt = min(max(j + off, 0), tiles - 1)
                    reads[i, j] += x[i, jt * te:(jt + 1) * te].sum(
                        dtype=np.float64)
            reads[i, j] += sum(c.sum(dtype=np.float64) for c in consts)
    return centre, reads


@pytest.mark.parametrize("nconst", [0, 41])
def test_launch_rig_plain_matches_numpy(nconst):
    y, sw, m1, consts = rigs.launch_inputs(2, 12, 5, nconst, 0, "cpu")
    assert [tuple(c.shape) for c in consts[:3]] == list(rigs.CONST_SHAPES
                                                        [:min(nconst, 3)])
    got = rigs.probe_launch(y, sw, m1, consts, 4)
    want = _launch_numpy(*(t.numpy() for t in (y, sw, m1)),
                         [c.numpy() for c in consts], 4)
    for g, w in zip(got, want):
        assert g.shape == (2, 3) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-3)
    assert rigs.probe_launch.launches == 0  # the plain version on the CPU
    # bytes a call reads: 3 tiles of 448 channels and the constants a cell
    per_cell = 3 * 4 * 5 * 448 * 4 + sum(4 * c.numel() for c in consts)
    assert rigs.launch_read_bytes(y, sw, m1, consts, 4) == 2 * 3 * per_cell


def test_launch_rig_rejects_a_ragged_grid():
    y, sw, m1, _ = rigs.launch_inputs(1, 10, 4, 0, 0, "cpu")
    with pytest.raises(ValueError, match="multiple of te"):
        rigs.probe_launch(y, sw, m1, [], 4)


def _bf16(x):
    """Round float32 to bfloat16 (nearest, ties to even) and back."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _matmul_numpy(a, w, m, mode, bf16):
    """tools/probe_mosaic_floor.py (indep, chain, prelu) and
    tools/probe_front_packing.py (nside): float32 products, the chain
    rounded to the input dtype after each."""
    rnd = _bf16 if bf16 else (lambda v: v.astype(np.float32))
    out = []
    for t in range(a.shape[0]):
        cur = a[t]
        if mode == "indep":
            acc = np.zeros((a.shape[1], w.shape[1]), np.float32)
            for _ in range(m):
                acc += cur @ w
            out.append(acc.sum(dtype=np.float64))
            continue
        for _ in range(m):
            y = (cur @ w).astype(np.float32)
            if mode == "prelu":
                y = np.maximum(y, 0) + 0.25 * np.minimum(y, 0)
            elif mode == "nside":
                y = np.tile(y, (1, 8))
            cur = rnd(y)
        out.append(cur.sum(dtype=np.float64))
    return np.array(out)


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("mode", ["indep", "chain", "prelu", "nside"])
def test_matmul_rig_plain_matches_numpy(mode, dtype):
    n_cols = 16 if mode == "nside" else 128
    dt = rigs.dtype_named(dtype)
    a, w = rigs.matmul_inputs(3, 32, n_cols, dt, 1, "cpu")
    got = rigs.probe_matmul(a, w, 9, mode)
    an, wn = a.float().numpy(), w.float().numpy()
    want = _matmul_numpy(an, wn, 9, mode, dtype == "bf16")
    assert got.shape == (3,) and got.dtype == torch.float32
    scale = np.abs(rigs.matmul_final_plain(a, w, 9, mode).numpy()).sum(1)
    assert (scale > 0).all()  # not vacuous
    tol = 1e-6 if dtype == "bf16" else 1e-5
    np.testing.assert_array_less(np.abs(got.numpy() - want), tol * scale)
    assert rigs.matmul_flops(a, w, 9) == 2.0 * 3 * 32 * 128 * n_cols * 9
    assert rigs.probe_matmul.launches == 0


def test_matmul_rig_checks_its_contract():
    a, w = rigs.matmul_inputs(1, 8, 128, torch.float32, 0, "cpu")
    with pytest.raises(ValueError, match="nside"):
        rigs.probe_matmul(a, w, 2, "nside")
    with pytest.raises(ValueError, match="mode"):
        rigs.probe_matmul(a, w, 2, "sideways")
    with pytest.raises(TypeError):
        rigs.probe_matmul(a, w.to(torch.bfloat16), 2, "chain")
    with pytest.raises(ValueError, match="at least 1"):
        rigs.probe_matmul(a, w, 0, "chain")


@pytest.mark.parametrize("script", [probe_launch_overhead, probe_matmul_floor,
                                    probe_front_packing],
                         ids=lambda d: d.__name__.rsplit(".", 1)[-1])
def test_rig_scripts_need_a_cuda_device(script, monkeypatch):
    """A rig measures the card: without one its script raises instead of
    timing the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        script.main([])
