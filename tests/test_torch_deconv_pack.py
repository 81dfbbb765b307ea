"""ENet's deconv score kernel (``deconv_score_kernel``, csrc/tail.cu;
wrapper ``deconv_score.fused_deconv_entropy_score``): its record, its
tiling and its precision, on the CPU (18 tests, about 12 s on one
process).

A block takes a tile of DECONV_ROWS x 16 half-res positions (16 x 16).
It stages the pre-Final features over the tile, the row above and the
column to its left (zero outside the half-res grid: the ``x[-1] = 0``
edge at the top and left, nothing past the bottom and right) and the
Final's GEMM record (``tail.pack_final``), then runs the tail's Final
(``final_phases``, shared with ``tail5_kernel``): per output phase one
product over its exact taps, in one TF32 pass, and the entropy
confidence of each pixel inside the image, summed per tile. These tests
hold the record to the tail pack's Final bit for bit, the kernel rebuilt
tile by tile in torch to the plain version at ragged shapes and to the
Pallas kernel in interpret mode, and the premise of chip_smoke.py's
precision gate on the kernel's tile sums.

Tolerances: records exact; the rebuilt kernel in fp32 against the plain
version and the Pallas kernel: scores atol 1e-5, tile sums 1e-5 a pixel
(the same products summed in another order)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsegmentationactivelearning_tpu.ops import pallas_kernels
from semanticsegmentationactivelearning_tpu_torch.models import ENet
from semanticsegmentationactivelearning_tpu_torch.ops import acquisition
from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
    deconv_score, packing, tail)

from chip_smoke import (PRECISION_GATE, SCORE_SCALES, centred_max,
                        round_tf32, rounded, seeded_state_dict)

SOURCE = (Path(tail.__file__).resolve().parents[2] / "csrc"
          / "tail.cu").read_text()
# the kernel's tile and precision, as the source states them
ROWS = int(re.search(r"constexpr int DECONV_ROWS = (\d+),",
                     SOURCE).group(1))
COLS = int(re.search(r"constexpr int T5 = (\d+);", SOURCE).group(1))
SCORE_PASSES = int(re.search(r"kScorePasses = (\d+);", SOURCE).group(1))
PHASE_TAP = (0, 4, 6, 8)  # csrc/tail.cu kPhaseTap


def _model(c, seed=1, scale=25.0):
    m = ENet(c)
    m.load_state_dict(seeded_state_dict(m, seed, scale))
    return m.eval()


def _features(n, h2, w2, seed):
    """PReLU'd features, as Bottleneck5_1 writes them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h2, w2, 16))
    return torch.from_numpy(np.where(x > 0, x, 0.25 * x).astype(np.float32))


def deconv_tiles(x, record, c, rnd=None):
    """deconv_score_kernel rebuilt tile by tile: each tile's sum of
    confidences over its pixels inside the image, ``[N, tiles]`` with the
    tiles row by row, as the kernel writes its partials. A tile reads its
    staged rectangle (zero outside the grid), each phase its exact taps
    of the phase-major record; with ``rnd`` both operands rounded by it
    (round_tf32: one TF32 pass)."""
    n, h2, w2, _ = x.shape
    w = record.reshape(9, 16, -1)[..., :c]
    if rnd is not None:
        x, w = rnd(x), rnd(w)
    sums = []
    for r0 in range(0, h2, ROWS):
        for c0 in range(0, w2, COLS):
            rect = torch.zeros(n, ROWS + 1, COLS + 1, 16)
            r1, c1 = min(r0 + ROWS, h2), min(c0 + COLS, w2)
            rect[:, max(1 - r0, 0):r1 - r0 + 1, max(1 - c0, 0):c1 - c0 + 1] \
                = x[:, max(r0 - 1, 0):r1, max(c0 - 1, 0):c1]
            total = torch.zeros(n, dtype=torch.float64)
            for ph in range(4):
                a, b = ph >> 1, ph & 1
                nc, taps = 1 if b else 2, (1 if a else 2) * (1 if b else 2)
                logits = 0
                for t in range(taps):
                    tr, tc = t // nc, t % nc
                    logits = logits + rect[:, 1 - tr:ROWS + 1 - tr,
                                           1 - tc:COLS + 1 - tc] \
                        @ w[PHASE_TAP[ph] + t]
                p = torch.softmax(logits, dim=-1)
                conf = 1 + (p * torch.log_softmax(logits, dim=-1)).sum(-1) \
                    / np.log(c)
                rows = (2 * torch.arange(r0, r0 + ROWS) + a) < 2 * h2
                cols = (2 * torch.arange(c0, c0 + COLS) + b) < 2 * w2
                total += conf[:, rows][:, :, cols].sum((1, 2)).double()
            sums.append(total)
    return torch.stack(sums, dim=1).float()


def tile_score(sums, x):
    """Per-image scores of per-tile sums: their sum over the pixels."""
    return sums.double().sum(1).float() / (4 * x.shape[1] * x.shape[2])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread a process keeps this file at a
    few seconds when the suite's workers share the cores (with a thread
    per core in each worker it took two minutes), restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pre_by_seed():
    """The seeded ENet-19's pre-Final features of a seeded batch, per
    seed (the Final's scale leaves them unchanged): 2 images of 128x256,
    64 tiles."""
    out = {}
    for seed in (0, 1, 2):
        m = _model(19, seed)
        image = torch.from_numpy(np.random.default_rng(seed + 3).integers(
            0, 256, (2, 128, 256, 3), dtype=np.uint8)).float() / 255
        with torch.no_grad():
            out[seed] = m(image, return_pre_logits=True)
    return out


# -- the record ------------------------------------------------------------------

@pytest.mark.parametrize("c", [5, 19, 30])
def test_pack_final_is_the_tail_packs_final(c):
    """tail.pack_final of the model's Final kernel is the tail pack's
    FIN record bit for bit (both kernels read the same bits), its size
    what the wrapper asks for."""
    m = _model(c)
    off, taps, k, n, s, nv = tail.tail_layout(c)[-1]
    got = tail.pack_final(packing.deconv_hwio(m.Final.deconv), c)
    assert got.dtype == torch.float32
    assert got.shape == (taps * k * s,) == (tail.final_size(c),)
    assert nv == 0 and n == tail.final_cp(c)
    want = tail.pack_tail(m)[off:off + taps * k * s]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# -- the kernel's arithmetic, tile by tile ------------------------------------------

# ragged rows and columns, a grid under one tile in rows, batch 2, two
# ragged tile rows
@pytest.mark.parametrize("shape, c", [((2, 8, 20), 19), ((1, 20, 36), 19),
                                      ((1, 20, 36), 5), ((1, 40, 20), 30)],
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_kernel_tiles_match_plain_score(shape, c):
    """The tile rebuild's per-image scores equal deconv_score_plain's,
    its per-tile sums deconv_partials_plain's (atol 1e-5 a pixel)."""
    m = _model(c, seed=2)
    kernel = packing.deconv_hwio(m.Final.deconv)
    x = _features(*shape, seed=5)
    with torch.no_grad():
        want = deconv_score.deconv_score_plain(x, kernel, c)
        want_t = deconv_score.deconv_partials_plain(x, kernel, c)
        got_t = deconv_tiles(x, tail.pack_final(kernel, c), c)
    assert 0.05 < want.min() and want.max() < 0.95
    assert want_t.shape == (shape[0], -(-shape[1] // ROWS)
                            * -(-shape[2] // COLS))
    torch.testing.assert_close(tile_score(got_t, x), want, rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(got_t, want_t, rtol=0,
                               atol=1e-5 * 4 * ROWS * COLS)


def test_kernel_tiles_match_pallas():
    """The tile rebuild against the Pallas kernel in interpret mode."""
    c = 19
    m = _model(c, seed=3)
    kernel = packing.deconv_hwio(m.Final.deconv)
    x = _features(1, 20, 36, seed=6)
    want = pallas_kernels.fused_deconv_entropy_score(
        jnp.asarray(x.numpy()), jnp.asarray(kernel.numpy()), c,
        interpret=True)
    got = tile_score(deconv_tiles(x, tail.pack_final(kernel, c), c), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# -- the precision gate's premise ---------------------------------------------------

@pytest.mark.parametrize("scale", SCORE_SCALES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_precision_gate_premise_on_scores(pre_by_seed, seed, scale):
    """chip_smoke.py phase 5a holds the deconv kernel's per-tile sums
    under PRECISION_GATE["TF32"] by centred_max: the error less each
    image's mean error, under a share of that of the plain Final with
    its operands rounded to bf16. At every seed and scale the kernel's
    one TF32 pass (the tile rebuild with TF32 operands) passes that gate
    and a kernel computing in bf16 (the rebuild with bf16 operands)
    fails it. The mean is taken out because the error of a sum over
    many pixels is mostly one shift from rounding the Final's 2736
    weights, alike in every tile, which a rounding can cancel by chance:
    on the scores themselves, or on the sums with the shift kept, TF32's
    error comes out above half of bf16's at seed 1, x25. The kernel's
    passes are those tail.PRECISION["score"], which picks the gate,
    states."""
    assert tail.PRECISION["score"] == {1: "TF32", 3: "3xTF32"}[SCORE_PASSES]
    lower, rnd, share = PRECISION_GATE["TF32"]
    assert lower == "bf16"
    c = 19
    m = _model(c, seed, scale)
    pre = pre_by_seed[seed]
    record = tail.pack_final(packing.deconv_hwio(m.Final.deconv), c)

    def sums(mm):
        return tail.tile_sums(acquisition.confidence_map(
            mm.Final(pre), "entropy", c))

    with torch.no_grad():
        want = sums(m)
        err = {passes: centred_max(deconv_tiles(pre, record, c, rnd=r)
                                   - want)
               for passes, r in (("TF32", round_tf32), ("bf16", rnd))}
    control = centred_max(rounded(m, rnd, sums, ("Final",)) - want)
    assert err["TF32"] < share * control < err["bf16"], (err, control)


# -- the wrapper on the CPU -----------------------------------------------------------

def test_wrapper_takes_the_plain_path_on_the_cpu():
    """On the CPU the wrapper returns the plain version, with or without
    a record, and deconv_partials the plain per-tile sums, over the
    kernel's tile as the source states it; neither counts a launch."""
    c = 19
    m = _model(c, seed=4)
    kernel = packing.deconv_hwio(m.Final.deconv)
    x = _features(1, 8, 20, seed=7)
    before = deconv_score.fused_deconv_entropy_score.launches
    want = deconv_score.deconv_score_plain(x, kernel, c)
    assert torch.equal(
        deconv_score.fused_deconv_entropy_score(x, kernel, c), want)
    assert torch.equal(deconv_score.fused_deconv_entropy_score(
        x, kernel, c, record=tail.pack_final(kernel, c)), want)
    assert tail.T5 == ROWS == COLS
    assert torch.equal(deconv_score.deconv_partials(x, kernel, c),
                       deconv_score.deconv_partials_plain(x, kernel, c))
    assert deconv_score.fused_deconv_entropy_score.launches == before
