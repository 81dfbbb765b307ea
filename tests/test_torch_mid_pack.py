"""The ENet mid kernels' pack and decomposition (ops/kernels/mid.py,
csrc/mid.cu), on the CPU.

The CUDA kernels read every layer as a GEMM record: the weights padded
to a bank-conflict-free stride, B2_0's 2x2/s2 projection as four taps of
64 channels, each 3x3 (at any dilation) as nine taps and the asymmetric
5x1 and 1x5 as five taps each, of 32 channels. A block computes its
projection over its 16x16 tile plus the conv's halo (fused) or reads it
from a separate launch. These tests unpack the records and hold them to
the model's folded weights (exactly), rebuild each decomposed layer in
torch the way the kernels compute it (implicit-GEMM taps with zeros
outside the grid, the asymmetric pair, the fused projection over a tile
and its halo, B2_0's K = 256 projection) and hold it to the model's own
block, pin the precision gate's premise for the mid's y, and hold the
mid's CPU path on both routes to the JAX package's Pallas mid kernel in
interpret mode.

Tolerance: packed weights exact; a rebuilt layer against the model's
atol = rtol = 1e-5 (the same products summed in another order); the
CPU path against the Pallas kernel atol = rtol = 1e-4 (as in
test_torch_kernels.py), switches exact where the pooled window's top-2
gap exceeds 1e-4."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from semanticsegmentationactivelearning_tpu.models import ENet as JaxENet
from semanticsegmentationactivelearning_tpu.ops import pallas_kernels
from semanticsegmentationactivelearning_tpu_torch.models import ENet
from semanticsegmentationactivelearning_tpu_torch.models.enet import (
    DILATED_SPEC)
from semanticsegmentationactivelearning_tpu_torch.ops import nn as xops
from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
    front, mid, packing)

from _torch_parity import noised_variables, port_model

TOL = dict(rtol=1e-5, atol=1e-5)
T = 16  # the kernels' tile side
BLOCKS = [f"Bottleneck{s}_{i}" for s in (2, 3) for i in range(1, 9)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process while the suite's workers share the
    cores: with a thread per core in each worker this file's torch work
    ran tens of times slower than alone. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(seed=0):
    """An ENet with numpy-seeded weights and noised BN statistics."""
    m = ENet(19)
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in m.state_dict().items():
        if k.endswith("running_mean") or k.endswith(".bias"):
            v = torch.tensor(rng.normal(size=v.shape, scale=0.3))
        elif k.endswith("running_var"):
            v = 1 + torch.tensor(np.abs(rng.normal(size=v.shape, scale=0.3)))
        elif k.endswith(".weight") or k.endswith(".alpha"):
            v = torch.tensor(rng.uniform(-0.5, 0.5, size=v.shape))
        sd[k] = v.float()
    m.load_state_dict(sd)
    return m.eval()


@pytest.fixture(scope="module")
def model():
    return _model()


def _records(pack, kind):
    """(weight [taps, k, s], vectors) of each record of a pack, the
    projection's k rows put back in channel order."""
    out = []
    for i, (off, taps, k, n, s, nv) in enumerate(mid.mid_layout(kind)):
        end = off + taps * k * s
        w = pack[off:end].reshape(taps, k, s)
        if i == 0:
            w = w[:, torch.argsort(packing.vec4_order(k))]
        out.append((w, [pack[end + j * n:end + (j + 1) * n]
                        for j in range(nv)]))
    return out


def _block_records(model, name):
    blk = getattr(model, name)
    kind = mid.block_kind(blk)
    return blk, _records(mid.pack_block(blk), kind)


def _randn(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


def _taps(xp, offsets, h, w):
    """The windows of the padded ``xp`` at each (row, col) offset."""
    return [xp[:, r:r + h, c:c + w] for r, c in offsets]


def _gemm(windows, w, k, n):
    """sum over taps of window @ w[t][:k, :n]: the implicit GEMM."""
    return sum(win @ w[t, :k, :n] for t, win in enumerate(windows))


@pytest.mark.parametrize("kind", sorted(mid.KINDS))
def test_layout_strides_and_sizes(model, kind):
    layout = mid.mid_layout(kind)
    assert [r[1:4] for r in layout] == [r[:3] for r in mid.KINDS[kind]]
    for off, taps, k, n, s, nv in layout:
        assert s % 32 in (8, 24) and s >= n and n % 8 == 0 and k % 8 == 0
        assert off % 4 == 0  # 16-byte cp.async pieces
    off, taps, k, n, s, nv = layout[-1]
    size = off + taps * k * s + nv * n
    packs = mid.pack_mid(model)
    assert len(packs) == 1 + len(BLOCKS)
    want = [p for p, blk in zip(packs[1:], model.blocks(model.stage23))
            if mid.block_kind(blk) == kind]
    if kind == "b20":
        want = [packs[0]]
    assert want and all(p.numel() == size for p in want)


@pytest.mark.parametrize("k", [64, 128])
def test_vec4_order_matches_the_lane_reads(k):
    """A lane q that reads A[16g + 4q .. 16g + 4q + 3] at once feeds the
    first two to k-step 2g's columns q and q+4 and the last two to k-step
    2g+1's (csrc/tc.cuh gemm VEC4): the record's rows 16g + q, +q+4,
    +8+q, +12+q must hold those channels."""
    order = packing.vec4_order(k).tolist()
    assert sorted(order) == list(range(k))
    for g in range(k // 16):
        for q in range(4):
            base = 16 * g + 4 * q
            assert [order[16 * g + q], order[16 * g + q + 4],
                    order[16 * g + 8 + q], order[16 * g + 12 + q]] == \
                [base, base + 1, base + 2, base + 3]


def test_launch_plan():
    """The asymmetric blocks and the dilated ones up to
    FUSE_MAX_DILATION are fused (one launch); the others take two;
    B2_0 one. The kernel's shared memory holds a halo of at most 4."""
    assert 1 <= mid.FUSE_MAX_DILATION <= 4
    launches = 1
    for d, asym in DILATED_SPEC * 2:
        assert mid.fused(d, asym) == (asym or d <= mid.FUSE_MAX_DILATION)
        launches += 1 if mid.fused(d, asym) else 2
    assert mid.LAUNCHES_PER_CALL == launches
    assert set(mid.PRECISION) == {"predict", "score"}


def _check(rec, want_w, want_vecs=()):
    w, vecs = rec
    t, k0, n0 = want_w.shape
    torch.testing.assert_close(w[:, :k0, :n0], want_w, rtol=0, atol=0)
    assert (w[:, k0:] == 0).all() and (w[:, :, n0:] == 0).all()
    assert len(vecs) == len(want_vecs)
    for v, want in zip(vecs, want_vecs):
        torch.testing.assert_close(v[:want.numel()], want.detach(),
                                   rtol=0, atol=0)
        assert (v[want.numel():] == 0).all()


def _flat(w):
    return w.reshape(-1, *w.shape[2:])


@pytest.mark.parametrize("name", ["Bottleneck2_0"] + BLOCKS)
def test_pack_rebuilds_the_folded_weights(model, name):
    """Every record holds its layer's folded weights and vectors
    exactly (HWIO taps in row-major order), zeros in the padding."""
    blk = getattr(model, name)
    if name == "Bottleneck2_0":
        rec = _records(mid.pack_b20(blk), "b20")
    else:
        rec = _records(mid.pack_block(blk), mid.block_kind(blk))
    w, *v = packing.affine(packing.hwio(blk.proj_conv), blk.proj_bn,
                           blk.proj_prelu)
    _check(rec[0], _flat(w), v)
    if getattr(blk, "asymmetric", False):
        _check(rec[1], _flat(packing.hwio(blk.conv_col)))
        w, *v = packing.affine(packing.hwio(blk.conv_row), blk.conv_bn,
                               blk.conv_prelu)
        _check(rec[2], _flat(w), v)
    else:
        w, *v = packing.affine(packing.hwio(blk.conv), blk.conv_bn,
                               blk.conv_prelu)
        _check(rec[1], _flat(w), v)
    w, t = packing.affine(packing.hwio(blk.exp_conv), blk.exp_bn)
    _check(rec[-1], _flat(w), (t, blk.res_prelu.alpha))


@pytest.mark.parametrize("hw", [(6, 10), (20, 35)], ids=["6x10", "20x35"])
@pytest.mark.parametrize("name", ["Bottleneck2_1", "Bottleneck2_2",
                                  "Bottleneck2_4", "Bottleneck2_6",
                                  "Bottleneck2_8"],
                         ids=["d1", "d2", "d4", "d8", "d16"])
def test_dilated_conv_as_implicit_gemm(model, name, hw):
    """A dilated 3x3 + BN + PReLU as the kernels compute it: one product
    of the nine shifted tiles (taps outside the grid read zeros: SAME
    padding at dilation d, also where d exceeds the grid, as d = 16 on
    6x10) by the K = 9 x 32 record."""
    blk, rec = _block_records(model, name)
    d = blk.dilation
    h, w = hw
    p = _randn((2, h, w, 32), d)
    pp = F.pad(p, (0, 0, d, d, d, d))
    wins = _taps(pp, [(kh * d, kw * d) for kh in range(3) for kw in range(3)],
                 h, w)
    wc, (b, alpha) = rec[1]
    got = xops.prelu(_gemm(wins, wc, 32, 32) + b, alpha)
    with torch.no_grad():
        want = blk.conv_prelu(blk.conv_bn(blk.conv(p)))
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("name", ["Bottleneck2_3", "Bottleneck3_7"])
def test_asymmetric_pair_as_two_gemms(model, name):
    """The 5x1 (no bias or BN) as one K = 5 x 32 product over the rows,
    zero outside the grid, then the 1x5 as another over the columns,
    + BN + PReLU."""
    blk, rec = _block_records(model, name)
    p = _randn((2, 7, 9, 32), 5)
    pp = F.pad(p, (0, 0, 0, 0, 2, 2))
    a = _gemm(_taps(pp, [(t, 0) for t in range(5)], 7, 9), rec[1][0], 32, 32)
    assert rec[1][1] == []
    ap = F.pad(a, (0, 0, 2, 2))
    wr, (b, alpha) = rec[2]
    got = xops.prelu(_gemm(_taps(ap, [(0, t) for t in range(5)], 7, 9), wr,
                           32, 32) + b, alpha)
    with torch.no_grad():
        want = blk.conv_prelu(blk.conv_bn(blk.spatial(p)))
    torch.testing.assert_close(got, want, **TOL)


def _block_on_tile(blk, rec, x, r0, c0):
    """One block on the 16x16 tile at (r0, c0) as the fused kernel
    computes it: the projection over the tile plus the halo h (zero
    outside the grid), the spatial GEMMs on that rectangle, the expand
    with the bias, the residual and the PReLU; the tile's part inside
    the grid."""
    n, H, W, _ = x.shape
    h = 2 if blk.asymmetric else blk.dilation
    rs = T + 2 * h
    rows = torch.arange(r0 - h, r0 - h + rs)
    cols = torch.arange(c0 - h, c0 - h + rs)
    inside = (((rows >= 0) & (rows < H))[:, None]
              & ((cols >= 0) & (cols < W))[None, :])[None, :, :, None]
    xr = torch.zeros(n, rs, rs, 128)
    rin = rows.clamp(0, H - 1)
    cin = cols.clamp(0, W - 1)
    xr = torch.where(inside, x[:, rin][:, :, cin], xr)
    wp, (bp, ap) = rec[0]
    pr = xops.prelu(xr @ wp[0, :, :32] + bp, ap) * inside
    if blk.asymmetric:
        a = _gemm(_taps(pr, [(t, 0) for t in range(5)], T, rs), rec[1][0],
                  32, 32) * inside[:, h:h + T]
        wr, (b, alpha) = rec[2]
        c = xops.prelu(_gemm(_taps(a, [(0, t) for t in range(5)], T, T), wr,
                             32, 32) + b, alpha)
    else:
        d = blk.dilation
        wc, (b, alpha) = rec[1]
        c = xops.prelu(_gemm(_taps(
            pr, [(h + (kh - 1) * d, h + (kw - 1) * d) for kh in range(3)
                 for kw in range(3)], T, T), wc, 32, 32) + b, alpha)
    we, (be, ae) = rec[-1]
    res = xr[:, h:h + T, h:h + T]
    out = xops.prelu(c @ we[0, :32, :128] + be + res, ae)
    return out[:, :max(0, min(T, H - r0)), :max(0, min(T, W - c0))]


@pytest.mark.parametrize("name", ["Bottleneck2_1", "Bottleneck2_2",
                                  "Bottleneck2_3", "Bottleneck2_4"],
                         ids=["d1", "d2", "asym", "d4"])
def test_fused_block_over_tiles_matches_the_block(model, name):
    """The fused block, tile by tile (corner, inner and ragged tiles of a
    20x35 grid), equals the model's block on the whole grid."""
    blk, rec = _block_records(model, name)
    assert mid.fused(blk.dilation, blk.asymmetric)
    x = _randn((2, 20, 35, 128), 7)
    with torch.no_grad():
        want = blk(x)
    for r0 in (0, 16):
        for c0 in (0, 16, 32):
            got = _block_on_tile(blk, rec, x, r0, c0)
            torch.testing.assert_close(
                got, want[:, r0:r0 + T, c0:c0 + T], **TOL)


def test_b20_as_gemms_matches_the_block(model):
    """B2_0 as b20_kernel computes it: the 2x2/s2 projection as one K =
    4 x 64 product of the window's four positions, the 3x3 as K = 9 x
    32, the expand, + the pooled residual (channels < 64) and PReLU."""
    blk = model.Bottleneck2_0
    rec = _records(mid.pack_b20(blk), "b20")
    x1 = _randn((2, 12, 18, 64), 8)
    wins = [x1[:, t // 2::2, t % 2::2] for t in range(4)]
    wp, (bp, ap) = rec[0]
    p = xops.prelu(_gemm(wins, wp, 64, 32) + bp, ap)
    pp = F.pad(p, (0, 0, 1, 1, 1, 1))
    wc, (bc, ac) = rec[1]
    c = xops.prelu(_gemm(_taps(pp, [(kh, kw) for kh in range(3)
                                    for kw in range(3)], 6, 9), wc, 32, 32)
                   + bc, ac)
    we, (be, ae) = rec[2]
    pooled = torch.stack(wins, dim=-1).max(dim=-1).values
    got = xops.prelu(c @ we[0, :, :128] + be + F.pad(pooled, (0, 64)), ae)
    with torch.no_grad():
        want, sw = blk(x1)
    torch.testing.assert_close(got, want, **TOL)
    first = torch.stack(wins, dim=-1).argmax(dim=-1)  # the first maximum
    torch.testing.assert_close(sw.reshape(first.shape).long(), first)


def test_wrapper_on_other_devices(model):
    """On the CPU the wrapper takes the plain version on both routes and
    counts no launch; a tensor on another device raises."""
    before = mid.fused_mid_stage23.launches
    x1 = _randn((1, 8, 12, 64), 9)
    want = mid.mid_stage23_plain(x1, model)
    for score in (False, True):
        got = mid.fused_mid_stage23(x1, model, score=score)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert mid.fused_mid_stage23.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        mid.fused_mid_stage23(torch.empty(1, 8, 8, 64, device="meta"), model)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_y_precision_gate_separates_tf32_from_bf16(seed):
    """The premise of chip_smoke's PRECISION_GATE for the mid's y: on
    the smoke's seeded ENet-19 (at 128x256), the plain mid with every
    product in TF32 reads under half the error of the same in bf16, so a
    kernel computing in bf16 fails the score route's gate; and the TF32
    error stays under 1e-3 of the maximum."""
    import chip_smoke
    m = ENet(19)
    m.load_state_dict(chip_smoke.seeded_state_dict(m, seed))
    m.eval()
    rng = np.random.default_rng(seed + 3)
    image = torch.from_numpy(rng.integers(0, 256, (2, 128, 256, 3),
                                          dtype=np.uint8)).float() / 255
    with torch.no_grad():
        x1, _ = front.front_stage1_plain(image, m)
        y, _ = mid.mid_stage23_plain(x1, m)
    lower, rnd, share = chip_smoke.PRECISION_GATE[mid.PRECISION["score"]]
    assert lower == "bf16" and share == 0.5

    def plain(mm):
        return mid.mid_stage23_plain(x1, mm)[0]

    err = {name: (chip_smoke.rounded(m, r, plain) - y).abs().max()
           for name, r in (("TF32", chip_smoke.round_tf32),
                           ("bf16", rnd))}
    assert 0 < err["TF32"] < share * err["bf16"]
    assert err["TF32"] < 1e-3 * y.abs().max()


def _window_gap(x):
    n, h, w, c = x.shape
    win = x.reshape(n, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 5, 2, 4)
    top2 = np.sort(win.reshape(n, h // 2, w // 2, c, 4), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.fixture(scope="module")
def jax_mid():
    """The Pallas mid kernel in interpret mode on a seeded x1 (W/8 a
    multiple of 4, as its W-packing needs), with the port's model on the
    same converted weights."""
    jm = JaxENet(num_classes=5)
    variables = noised_variables(jm, np.zeros((1, 64, 128, 3), np.float32),
                                 11)
    x1 = np.random.default_rng(12).normal(size=(1, 16, 32, 64)) \
        .astype(np.float32)
    packed, meta = pallas_kernels.pack_enet_mid_w(variables)
    y, sw2 = pallas_kernels.fused_mid_stage23_w(
        jnp.asarray(x1), packed, meta, interpret=True, out_dtype=jnp.float32)
    return port_model(variables, 5), x1, np.asarray(y), np.asarray(sw2)


@pytest.mark.parametrize("score", [False, True], ids=["predict", "score"])
def test_cpu_path_matches_pallas_mid(jax_mid, score):
    tm, x1, want_y, want_sw2 = jax_mid
    y, sw2 = mid.fused_mid_stage23(torch.from_numpy(x1), tm, score=score)
    assert y.shape == (1, 8, 16, 128) and sw2.dtype == torch.int8
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-4, atol=1e-4)
    decided = _window_gap(x1) > 1e-4
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(sw2.numpy()[decided], want_sw2[decided])
