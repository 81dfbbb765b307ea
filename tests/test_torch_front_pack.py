"""The ENet front kernels' pack and decomposition (ops/kernels/front.py,
csrc/front.cu), on the CPU.

The CUDA kernels read Initial's folded weights as a [27][16] table and
every layer of B1_0..B1_4 as a GEMM record: the weights padded to a
bank-conflict-free stride, B1_0's 2x2/s2 projection as one tap of its
four window positions x 16 channels, each 3x3 as nine taps, each expand
with its k rows in the order in which the 3x3's accumulators reach it
(front.acc_order). b10_kernel computes Initial and B1_0 over a 16x16
quarter-res tile plus a halo of 1; stage1_kernel runs one stage-1
bottleneck over a tile, its projection over the tile plus a halo of 1.
These tests unpack the records and hold them to the model's folded weights
(exactly), rebuild each decomposed piece in torch the way the kernels
compute it (the K = 64 projection, implicit-GEMM taps with zeros outside
the grid, the expand fed from the 3x3's accumulators, the two kernels
tile by tile) and hold it to the model's own blocks, hold the kernels'
plain parts, composed, to the plain front, pin the premise of the x1
precision gate and its control, and hold the front's CPU path on both
routes to the JAX package's stage-1 forward (the Pallas front's own
reference; test_torch_kernels.py holds the port to the Pallas front in
interpret mode).

Tolerance: packed weights exact; a rebuilt piece against the model's
atol = rtol = 1e-5 (the same products summed in another order); the
CPU path against the Pallas kernel atol = rtol = 1e-4 (as in
test_torch_kernels.py); switches exact where the pooled window's top-2
gap exceeds 1e-4."""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from semanticsegmentationactivelearning_tpu.models import ENet as JaxENet
from semanticsegmentationactivelearning_tpu_torch.models import ENet, blocks
from semanticsegmentationactivelearning_tpu_torch.ops import nn as xops
from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
    front, packing)

from _torch_parity import noised_variables, port_model

TOL = dict(rtol=1e-5, atol=1e-5)
T = 16  # the kernels' tile side in quarter-res positions
INI_F = 27 * 16 + 3 * 16
PACK_F = 27648  # csrc/front.cu PACK_F
B10 = ((1, 64, 8), (9, 8, 8), (1, 8, 64))    # (taps, k, n): PROJ, CONV, EXP
BLOCK = ((1, 64, 16), (9, 16, 16), (1, 16, 64))
NAMES = ["Bottleneck1_0"] + [f"Bottleneck1_{i}" for i in range(1, 5)]


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


@pytest.fixture(scope="module")
def pack(model):
    return front.pack_front(model)


def _layout():
    """(offset, taps, k, n, stride) of every record of the pack: B1_0's
    three, then three for each of B1_1..1_4."""
    out, off = [], INI_F
    for taps, k, n in B10 + BLOCK * 4:
        s = packing.bstride(n)
        out.append((off, taps, k, n, s))
        off += taps * k * s + 2 * n
    return out


def _records(pack):
    """Per bottleneck (B1_0, B1_1..1_4): three (weight [taps, k, n] as
    stored, bias, alpha)."""
    recs = []
    for off, taps, k, n, s in _layout():
        end = off + taps * k * s
        recs.append((pack[off:end].reshape(taps, k, s)[:, :, :n],
                     pack[end:end + n], pack[end + n:end + 2 * n]))
    return [recs[i:i + 3] for i in range(0, len(recs), 3)]


def _randn(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


def _image(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        size=shape).astype(np.float32))


def _conv3(p, rec):
    """A 3x3 + BN + PReLU as one implicit GEMM over the nine shifted
    windows of ``p`` (its output two rows and columns smaller)."""
    w, b, a = rec
    ho, wo = p.shape[1] - 2, p.shape[2] - 2
    return xops.prelu(sum(p[:, t // 3:t // 3 + ho, t % 3:t % 3 + wo] @ w[t]
                          for t in range(9)) + b, a)


def _expand(c, rec):
    """The expand + BN bias from the 3x3's output in the order its
    accumulators feed the kernel's A fragments."""
    w, b, _ = rec
    return c[..., front.acc_order(c.shape[-1])] @ w[0] + b


def test_layout_strides_and_size(pack):
    for off, taps, k, n, s in _layout():
        assert s % 32 in (8, 24) and s >= n and off % 4 == 0
    off, taps, k, n, s = _layout()[-1]
    assert off + taps * k * s + 2 * n == PACK_F == pack.numel()
    assert front.LAUNCHES_PER_CALL == 1 + front.STAGE1_BLOCKS == 5
    assert front.TC_BLOCKS == tuple(NAMES)
    assert set(front.PRECISION) == {"predict", "score"}


@pytest.mark.parametrize("k", [8, 16])
def test_acc_order_feeds_the_accumulators(k):
    """Lane q holds a 3x3 accumulator's channels 8j + 2q and 8j + 2q + 1
    (mma C fragment) and passes them as its A fragment's columns q and
    q + 4 of k-step j: the record's rows 8j + q and 8j + q + 4 must hold
    those channels."""
    order = front.acc_order(k).tolist()
    assert sorted(order) == list(range(k))
    for j in range(k // 8):
        for q in range(4):
            assert [order[8 * j + q], order[8 * j + q + 4]] == \
                [8 * j + 2 * q, 8 * j + 2 * q + 1]


def test_pack_rebuilds_initial(model, pack):
    ini = model.Initial
    s, t = ini.bn.scale_shift()
    w = pack[:27 * 16].reshape(27, 16)
    want = (packing.hwio(ini.conv) * s[:13]).reshape(27, 13)
    torch.testing.assert_close(w[:, :13], want.detach(), rtol=0, atol=0)
    assert (w[:, 13:] == 0).all()
    vecs = pack[27 * 16:INI_F].reshape(3, 16)
    for got, want in zip(vecs, (s, t, ini.prelu.alpha)):
        torch.testing.assert_close(got, want.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("index", range(5), ids=NAMES)
def test_pack_rebuilds_the_folded_weights(model, pack, index):
    """Every record holds its layer's folded weights and vectors exactly
    (HWIO taps in row-major order; EXP's rows in acc_order), and the
    padding columns are zero."""
    blk = getattr(model, NAMES[index])
    recs = _records(pack)[index]
    for (w, b, a), (conv, bn, pre), order in (
            (recs[0], (blk.proj_conv, blk.proj_bn, blk.proj_prelu), None),
            (recs[1], (blk.conv, blk.conv_bn, blk.conv_prelu), None),
            (recs[2], (blk.exp_conv, blk.exp_bn, blk.res_prelu), True)):
        wt, (bias,) = packing.conv_taps(conv, bn)
        if order:
            wt = wt[:, front.acc_order(wt.shape[1])]
        wt = wt.reshape(w.shape)
        torch.testing.assert_close(w, wt.detach(), rtol=0, atol=0)
        torch.testing.assert_close(b, bias.detach(), rtol=0, atol=0)
        torch.testing.assert_close(a, pre.alpha.detach(), rtol=0, atol=0)
    off, taps, k, n, s = _layout()[3 * index]
    stored = pack[off:off + taps * k * s].reshape(taps, k, s)
    assert (stored[:, :, n:] == 0).all()


def _phases(h0):
    """Initial's output [N, 2h, 2w, 16] as b10_kernel's X0 [N, h, w, 64]:
    channel ph*16 + c holds window position ph = 2a + b."""
    n, hh, ww, _ = h0.shape
    return h0.reshape(n, hh // 2, 2, ww // 2, 2, 16).permute(
        0, 1, 3, 2, 4, 5).reshape(n, hh // 2, ww // 2, 64)


def test_b10_projection_as_one_k64_gemm(model, pack):
    """B1_0's 2x2/s2 projection: one product of the window's four
    positions x 16 channels by the K = 64 record."""
    blk = model.Bottleneck1_0
    h0 = _randn((2, 12, 20, 16), 1)
    w, b, a = _records(pack)[0][0]
    got = xops.prelu(_phases(h0) @ w[0] + b, a)
    with torch.no_grad():
        want = blk.proj_prelu(blk.proj_bn(blk.proj_conv(h0)))
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("index", range(5), ids=NAMES)
def test_conv3_as_implicit_gemm_then_expand(model, pack, index):
    """A 3x3 + BN + PReLU as one product of the nine shifted windows
    (zeros outside the grid: SAME padding) by the K = 9 x F record, then
    the expand fed from its accumulators (acc_order)."""
    blk = getattr(model, NAMES[index])
    recs = _records(pack)[index]
    f = recs[1][0].shape[1]
    p = _randn((2, 7, 11, f), index)
    c = _conv3(F.pad(p, (0, 0, 1, 1, 1, 1)), recs[1])
    with torch.no_grad():
        want = blk.conv_prelu(blk.conv_bn(blk.conv(p)))
        torch.testing.assert_close(c, want, **TOL)
        torch.testing.assert_close(_expand(c, recs[2]),
                                   blk.exp_bn(blk.exp_conv(want)), **TOL)


def _b10_on_tile(pack, image, r0, c0):
    """b10_kernel on the tile at (r0, c0): the image patch (zero outside
    the image), Initial at the four phases of the tile plus a halo of 1
    from the packed [27][16] table, B1_0's projection (zero outside the
    grid), 3x3 and expand, + the pooled residual with first-max switches.
    Returns (x, mask1) of the tile's part inside the grid."""
    n, h, w, _ = image.shape
    hq, wq = h // 4, w // 4
    side = 4 * (T + 2) + 1
    padded = F.pad(image, (0, 0, 4, side, 4, side))  # image row y at y + 4
    patch = padded[:, 4 * r0:4 * r0 + side, 4 * c0:4 * c0 + side] \
        .permute(0, 3, 1, 2)
    wi = pack[:27 * 16].reshape(3, 3, 3, 16)[..., :13].permute(3, 2, 0, 1)
    s, t, a = pack[27 * 16:INI_F].reshape(3, 16)
    conv = F.conv2d(patch, wi, stride=2)               # stride 2, (0, 1)
    pool = F.max_pool2d(patch[:, :, :side - 1, :side - 1], 2) \
        * s[13:, None, None]
    h0 = torch.cat([conv, pool], 1).permute(0, 2, 3, 1)
    x0 = _phases(xops.prelu(h0 + t, a))                # [n, 18, 18, 64]
    rows = torch.arange(r0 - 1, r0 + T + 1)
    cols = torch.arange(c0 - 1, c0 + T + 1)
    inside = (((rows >= 0) & (rows < hq))[:, None]
              & ((cols >= 0) & (cols < wq))[None, :])[None, :, :, None]
    proj, conv3, exp = _records(pack)[0]
    p = xops.prelu(x0 @ proj[0] + proj[1], proj[2]) * inside
    e = _expand(_conv3(p, conv3), exp)
    win = x0[:, 1:T + 1, 1:T + 1].reshape(n, T, T, 4, 16)
    pooled, sw = win.max(dim=3).values, win.argmax(dim=3)
    x = xops.prelu(e + F.pad(pooled, (0, 48)), exp[2])
    mask = (sw[:, :, :, None, :] == torch.arange(4)[:, None]).float()
    rh, rw = min(T, hq - r0), min(T, wq - c0)
    return x[:, :rh, :rw], mask.reshape(n, T, T, 64)[:, :rh, :rw]


@pytest.mark.parametrize("shape", [(1, 40, 72, 3), (2, 8, 8, 3)],
                         ids=["1x40x72", "2x8x8"])
def test_b10_over_tiles_matches_initial_and_b10(model, pack, shape):
    """b10_kernel, tile by tile (a grid ragged on both axes; one smaller
    than a tile), equals Initial + B1_0 on the whole image, switches
    included."""
    image = _image(shape, 2)
    with torch.no_grad():
        want_x, want_m = front.b10_plain(image, model)
    hq, wq = shape[1] // 4, shape[2] // 4
    for r0 in range(0, hq, T):
        for c0 in range(0, wq, T):
            x, m = _b10_on_tile(pack, image, r0, c0)
            torch.testing.assert_close(
                x, want_x[:, r0:r0 + T, c0:c0 + T], **TOL)
            torch.testing.assert_close(
                m, want_m[:, r0:r0 + T, c0:c0 + T], rtol=0, atol=0)


def _block_on_tile(rec, x, r0, c0):
    """stage1_kernel on the tile at (r0, c0): x over the tile plus a halo
    of 1 (zero outside the grid), the projection over it (zero outside
    the grid), then the 3x3 and the expand + residual + PReLU over the
    tile. The tile's part inside the grid."""
    n, hq, wq, _ = x.shape
    proj, conv3, exp = rec
    rows = torch.arange(r0 - 1, r0 + T + 1)
    cols = torch.arange(c0 - 1, c0 + T + 1)
    inside = (((rows >= 0) & (rows < hq))[:, None]
              & ((cols >= 0) & (cols < wq))[None, :])[None, :, :, None]
    xr = torch.where(inside, x[:, rows.clamp(0, hq - 1)]
                     [:, :, cols.clamp(0, wq - 1)], torch.zeros(()))
    p = xops.prelu(xr @ proj[0][0] + proj[1], proj[2]) * inside
    y = xops.prelu(_expand(_conv3(p, conv3), exp) + xr[:, 1:T + 1, 1:T + 1],
                   exp[2])
    return y[:, :max(0, min(T, hq - r0)), :max(0, min(T, wq - c0))]


@pytest.mark.parametrize("index", range(4), ids=NAMES[1:])
def test_blocks_over_tiles_match_the_blocks(model, pack, index):
    """Each stage-1 bottleneck, tile by tile (corner, inner and ragged
    tiles of a 20x35 grid), equals the model's block on the whole
    grid."""
    x = _randn((2, 20, 35, 64), 7 + index)
    rec = _records(pack)[1 + index]
    with torch.no_grad():
        want = front.block_plain(x, model, index)
    for r0 in (0, 16):
        for c0 in (0, 16, 32):
            got = _block_on_tile(rec, x, r0, c0)
            torch.testing.assert_close(
                got, want[:, r0:r0 + T, c0:c0 + T], **TOL)


@pytest.mark.parametrize("shape", [(1, 40, 72, 3), (2, 8, 8, 3),
                                   (1, 32, 64, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_halves_compose_to_the_plain_front(model, shape):
    """b10_plain, then block_plain for each stage-1 bottleneck: the plain
    front, bit for bit."""
    image = _image(shape, 3)
    with torch.no_grad():
        x, mask = front.b10_plain(image, model)
        for index in range(front.STAGE1_BLOCKS):
            x = front.block_plain(x, model, index)
        want_x, want_mask = front.front_stage1_plain(image, model)
    torch.testing.assert_close(x, want_x, rtol=0, atol=0)
    torch.testing.assert_close(mask, want_mask, rtol=0, atol=0)


def test_pack_is_built_on_the_models_device(model, pack):
    """The pack is built where the model's weights lie, Initial's table
    and the GEMM records alike (the meta device stands for the card)."""
    got = front.pack_front(copy.deepcopy(model).to("meta"))
    assert got.device.type == "meta" and got.shape == pack.shape


def test_wrapper_on_other_devices(model):
    """On the CPU the wrapper takes the plain version on both routes and
    counts no launch; a tensor on another device raises."""
    before = front.fused_front_stage1.launches
    image = _image((1, 16, 24, 3), 4)
    want = front.front_stage1_plain(image, model)
    for score in (False, True):
        got = front.fused_front_stage1(image, model, score=score)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert front.fused_front_stage1.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        front.fused_front_stage1(torch.empty(1, 8, 8, 3, device="meta"),
                                 model, score=True)


def _tc_conv(conv, precision, x):
    """``conv`` with both operands of every product in bf16 or TF32 (one
    pass) or as 3xTF32 (hi*hi + hi*lo + lo*hi, hi and lo TF32), fp32
    sums."""
    import chip_smoke
    rnd = chip_smoke.round_bf16 if precision == "bf16" \
        else chip_smoke.round_tf32
    w = conv.weight.data
    xh, wh = rnd(x), rnd(w)
    pairs = [(xh, wh)]
    if precision == "3xTF32":
        pairs += [(xh, rnd(w - wh)), (rnd(x - xh), wh)]
    out = 0
    for a, b in pairs:
        conv.weight.data = b
        out = out + blocks.Conv.forward(conv, a)
    conv.weight.data = w
    return out


def _route_x1(model, image, precision):
    """The plain front as the kernels compute it at ``precision``:
    Initial in fp32, B1_0..B1_4's products at ``precision``."""
    m = copy.deepcopy(model)
    for blk in [m.Bottleneck1_0] + m.blocks(m.stage1):
        for conv in (blk.proj_conv, blk.conv, blk.exp_conv):
            conv.forward = (lambda x, c=conv: _tc_conv(c, precision, x))
    with torch.no_grad():
        return front.front_stage1_plain(image, m)[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_x1_precision_gates_separate_the_routes(seed):
    """The premise of chip_smoke's PRECISION_GATE for the front's x1, on
    the smoke's seeded ENet-19 at 128x256. The gate's control is the plain
    front with B1_0..B1_4's products rounded one precision below the
    route's and Initial's kept fp32 (``rounded`` over front.TC_BLOCKS),
    as the kernels keep it. The front as the score route computes it (one
    TF32 pass) reads under half the control's error in bf16, as the
    predict route computes it (3xTF32) under a tenth of the control's in
    TF32; a front that computes those same products one precision below
    (bf16, TF32) reads above the share, so it fails the gate. And one
    TF32 pass stays under 1e-3 of the maximum."""
    import chip_smoke
    m = ENet(19)
    m.load_state_dict(chip_smoke.seeded_state_dict(m, seed))
    m.eval()
    rng = np.random.default_rng(seed + 3)
    image = torch.from_numpy(rng.integers(0, 256, (2, 128, 256, 3),
                                          dtype=np.uint8)).float() / 255
    with torch.no_grad():
        x1, _ = front.front_stage1_plain(image, m)

    def plain(mm):
        return front.front_stage1_plain(image, mm)[0]

    for route in ("score", "predict"):
        precision = front.PRECISION[route]
        lower, rnd, share = chip_smoke.PRECISION_GATE[precision]
        err_lower = (chip_smoke.rounded(m, rnd, plain, front.TC_BLOCKS)
                     - x1).abs().max()
        err = (_route_x1(m, image, precision) - x1).abs().max()
        err_below = (_route_x1(m, image, lower) - x1).abs().max()
        assert 0 < err < share * err_lower < err_below, \
            (route, lower, err, err_lower, err_below)
        if route == "score":
            assert err < 1e-3 * x1.abs().max()


def _window_gap(x):
    n, h, w, c = x.shape
    win = x.reshape(n, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 5, 2, 4)
    top2 = np.sort(win.reshape(n, h // 2, w // 2, c, 4), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.fixture(scope="module")
def jax_front():
    """The JAX ENet's stage-1 forward (``return_stage1``, the plain
    reference that tests/test_pallas_kernels.py holds the Pallas front
    to; test_torch_kernels.py holds the port to the Pallas front itself
    in interpret mode) on a seeded image, with the port's model on the
    same converted weights and Initial's output for the gaps."""
    jm = JaxENet(num_classes=5)
    x = np.random.default_rng(22).uniform(size=(1, 32, 64, 3)) \
        .astype(np.float32)
    variables = noised_variables(jm, x, 21)
    x1, switches = jm.apply(variables, jnp.asarray(x), training=False,
                            return_stage1=True)
    tm = port_model(variables, 5)
    with torch.no_grad():
        h0 = tm.Initial(torch.from_numpy(x)).numpy()
    return tm, x, np.asarray(x1), np.asarray(switches), h0


@pytest.mark.parametrize("score", [False, True], ids=["predict", "score"])
def test_cpu_path_matches_pallas_front(jax_front, score):
    tm, x, want_x1, want_switches, h0 = jax_front
    x1, mask1 = front.fused_front_stage1(torch.from_numpy(x), tm,
                                         score=score)
    assert x1.shape == mask1.shape == (1, 8, 16, 64)
    np.testing.assert_allclose(x1.numpy(), want_x1, rtol=1e-4, atol=1e-4)
    decided = _window_gap(h0) > 1e-4
    assert decided.mean() > 0.9
    sw = mask1.numpy().reshape(1, 8, 16, 4, 16).argmax(3)
    want_sw = want_switches.reshape(1, 8, 16, 16)
    np.testing.assert_array_equal(sw[decided], want_sw[decided])
