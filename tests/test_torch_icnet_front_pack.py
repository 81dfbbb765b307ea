"""ICNet's front kernels: their pack and their arithmetic
(ops/kernels/icnet_front.py, csrc/icnet_front.cu), on the CPU.

The CUDA kernels read each of Branch1_1..1_3 and SharedStem conv1_1..1_3
as a BN-folded GEMM record at a bank-safe stride: a 3-channel conv as one
tap of K = 27 (dy, dx, c) padded to 32, a 32-channel one as nine taps of
32. Branch1 runs a 4x8 eighth-res tile a block (the image window under
it, Branch1_1 over a 19x35 half-res rectangle, Branch1_2 over 9x17
quarter positions, Branch1_3); the stem an 8x8 tile (the half-res window,
conv1_1, conv1_2 and conv1_3 over rectangles that shrink by one position
a layer, the 3x3/s2 pool), each layer zero outside its grid. These tests
unpack the records and hold them to the model's folded weights
(exactly), hold each conv as the kernels' GEMM to the model's conv + BN,
rebuild both kernels tile by tile in torch and hold them to the plain
Branch1 and stem at ragged shapes, pin the premise of the precision gate
on f1 and stem1 (chip_smoke.py PRECISION_GATE), and hold the CPU path on
both routes to the JAX ICNet's plain front, the Pallas front kernels'
reference (tests/test_torch_icnet_kernels.py holds the port to the
Pallas kernels themselves in interpret mode).

Tolerances: records exact; a rebuilt conv or tile against the model's
atol = rtol = 1e-5 (the same products summed in another order), the
rebuilt half-res image 1e-6; the CPU path against the JAX front
rtol 1e-4 / atol 1e-5 (x_half 1e-5 / 1e-6), as
tests/test_torch_icnet_kernels.py holds it to the Pallas kernels."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as flax_nn
import jax.numpy as jnp

from semanticsegmentationactivelearning_tpu.models import ICNet as JaxICNet
from semanticsegmentationactivelearning_tpu.models.icnet import (
    _resize_bilinear)
from semanticsegmentationactivelearning_tpu_torch.models import ICNet
from semanticsegmentationactivelearning_tpu_torch.ops import nn as xops
from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
    icnet_front, packing)

from chip_smoke import (PRECISION_GATE, round_bf16, round_tf32, rounded,
                        seeded_state_dict)

TOL = dict(rtol=1e-5, atol=1e-5)
WS = {32: 40, 64: 72}  # the records' strides (bstride)
# (input channels, output channels) of Branch1_1..1_3, conv1_1..1_3
CONVS = ((3, 32), (32, 32), (32, 64), (3, 32), (32, 32), (32, 64))
NAMES = ("Branch1_1", "Branch1_2", "Branch1_3", "SharedStem.conv1_1",
         "SharedStem.conv1_2", "SharedStem.conv1_3")
# the kernels' tiles: Branch1 and conv1_3 + pool in eighth-res positions,
# conv1_1 + conv1_2 in quarter-res ones
B1_TILE, STEM12_TILE, STEM3_TILE = (4, 8), (16, 32), (8, 8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process while the suite's workers share the
    cores: with a thread per core in each worker this file's torch work
    ran tens of times slower than alone. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(seed=1):
    m = ICNet(19)
    m.load_state_dict(seeded_state_dict(m, seed, 5.0, "ICNet"))
    return m.eval()


@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.fixture(scope="module")
def pack(model):
    return icnet_front.pack_icnet_front(model)


def _image(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        size=shape).astype(np.float32))


def _record_size(ci, co):
    return (1 if ci == 3 else 9) * 32 * WS[co] + co


def _records(pack):
    """Each record as ``(w [taps, 32, co], bias [co])`` as the kernels
    read it, and the padding beside it."""
    out, pad, o = [], [], 0
    for ci, co in CONVS:
        taps = 1 if ci == 3 else 9
        w = pack[o:o + taps * 32 * WS[co]].reshape(taps, 32, WS[co])
        o += taps * 32 * WS[co]
        out.append((w[..., :co], pack[o:o + co]))
        pad.append(w[..., co:])
        o += co
    assert o == pack.numel()
    return out, pad


def _folded(model, name):
    cbn = model.get_submodule(name)
    return packing.affine(packing.hwio(cbn.conv), cbn.bn)


# -- the pack ------------------------------------------------------------------

def test_pack_size_and_strides(pack):
    """The pack's size is the C entry's arithmetic (csrc/icnet_front.cu
    PACK_F: two branches of a K = 27 record and two K = 288 ones); the
    strides are bank-safe, every record starts 16-byte aligned."""
    assert pack.numel() == sum(_record_size(ci, co) for ci, co in CONVS)
    assert pack.numel() == 2 * (32 * 40 + 32 + 9 * 32 * 40 + 32
                                + 9 * 32 * 72 + 64) == 67328
    for co, s in WS.items():
        assert packing.bstride(co) == s and s % 32 in (8, 24)
    assert all(_record_size(ci, co) % 4 == 0 for ci, co in CONVS)


@pytest.mark.parametrize("index", range(6), ids=NAMES)
def test_records_hold_the_folded_weights(model, pack, index):
    """Each record is its conv's HWIO weights times the BN scale, in the
    kernels' k order (a K = 27 conv: 9 dy + 3 dx + c, rows 27..31 zero;
    a K = 288 one: tap 3 dy + dx, then the input channel), and the BN
    shift; zero padding."""
    (w, b), pad = (r[index] for r in _records(pack))
    kf, t = _folded(model, NAMES[index])
    ci = CONVS[index][0]
    if ci == 3:
        assert torch.equal(w[0, :27], kf.reshape(27, -1))
        assert not w[0, 27:].any()
    else:
        assert torch.equal(w, kf.reshape(9, 32, -1))
    assert torch.equal(b, t) and not pad.any()


# -- each conv as the kernels' GEMM ----------------------------------------------

def _product(a, w, passes):
    """a @ w as the tensor cores take it: exact (0), one TF32 pass (1),
    3xTF32 (3: hi*hi + hi*lo + lo*hi), bf16 operands (-1)."""
    if passes == 0:
        return a @ w
    if passes == -1:
        return round_bf16(a) @ round_bf16(w)
    ah, wh = round_tf32(a), round_tf32(w)
    if passes == 1:
        return ah @ wh
    return ah @ wh + ah @ round_tf32(w - wh) + round_tf32(a - ah) @ wh


def conv27(S, rec, oy, ox, oh, ow, passes):
    """The K = 27 GEMM: output (ly, lx) reads the 3-channel pixels
    S[:, 2 ly + oy + dy, 2 lx + ox + dx] at k = 9 dy + 3 dx + c, the
    record's 27 rows (its rows 27..31 multiply zeros' place)."""
    w, b = rec
    cols = [S[:, oy + dy:oy + dy + 2 * oh - 1:2, ox + dx:ox + dx + 2 * ow - 1:2]
            for dy in range(3) for dx in range(3)]
    a = torch.cat(cols, dim=-1)  # [n, oh, ow, 27]
    return _product(a, w[0, :27], passes) + b


def conv288(X, rec, s, oh, ow, passes):
    """The K = 288 implicit GEMM: output (ly, lx)'s tap t reads X[:, s ly
    + t / 3, s lx + t % 3], tap by tap into one fp32 sum."""
    w, b = rec
    acc = 0
    for t in range(9):
        dy, dx = divmod(t, 3)
        a = X[:, dy:dy + s * (oh - 1) + 1:s, dx:dx + s * (ow - 1) + 1:s]
        acc = acc + _product(a, w[t], passes)
    return acc + b


@pytest.mark.parametrize("index", range(6), ids=NAMES)
def test_each_conv_as_its_gemm(model, pack, index):
    """Every conv as the kernels run it (over an input zero-padded by the
    SAME rule: (0, 1) at stride 2, (1, 1) at stride 1) equals the model's
    conv + BN, on a 14 x 18 input."""
    recs, _ = _records(pack)
    cbn = model.get_submodule(NAMES[index])
    ci, co = CONVS[index]
    stride = cbn.conv.stride
    x = _image((2, 14, 18, ci), index)
    with torch.no_grad():
        want = cbn.bn(cbn.conv(x))
        oh, ow = want.shape[1:3]
        lo = 0 if stride == 2 else 1
        xp = F.pad(x, (0, 0, lo, 2, lo, 2))
        got = (conv27(xp, recs[index], 0, 0, oh, ow, 0) if ci == 3
               else conv288(xp, recs[index], stride, oh, ow, 0))
    torch.testing.assert_close(got, want, **TOL)


# -- the kernels, tile by tile ----------------------------------------------------

PAD = 80  # the zero border of the image, the half-res image and c12 (> any
# window's overhang past the grid)


def _window(x, y0, x0, rows, cols):
    """Rows y0 .. y0+rows-1, columns x0 .. of ``x`` (zero-padded by PAD),
    zero outside it."""
    return x[:, PAD + y0:PAD + y0 + rows, PAD + x0:PAD + x0 + cols]


def _masked(v, r0, c0, gh, gw):
    """ReLU, zero outside the gh x gw grid (rectangle from (r0, c0))."""
    r = torch.arange(r0, r0 + v.shape[1])[:, None]
    c = torch.arange(c0, c0 + v.shape[2])[None, :]
    inside = (r >= 0) & (r < gh) & (c >= 0) & (c < gw)
    return torch.relu(v) * inside[..., None]


def _tent_matrix(n2):
    """[n2, 2 n2]: half index i draws on indices 2i-1 .. 2i+2 with (1, 3,
    3, 1)/8, (3, 3, 1)/7 at the first and last i (the kernels' tent())."""
    m = torch.zeros(n2, 2 * n2)
    for i in range(n2):
        t = [0.125, 0.375, 0.375, 0.125]
        if i == 0:
            t = [0, 3 / 7, 3 / 7, 1 / 7]
        elif i == n2 - 1:
            t = [1 / 7, 3 / 7, 3 / 7, 0]
        for a in range(4):
            if 0 <= 2 * i - 1 + a < 2 * n2:
                m[i, 2 * i - 1 + a] = t[a]
    return m


def kernel_tiles(image, pack, passes):
    """The front + stem's launches rebuilt tile by tile: branch1_kernel
    (4x8 eighth-res tiles: f1, and the x_half that branch1_kernel<true>
    writes), stem12_kernel (16x32 quarter-res tiles: conv1_1, conv1_2 ->
    c12) and stem3_kernel (8x8 tiles from c12: conv1_3, the pool ->
    stem1). Returns (f1, stem1, x_half)."""
    n, h, w, _ = image.shape
    h2, w2, h4, w4, h8, w8 = h // 2, w // 2, h // 4, w // 4, h // 8, w // 8
    recs, _ = _records(pack)
    half = torch.einsum("ir,nrcz,jc->nijz", _tent_matrix(h2), image,
                        _tent_matrix(w2))
    img = F.pad(image, (0, 0, PAD, PAD, PAD, PAD))
    xh = F.pad(half, (0, 0, PAD, PAD, PAD, PAD))
    f1 = torch.full((n, h8, w8, 64), float("nan"))
    tr, tc = B1_TILE
    for r0 in range(0, h8, tr):
        for c0 in range(0, w8, tc):
            S = _window(img, 8 * r0 - 1, 8 * c0 - 1, 8 * tr + 8, 8 * tc + 8)
            b1 = _masked(conv27(S, recs[0], 1, 1, 4 * tr + 3, 4 * tc + 3,
                                passes), 4 * r0, 4 * c0, h2, w2)
            b2 = _masked(conv288(b1, recs[1], 2, 2 * tr + 1, 2 * tc + 1,
                                 passes), 2 * r0, 2 * c0, h4, w4)
            b3 = torch.relu(conv288(b2, recs[2], 2, tr, tc, passes))
            re, ce = min(r0 + tr, h8), min(c0 + tc, w8)
            f1[:, r0:re, c0:ce] = b3[:, :re - r0, :ce - c0]
    c12 = torch.full((n, h4, w4, 32), float("nan"))
    qr, qc = STEM12_TILE
    for y0 in range(0, h4, qr):
        for x0 in range(0, w4, qc):
            x = _window(xh, 2 * y0 - 2, 2 * x0 - 2, 2 * qr + 5, 2 * qc + 5)
            c11 = _masked(conv27(x, recs[3], 0, 0, qr + 2, qc + 2, passes),
                          y0 - 1, x0 - 1, h4, w4)
            out = torch.relu(conv288(c11, recs[4], 1, qr, qc, passes))
            ye, xe = min(y0 + qr, h4), min(x0 + qc, w4)
            c12[:, y0:ye, x0:xe] = out[:, :ye - y0, :xe - x0]
    stem1 = torch.full((n, h8, w8, 64), float("nan"))
    c12p = F.pad(c12, (0, 0, PAD, PAD, PAD, PAD))
    tr, tc = STEM3_TILE
    for r0 in range(0, h8, tr):
        for c0 in range(0, w8, tc):
            x = _window(c12p, 2 * r0 - 1, 2 * c0 - 1, 2 * tr + 3, 2 * tc + 3)
            c13 = _masked(conv288(x, recs[5], 1, 2 * tr + 1, 2 * tc + 1,
                                  passes), 2 * r0, 2 * c0, h4, w4)
            pooled = F.max_pool2d(c13.permute(0, 3, 1, 2), 3, 2) \
                .permute(0, 2, 3, 1)
            re, ce = min(r0 + tr, h8), min(c0 + tc, w8)
            stem1[:, r0:re, c0:ce] = pooled[:, :re - r0, :ce - c0]
    return f1, stem1, half


@pytest.mark.parametrize("shape", [(1, 96, 160, 3), (2, 32, 224, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_tiles_match_plain_branch1_and_stem(model, pack, shape):
    """Ragged tiles (eighth-res 12 x 20 and 4 x 28 against 4x8 and 8x8
    tiles, quarter-res 24 x 40 and 8 x 56 against 16x32), the pool's padded
    high edge: the tile rebuild's f1, stem1 and x_half equal the plain
    versions'."""
    image = _image(shape, 5)
    with torch.no_grad():
        f1, stem1, x_half = kernel_tiles(image, pack, 0)
        want_f1, want_xh = icnet_front.icnet_front_plain(image, model)
        want_st = model.SharedStem.front(want_xh)
    assert want_f1.abs().max() > 0.1 and want_st.abs().max() > 0.1
    torch.testing.assert_close(f1, want_f1, **TOL)
    torch.testing.assert_close(stem1, want_st, **TOL)
    torch.testing.assert_close(x_half, want_xh, rtol=1e-6, atol=1e-6)


# -- the precision gate's premise --------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_precision_gate_premise_on_f1_and_stem1(seed):
    """On f1 and stem1 of the smoke's seeded ICNet-19, one TF32 pass stays
    under half of the error of the plain front + stem with all six convs'
    products in bf16 (chip_smoke.py PRECISION_GATE "TF32", the score
    route), 3xTF32 under a tenth of one TF32 pass's ("3xTF32", predict);
    a kernel computing one precision below each route (bf16, TF32) reads
    above the share, so it fails the gate. One TF32 pass stays under 1e-3
    of the maximum."""
    m = _model(seed)
    pk = icnet_front.pack_icnet_front(m)
    image = _image((1, 64, 128, 3), 10 + seed)
    with torch.no_grad():
        want = icnet_front.icnet_front_stem_plain(image, m)
        got = {p: kernel_tiles(image, pk, p)[:2] for p in (1, 3, -1)}

        controls = {
            lower: rounded(m, rnd, lambda mm: icnet_front.icnet_front_stem_plain(
                image, mm), icnet_front.TC_CONVS)
            for lower, rnd, _ in PRECISION_GATE.values()}
    below = {"TF32": -1, "3xTF32": 1}  # one precision below the route
    passes = {"TF32": 1, "3xTF32": 3}
    for i, what in enumerate(("f1", "stem1")):
        for precision in ("TF32", "3xTF32"):
            lower, _, share = PRECISION_GATE[precision]
            err_lower = (controls[lower][i] - want[i]).abs().max()
            err = (got[passes[precision]][i] - want[i]).abs().max()
            err_below = (got[below[precision]][i] - want[i]).abs().max()
            assert 0 < err < share * err_lower < err_below, \
                (what, precision, err, err_lower, err_below)
        assert (got[1][i] - want[i]).abs().max() < 1e-3 * want[i].abs().max()


# -- the wrappers on the CPU ------------------------------------------------------

def test_both_routes_take_the_plain_path_on_the_cpu(model):
    """On the CPU each wrapper takes its plain version on both routes and
    counts no launch; a tensor on another device raises."""
    image = _image((1, 32, 64, 3), 7)
    before = (icnet_front.fused_icnet_front.launches,
              icnet_front.fused_icnet_front_stem.launches)
    for fused, plain in (
            (icnet_front.fused_icnet_front, icnet_front.icnet_front_plain),
            (icnet_front.fused_icnet_front_stem,
             icnet_front.icnet_front_stem_plain)):
        want = plain(image, model)
        for score in (False, True):
            got = fused(image, model, score=score)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        with pytest.raises(ValueError, match="CUDA"):
            fused(torch.empty(1, 32, 32, 3, device="meta"), model, score=True)
    assert (icnet_front.fused_icnet_front.launches,
            icnet_front.fused_icnet_front_stem.launches) == before


def _variables(model):
    """The JAX ICNet's front variables from the port's weights."""
    def conv_bn(cbn):
        return ({"conv": {"kernel": packing.hwio(cbn.conv).numpy()},
                 "bn": {"scale": cbn.bn.weight.detach().numpy(),
                        "bias": cbn.bn.bias.detach().numpy()}},
                {"bn": {"mean": cbn.bn.running_mean.numpy(),
                        "var": cbn.bn.running_var.numpy()}})

    params, stats = {"SharedStem": {}}, {"SharedStem": {}}
    for name in NAMES:
        p, s = conv_bn(model.get_submodule(name))
        if name.startswith("SharedStem."):
            params["SharedStem"][name[11:]] = p
            stats["SharedStem"][name[11:]] = s
        else:
            params[name], stats[name] = p, s
    return {"params": params, "batch_stats": stats}


def _jax_front(mdl, x):
    """Branch1, the half-res image and the stem's front (conv1_1 s2 ->
    conv1_2 -> conv1_3 -> 3x3/s2 max pool) of the JAX ICNet: the plain
    reference that tests/test_icnet.py holds the Pallas front kernels
    to."""
    f1 = mdl.branch1_3(mdl.branch1_2(mdl.branch1_1(x, False), False), False)
    x_half = _resize_bilinear(x, (x.shape[1] // 2, x.shape[2] // 2))
    s = mdl.stem.conv1_3(mdl.stem.conv1_2(mdl.stem.conv1_1(x_half, False),
                                          False), False)
    return f1, x_half, flax_nn.max_pool(s, (3, 3), strides=(2, 2),
                                        padding="SAME")


@pytest.mark.parametrize("score", [False, True], ids=["predict", "score"])
def test_cpu_path_matches_pallas(model, score):
    """64x96: ragged against the port's tiles; both entries on the
    route, against the JAX ICNet's plain front (the Pallas front kernels'
    reference; tests/test_torch_icnet_kernels.py holds the port to the
    Pallas kernels themselves in interpret mode)."""
    x = _image((1, 64, 96, 3), 2 + score)
    f1, x_half, stem1 = JaxICNet(num_classes=19).apply(
        _variables(model), jnp.asarray(x.numpy()), method=_jax_front)
    got_f1, got_xh = icnet_front.fused_icnet_front(x, model, score=score)
    got_f1s, got_st = icnet_front.fused_icnet_front_stem(x, model,
                                                         score=score)
    assert np.asarray(stem1).max() > 0.1
    for got, want in ((got_f1, f1), (got_f1s, f1), (got_st, stem1)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(got_xh.numpy(), np.asarray(x_half), rtol=1e-5,
                               atol=1e-6)
