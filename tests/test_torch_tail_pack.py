"""The ENet tail kernels' pack and decomposition (ops/kernels/tail.py,
csrc/tail.cu), on the CPU.

The CUDA kernels read every layer as a GEMM record: the weights padded
to whole k-steps and n-tiles and to a bank-conflict-free stride, the
transposed convs (B4_0, B5_0, the Final) as their nine taps grouped by
output phase, B5_1's 3x3 conv as one K = 9 x 4 product. These tests
unpack the records and hold them to the model's folded weights
(exactly), rebuild each decomposed layer in torch the way the kernels
compute it (per-phase products with exact taps, the K = 40 product) and
hold it to the model's own layer, and hold the two-kernel split (stage 4
to ``x4``, then stage 5 + Final) on the CPU to the JAX ENet's plain tail,
the reference of the Pallas tail kernel (test_torch_score.py and
test_torch_kernels.py hold the port to the Pallas tail itself in
interpret mode).

Tolerance: packed weights exact; a rebuilt layer against the model's
atol = rtol = 1e-5 (the same products summed in another order);
scores against the JAX tail atol 1e-5 (as test_torch_score.py holds them
to the Pallas kernel); logits atol = rtol = 1e-4; labels exact where the
top-2 logit margin exceeds 1e-4."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from semanticsegmentationactivelearning_tpu.models import ENet as JaxENet
from semanticsegmentationactivelearning_tpu.ops import acquisition as jacq
from semanticsegmentationactivelearning_tpu_torch.models import ENet
from semanticsegmentationactivelearning_tpu_torch.ops import nn as xops
from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
    front, packing, tail)

from _torch_parity import assert_labels_match, noised_variables, port_model

TOL = dict(rtol=1e-5, atol=1e-5)
# record indices (csrc/tail.cu's enum)
P40, R40, D40, E40, P41, C41, E41, P42, C42, E42 = range(10)
P50, R50, D50, E50, P51, C51, E51, FIN = range(10, 18)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process while the suite's workers share the
    cores: with a thread per core in each worker this file's torch work
    ran tens of times slower than alone. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(c, seed=0):
    """An ENet with numpy-seeded weights and noised BN statistics."""
    m = ENet(c)
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


def _records(model):
    """(weight [taps, k, s], vectors) of each record of the pack."""
    pack = tail.pack_tail(model)
    out = []
    for off, taps, k, n, s, nv in tail.tail_layout(model.num_classes):
        end = off + taps * k * s
        out.append((pack[off:end].reshape(taps, k, s),
                    [pack[end + i * n:end + (i + 1) * n] for i in range(nv)]))
    return out


def _unphase(taps9):
    """Nine phase-grouped taps ``[9, in, out]`` -> the JAX kernel
    ``[3, 3, in, out]``."""
    k = torch.zeros(3, 3, *taps9.shape[1:])
    order = [kk for taps in tail.PHASE_TAPS for kk in taps]
    for t, (kh, kw) in enumerate(order):
        k[kh, kw] = taps9[t]
    return k


def _by_phases(x, taps9):
    """The 3x3/s2 transposed conv of ``x [N, h, w, in]`` as the kernels
    compute it: per output phase (a, b), the sum over its exact taps
    (tr, tc) of x[i - tr, j - tc] @ tap, x[-1] = 0."""
    n, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 0, 1, 0))
    out = torch.zeros(n, 2 * h, 2 * w, taps9.shape[2])
    t = 0
    for ph, taps in enumerate(tail.PHASE_TAPS):
        a, b = ph >> 1, ph & 1
        nc = 1 if b else 2
        acc = 0
        for i in range(len(taps)):
            tr, tc = i // nc, i % nc
            acc = acc + xp[:, 1 - tr:1 - tr + h, 1 - tc:1 - tc + w] @ taps9[t]
            t += 1
        out[:, a::2, b::2] = acc
    return out


@pytest.mark.parametrize("c", [3, 19, 127])
def test_layout_strides_and_sizes(c):
    layout = tail.tail_layout(c)
    assert len(layout) == 18
    for off, taps, k, n, s, nv in layout:
        assert s % 32 in (8, 24) and s >= n and n % 8 == 0 and k % 8 == 0
        assert off % 4 == 0  # 16-byte cp.async pieces
    fin = layout[FIN]
    assert fin[3] >= c and fin[3] - c < 8 * 4
    off, taps, k, n, s, nv = layout[-1]
    assert tail.pack_tail(_model(c)).numel() == off + taps * k * s + nv * n


@pytest.mark.parametrize("c", [3, 19, 127])
def test_pack_rebuilds_the_folded_weights(c):
    """Every record holds its layer's folded weights and vectors
    exactly, zeros in the padding; the phase-grouped taps of the three
    transposed convs rebuild their JAX kernels."""
    m = _model(c)
    rec = _records(m)

    def check(i, want_w, want_vecs=()):
        w, vecs = rec[i]
        t, k0, n0 = want_w.shape
        torch.testing.assert_close(w[:, :k0, :n0], want_w, rtol=0, atol=0)
        assert (w[:, k0:] == 0).all() and (w[:, :, n0:] == 0).all()
        assert len(vecs) == len(want_vecs)
        for v, want in zip(vecs, want_vecs):
            torch.testing.assert_close(v[:want.numel()], want.detach(),
                                       rtol=0, atol=0)
            assert (v[want.numel():] == 0).all()

    def flat(w):
        return w.reshape(-1, *w.shape[2:])

    for blk, (p, r, d, e) in ((m.Bottleneck4_0, (P40, R40, D40, E40)),
                              (m.Bottleneck5_0, (P50, R50, D50, E50))):
        w, *v = packing.affine(packing.hwio(blk.proj_conv), blk.proj_bn,
                               blk.proj_prelu)
        check(p, flat(w), v)
        check(r, flat(packing.hwio(blk.res_conv)))
        w, *v = packing.affine(packing.deconv_hwio(blk.deconv), blk.conv_bn,
                               blk.conv_prelu)
        torch.testing.assert_close(_unphase(rec[d][0][:, :w.shape[2],
                                                      :w.shape[3]]), w,
                                   rtol=0, atol=0)
        check(d, tail.phase_taps(w), v)
        w, t = packing.affine(packing.hwio(blk.exp_conv), blk.exp_bn)
        check(e, flat(w), (t, blk.res_prelu.alpha))
    for blk, (p, cv, e) in ((m.Bottleneck4_1, (P41, C41, E41)),
                            (m.Bottleneck4_2, (P42, C42, E42)),
                            (m.Bottleneck5_1, (P51, C51, E51))):
        w, *v = packing.affine(packing.hwio(blk.proj_conv), blk.proj_bn,
                               blk.proj_prelu)
        check(p, flat(w), v)
        w, *v = packing.affine(packing.hwio(blk.conv), blk.conv_bn,
                               blk.conv_prelu)
        check(cv, flat(w) if cv != C51 else w.reshape(1, 36, 4), v)
        w, t = packing.affine(packing.hwio(blk.exp_conv), blk.exp_bn)
        check(e, flat(w), (t, blk.res_prelu.alpha))
    fin = packing.deconv_hwio(m.Final.deconv)
    check(FIN, tail.phase_taps(fin))
    torch.testing.assert_close(_unphase(rec[FIN][0][:, :16, :c]), fin,
                               rtol=0, atol=0)


@pytest.mark.parametrize("c", [3, 19])
def test_final_by_phases_matches_conv_transpose(c):
    """The Final as the kernels compute it, one product per output phase
    of [pixels x 16*taps] by [16*taps x padded classes] over its exact
    taps, equals the model's conv_transpose2d; the padded classes are
    zero columns."""
    m = _model(c, seed=1)
    w = _records(m)[FIN][0]
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 5, 7, 16)).astype(np.float32))
    got = _by_phases(x, w[:, :16])
    assert (got[..., c:] == 0).all()
    with torch.no_grad():
        torch.testing.assert_close(got[..., :c], m.Final(x), **TOL)


@pytest.mark.parametrize("block", ["Bottleneck4_0", "Bottleneck5_0"])
def test_deconv_by_phases_matches_the_block(block):
    """B4_0's and B5_0's transposed conv + BN + PReLU from their phase
    records equal the block's own layers."""
    m = _model(19, seed=3)
    blk = getattr(m, block)
    w, (b, alpha) = _records(m)[D40 if block == "Bottleneck4_0" else D50]
    cin, cout = blk.deconv.weight.shape[:2]
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, 4, 6, cin)).astype(np.float32))
    got = xops.prelu(_by_phases(x, w[:, :cin, :cout]) + b, alpha)
    with torch.no_grad():
        want = blk.conv_prelu(blk.conv_bn(blk.deconv(x)))
    torch.testing.assert_close(got, want, **TOL)


def test_b51_conv_as_one_k40_product():
    """B5_1's 3x3 conv 4 -> 4 as the kernel computes it: one product of
    the nine shifted positions' channels (k = tap * 4 + channel, padded
    to 40) by the K = 40 record, + BN + PReLU."""
    m = _model(19, seed=5)
    blk = m.Bottleneck5_1
    w, (b, alpha) = _records(m)[C51]
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 5, 6, 4)).astype(np.float32))
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, kh:kh + 5, kw:kw + 6] for kh in range(3)
                      for kw in range(3)], dim=-1)
    cols = F.pad(cols, (0, 4))  # k rows 36..39 are zero
    got = xops.prelu((cols @ w[0])[..., :4] + b[:4], alpha[:4])
    with torch.no_grad():
        want = blk.conv_prelu(blk.conv_bn(blk.conv(x)))
    torch.testing.assert_close(got, want, **TOL)


def test_stage4_then_decode_equals_forward_tail():
    """The split's plain halves compose to the whole tail exactly."""
    m = _model(19, seed=7)
    rng = np.random.default_rng(8)
    y = torch.from_numpy(rng.normal(size=(2, 3, 5, 128)).astype(np.float32))
    sw2 = torch.from_numpy(rng.integers(0, 4, (2, 3, 5, 64)).astype(np.int8))
    mask1 = front.switches_to_mask(torch.from_numpy(
        rng.integers(0, 4, (2, 6, 10 * 16)).astype(np.int8)))
    with torch.no_grad():
        x4 = tail.fused_tail_stage4(y, sw2, m)
        assert x4.shape == (2, 6, 10, 64)
        logits = m.forward_tail(y, sw2.reshape(2, 3, 5 * 64),
                                tail.mask_to_switches(mask1))
        want = m.Final(m.decode_from_stage4(x4, tail.mask_to_switches(mask1)))
        assert torch.equal(logits, want)
        assert torch.equal(tail.fused_tail_decode(x4, mask1, m, False),
                           logits.argmax(-1).to(torch.int8))
        assert torch.equal(tail.fused_tail_decode(x4, mask1, m, True),
                           tail.tail_score_plain(y, sw2, mask1, m))


@pytest.fixture(scope="module")
def jax_setup():
    c = 5
    jm = JaxENet(num_classes=c)
    v = noised_variables(jm, np.zeros((1, 16, 32, 3), np.float32), 4)
    params = dict(v["params"])
    params["Final"] = {"deconv": {
        "kernel": params["Final"]["deconv"]["kernel"] * 25.0}}
    variables = {"params": params, "batch_stats": v["batch_stats"]}
    rng = np.random.default_rng(9)
    y = rng.normal(size=(1, 6, 8, 128)).astype(np.float32)
    sw2 = rng.integers(0, 4, (1, 6, 8, 64)).astype(np.int8)
    mask1 = front.switches_to_mask(torch.from_numpy(
        rng.integers(0, 4, (1, 12, 16 * 16)).astype(np.int8))).numpy()
    return c, jm, variables, port_model(variables, c), y, sw2, mask1


def _jax_tail(m, y, sw2, switches1):
    """Stages 4 and 5 and Final of the JAX ENet: the plain reference that
    tests/test_pallas_kernels.py holds the Pallas tail to."""
    h = m.Bottleneck4_0(y, sw2, False)
    for block in m.stage4:
        h = block(h, False)
    h = m.Bottleneck5_0(h, switches1, False)
    return m.Final_(m.Bottleneck5_1(h, False))


@pytest.mark.parametrize("score", [True, False], ids=["score", "predict"])
def test_split_matches_pallas_tail(jax_setup, score):
    """Stage 4 then stage 5 + Final, the route of the two CUDA kernels,
    against the JAX ENet's plain tail (test_torch_score.py and
    test_torch_kernels.py hold the port to the Pallas tail kernel itself
    in interpret mode, on these shapes)."""
    c, jm, variables, tm, y, sw2, mask1 = jax_setup
    switches1 = tail.mask_to_switches(torch.from_numpy(mask1))
    logits = np.asarray(jm.apply(
        variables, jnp.asarray(y), jnp.asarray(sw2).reshape(1, 6, 512),
        jnp.asarray(switches1.numpy()), method=_jax_tail))
    with torch.no_grad():
        x4 = tail.fused_tail_stage4(torch.from_numpy(y),
                                    torch.from_numpy(sw2), tm)
        got = tail.fused_tail_decode(x4, torch.from_numpy(mask1), tm, score)
    if score:
        want = jacq.mean_confidence(jnp.asarray(logits), "entropy", c)
        assert got.dtype == torch.float32 and got.shape == (1,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    else:
        assert got.dtype == torch.int8 and got.shape == (1, 48, 64)
        with torch.no_grad():
            port_logits = tm.forward_tail(
                torch.from_numpy(y), torch.from_numpy(sw2).reshape(1, 6, 512),
                switches1)
        np.testing.assert_allclose(port_logits.numpy(), logits, rtol=1e-4,
                                   atol=1e-4)
        assert_labels_match(got.numpy(), logits)


def test_split_wrappers_on_other_devices():
    """On the CPU the split's wrappers take their plain versions and
    count no launch; a tensor on another device raises."""
    m = _model(19, seed=10)
    before = (tail.fused_tail_stage4.launches, tail.fused_tail_decode.launches)
    with torch.no_grad():
        x4 = tail.fused_tail_stage4(torch.zeros(1, 2, 2, 128),
                                    torch.zeros(1, 2, 2, 64, dtype=torch.int8),
                                    m)
        tail.fused_tail_decode(x4, torch.zeros(1, 4, 4, 64), m, True)
    assert (tail.fused_tail_stage4.launches,
            tail.fused_tail_decode.launches) == before
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tail.fused_tail_stage4(torch.empty(1, 2, 2, 128, **meta),
                               torch.empty(1, 2, 2, 64, dtype=torch.int8,
                                           **meta), m)
    with pytest.raises(ValueError, match="CUDA"):
        tail.fused_tail_decode(torch.empty(1, 4, 4, 64, **meta),
                               torch.empty(1, 4, 4, 64, **meta), m, False)


def test_round_tf32_to_nearest_ties_away():
    """chip_smoke.round_tf32 keeps 10 mantissa bits and rounds as
    ``cvt.rna.tf32.f32``: to nearest, ties away from zero."""
    import chip_smoke
    e = 2.0 ** -10
    x = torch.tensor([1.0, 1 + e, 1 + e / 2, -(1 + e / 2), 1 + e / 4,
                      1 + e / 2 + 2.0 ** -20, 3.0 * 2.0 ** -30, 0.0])
    want = torch.tensor([1.0, 1 + e, 1 + e, -(1 + e), 1.0, 1 + e,
                         3.0 * 2.0 ** -30, 0.0])
    assert torch.equal(chip_smoke.round_tf32(x), want)
    assert torch.equal(chip_smoke.round_bf16(x),
                       x.to(torch.bfloat16).to(torch.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_x4_precision_gate_separates_tf32_from_bf16(seed):
    """The premise of chip_smoke's PRECISION_GATE for the score route:
    on the smoke's seeded ENet-19 (at 128x256), the plain stage 4 with
    every product in TF32 reads under half the error of the same in
    bf16, so a kernel computing in bf16 fails the gate that one TF32
    pass keeps."""
    import chip_smoke
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import mid
    m = ENet(19)
    m.load_state_dict(chip_smoke.seeded_state_dict(m, seed))
    m.eval()
    rng = np.random.default_rng(seed + 3)
    image = torch.from_numpy(rng.integers(0, 256, (2, 128, 256, 3),
                                          dtype=np.uint8)).float() / 255
    with torch.no_grad():
        x1, _ = front.front_stage1_plain(image, m)
        y, sw2 = mid.mid_stage23_plain(x1, m)
        f4 = m.forward_stage4(y, sw2.reshape(2, 16, 32 * 64))
    lower, rnd, share = chip_smoke.PRECISION_GATE["TF32"]
    assert lower == "bf16" and share == 0.5
    def stage4(mm):
        return mm.forward_stage4(y, sw2.reshape(2, 16, 32 * 64))

    err = {name: (chip_smoke.rounded(m, r, stage4) - f4).abs().max()
           for name, r in (("TF32", chip_smoke.round_tf32),
                           ("bf16", rnd))}
    assert 0 < err["TF32"] < share * err["bf16"]
    assert err["TF32"] < 1e-3 * f4.abs().max()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decoder_precision_gate_on_tile_sums(seed):
    """The premise of chip_smoke's PRECISION_GATE for the decoder route
    (the tail's stage-5 kernel on the plain stage 4's output): on the
    smoke's seeded ENet-19 (at 128x256, 64 tiles), the per-tile sums of
    confidences less each image's mean error (centred_max) with B5_0's,
    B5_1's and the Final's products in TF32 read under half the error of
    the same in bf16. On the scores themselves TF32's error comes out
    above bf16's at seeds 1 and 2: a mean over many pixels is mostly
    one shift from rounding the weights, which a rounding can cancel by
    chance. The partials' mean is the plain score."""
    import chip_smoke
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        decoder, mid)
    m = ENet(19)
    m.load_state_dict(chip_smoke.seeded_state_dict(m, seed))
    m.eval()
    rng = np.random.default_rng(seed + 3)
    image = torch.from_numpy(rng.integers(0, 256, (2, 128, 256, 3),
                                          dtype=np.uint8)).float() / 255
    with torch.no_grad():
        x1, m1 = front.front_stage1_plain(image, m)
        y, sw2 = mid.mid_stage23_plain(x1, m)
        f4 = m.forward_stage4(y, sw2.reshape(2, 16, 32 * 64))
        want = tail.decode_partials_plain(f4, m1, m)
        score = decoder.decoder_score_plain(f4, m1, m)
    assert want.shape == (2, 4 * 8)
    torch.testing.assert_close(tail.partials_mean(want, 128 * 256), score,
                               rtol=0, atol=1e-5)
    lower, rnd, share = chip_smoke.PRECISION_GATE["TF32"]
    assert lower == "bf16" and share == 0.5
    err = {name: chip_smoke.centred_max(chip_smoke.rounded(
        m, r, lambda mm: tail.decode_partials_plain(f4, m1, mm),
        ("Bottleneck5_0", "Bottleneck5_1", "Final")) - want)
        for name, r in (("TF32", chip_smoke.round_tf32), ("bf16", rnd))}
    assert 0 < err["TF32"] < share * err["bf16"], err
