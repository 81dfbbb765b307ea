"""ICNet's CFF2 + head kernel: its pack and its arithmetic
(ops/kernels/icnet_head.py, csrc/icnet_head.cu), on the CPU.

The CUDA kernel reads CFF2 as one GEMM record, [kc (nine dilated taps x
128 input channels, tap-major) ; kh (64)] [1216, 128] at a bank-safe
stride with the one bias bc + bh, and the classifier as a second record
whose classes are padded to 8s. A block takes a tile of 16 x 8
eighth-res positions: the implicit GEMM over the tile and a
one-position halo (its A rows the 2x upsample of fused16 at each
dilated tap, zero outside the grid, then f1), ReLU, the classifier with
every out-of-grid position reading its clamped neighbour, and the 8x
head as two separable blends (rows by phase, then columns). These tests
unpack the records and hold them to the model's folded weights
(exactly), rebuild the kernel tile by tile in torch and hold it to the
plain CFF2 + head, pin the premise of the precision gate on fused8
(chip_smoke.py PRECISION_GATE), and hold the CPU path at a ragged shape
to the JAX package's Pallas score kernel in interpret mode and, on the
predict route, to the JAX ICNet's plain CFF2 + head (the predict
kernel's reference; tests/test_torch_icnet_kernels.py holds the port to
the Pallas predict kernel).

Tolerances: records exact; the rebuilt kernel against the plain
version: fused8 atol = rtol = 1e-5 (the same products in another
order), scores 1e-5, labels equal where the top-2 logit margin exceeds
1e-3; the CPU path: scores against the Pallas kernel rtol 1e-4 / atol
1e-5, logits against the JAX head atol = rtol = 1e-4 and labels on
decided pixels (as tests/test_torch_icnet_kernels.py holds them)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticsegmentationactivelearning_tpu.models import ICNet as JaxICNet
from semanticsegmentationactivelearning_tpu.models.icnet import (
    _resize_bilinear)
from semanticsegmentationactivelearning_tpu.ops import pallas_kernels
from semanticsegmentationactivelearning_tpu_torch.models import ICNet
from semanticsegmentationactivelearning_tpu_torch.ops import nn as xops
from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
    icnet_head, packing)

from chip_smoke import round_bf16, round_tf32, rounded, seeded_state_dict
from _torch_parity import assert_labels_match

C = 19
KMAIN, WS = 9 * 128 + 64, 136
TR = 16  # the kernel's tile: TR x 8 eighth-res positions
TOL = dict(rtol=1e-5, atol=1e-5)
# _HEAD8_W (pallas_kernels.py:106): phase t's weights on rows i-1, i, i+1
HEAD8_W = torch.tensor([[14, 18, 0], [10, 22, 0], [7, 24, 1], [5, 24, 3],
                        [3, 24, 5], [1, 24, 7], [0, 22, 10], [0, 18, 14]],
                       dtype=torch.float32) / 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process while the suite's workers share the
    cores: with a thread per core in each worker this file's torch work
    ran tens of times slower than alone. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(seed=1, scale=5.0, classes=C):
    m = ICNet(classes)
    m.load_state_dict(seeded_state_dict(m, seed, scale, "ICNet"))
    return m.eval()


@pytest.fixture(scope="module")
def model():
    return _model()


def _inputs(n, h8, w8, seed):
    rng = np.random.default_rng(seed)
    f16 = (0.5 * rng.normal(size=(n, h8 // 2, w8 // 2, 128)))
    f1 = 0.5 * np.maximum(rng.normal(size=(n, h8, w8, 64)), 0)
    return (torch.from_numpy(f16.astype(np.float32)),
            torch.from_numpy(f1.astype(np.float32)))


def _records(pack, c):
    """(w [1216, 128], bias, wcls [128, c], bcls) as the kernel reads
    them, and the padding the records hold beside them."""
    cp = -(-c // 8) * 8
    s = packing.bstride(cp)
    w = pack[:KMAIN * WS].reshape(KMAIN, WS)
    o = KMAIN * WS + 128
    wc = pack[o:o + 128 * s].reshape(128, s)
    bc = pack[o + 128 * s:o + 128 * s + cp]
    pad = (w[:, 128:], wc[:, c:], bc[c:])
    return (w[:, :128], pack[KMAIN * WS:o], wc[:, :c], bc[:c]), pad


# -- the records -------------------------------------------------------------

def test_records_hold_the_folded_weights(model):
    """[kc ; kh] in the kernel's k order (tap kh*3+kw, then the input
    channel; f1's 64 last), the one bias bc + bh, the classifier; zero
    padding."""
    (w, bias, wc, bc), pad = _records(icnet_head.pack_cff2_head(model), C)
    cff2 = model.CFF2
    kc, bc2 = packing.affine(packing.hwio(cff2.low.conv), cff2.low.bn)
    kh, bh = packing.affine(packing.hwio(cff2.high.conv)[0, 0], cff2.high.bn)
    for t in range(9):
        assert torch.equal(w[128 * t:128 * (t + 1)], kc[t // 3, t % 3])
    assert torch.equal(w[1152:], kh)
    assert torch.equal(bias, bc2 + bh)
    wcls, bcls = icnet_head.pack_classifier(model)
    assert torch.equal(wc, wcls) and torch.equal(bc, bcls)
    assert all(not p.any() for p in pad)


@pytest.mark.parametrize("classes", [5, 8, 19, 127, 128])
def test_pack_size_and_stride(classes):
    """The pack's size is the C entry's formula (ssal_cff2_head_pack_size);
    both records' strides are bank-safe and 16-byte aligned."""
    cp = -(-classes // 8) * 8
    s = packing.bstride(cp)
    assert packing.bstride(128) == WS and WS % 32 in (8, 24) and s % 4 == 0
    m = ICNet(classes)
    assert icnet_head.pack_cff2_head(m).numel() == (
        KMAIN * WS + 128 + 128 * s + cp)
    assert (KMAIN * WS) % 4 == 0 and (KMAIN * WS + 128) % 4 == 0


# -- the kernel's arithmetic, tile by tile --------------------------------------

def _tf32(x):
    return round_tf32(x)


def _product(a, w, passes):
    """a @ w as the tensor cores take it: exact (0), one TF32 pass (1), or
    3xTF32 (3: hi*hi + hi*lo + lo*hi), bf16 operands (-1)."""
    if passes == 0:
        return a @ w
    if passes == -1:
        return round_bf16(a) @ round_bf16(w)
    ah, wh = _tf32(a), _tf32(w)
    if passes == 1:
        return ah @ wh
    return ah @ wh + ah @ _tf32(w - wh) + _tf32(a - ah) @ wh


def _upsample(f16, r, c, h8, w8):
    """fused16's 2x upsample at eighth-res positions (r, c) (broadcast
    index tensors), zero outside the grid: csrc/icnet_head.cu taps()."""
    h16, w16 = f16.shape[1:3]
    i = (r >> 1) - 1 + (r & 1)
    j = (c >> 1) - 1 + (c & 1)
    wr = torch.where(r & 1 == 1, 0.75, 0.25)[..., None]
    wc = torch.where(c & 1 == 1, 0.75, 0.25)[..., None]

    def y(a, b):
        return f16[:, a.clamp(0, h16 - 1), b.clamp(0, w16 - 1)]

    v = (wr * wc * y(i, j) + wr * (1 - wc) * y(i, j + 1)
         + (1 - wr) * wc * y(i + 1, j) + (1 - wr) * (1 - wc) * y(i + 1, j + 1))
    inside = (r >= 0) & (r < h8) & (c >= 0) & (c < w8)
    return v * inside[..., None]


def kernel_tiles(f16, f1, pack, c, tr, passes, head=True):
    """The CFF2 + head kernel rebuilt tile by tile (tr x 8 tiles): (fused8
    of every tile's own positions [N, H8, W8, 128], full-res logits [N,
    8H8, 8W8, C] or None without ``head``)."""
    n, h8, w8, _ = f1.shape
    (w, bias, wc, bc), _ = _records(pack, c)
    fused8 = torch.full((n, h8, w8, 128), float("nan"))
    logits = torch.full((n, 8 * h8, 8 * w8, c), float("nan"))
    for r0 in range(0, h8, tr):
        for c0 in range(0, w8, 8):
            r = torch.arange(r0 - 1, r0 + tr + 1)[:, None].expand(-1, 10)
            cc = torch.arange(c0 - 1, c0 + 9)[None, :].expand(tr + 2, -1)
            taps = [_upsample(f16, r + 2 * (kh - 1), cc + 2 * (kw - 1), h8,
                              w8) for kh in range(3) for kw in range(3)]
            inside = (r >= 0) & (r < h8) & (cc >= 0) & (cc < w8)
            f1r = f1[:, r.clamp(0, h8 - 1), cc.clamp(0, w8 - 1)] \
                * inside[..., None]
            a = torch.cat(taps + [f1r], dim=-1)  # [n, tr+2, 10, 1216]
            f8 = torch.relu(_product(a, w, passes) + bias)
            rr, ccs = min(r0 + tr, h8), min(c0 + 8, w8)
            fused8[:, r0:rr, c0:ccs] = f8[:, 1:1 + rr - r0, 1:1 + ccs - c0]
            if not head:
                continue
            # the classifier, each position reading its clamped neighbour
            ri = r.clamp(0, h8 - 1) - r0 + 1
            ci = cc.clamp(0, w8 - 1) - c0 + 1
            # in 3xTF32 where the kernel rounds (kClassifierPasses)
            cl = _product(f8[:, ri, ci], wc, 3 if passes else 0) + bc
            # rows blended by phase t (rows r-1, r, r+1), then columns by
            # phase u (columns c-1, c, c+1)
            v = torch.einsum("ta,nrcla->nrtcl", HEAD8_W, cl.unfold(1, 3, 1))
            px = torch.einsum("ub,nrtplb->nrtpul", HEAD8_W, v.unfold(3, 3, 1))
            px = px.reshape(n, 8 * tr, 64, c)
            logits[:, 8 * r0:8 * rr, 8 * c0:8 * ccs] = \
                px[:, :8 * (rr - r0), :8 * (ccs - c0)]
    return fused8, logits if head else None


def _entropy_score(logits, c):
    p = torch.softmax(logits, dim=-1)
    h = -(p * torch.log_softmax(logits, dim=-1)).sum(-1)
    return (1 - h / np.log(c)).mean(dim=(1, 2))


@pytest.mark.parametrize("hw8", [(18, 10), (6, 20)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_tiles_match_plain_cff2_and_head(model, hw8):
    """Ragged in both directions (H8, W8 = 18, 10 and 6, 20 against the
    kernel's 16x8 tiles): the tile rebuild's fused8, scores and decided
    labels equal the plain versions'."""
    h8, w8 = hw8
    f16, f1 = _inputs(2, h8, w8, 3)
    pack = icnet_head.pack_cff2_head(model)
    with torch.no_grad():
        f8, logits = kernel_tiles(f16, f1, pack, C, TR, 0)
        want8 = model.CFF2(f16, f1)[0]
        torch.testing.assert_close(f8, want8, **TOL)
        want = icnet_head.cff2_head8_entropy_score_plain(f16, f1, model)
        torch.testing.assert_close(_entropy_score(logits, C), want, **TOL)
        plain = xops.resize_bilinear(model.head_pre_logits(want8),
                                     (8 * h8, 8 * w8))
    assert_labels_match(logits.argmax(-1).numpy(), plain.numpy(), 1e-3)


# -- the precision gate's premise ------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_precision_gate_premise_on_fused8(model, seed):
    """On fused8, one TF32 pass stays under half of the error of the plain
    CFF2 with its products in bf16 (chip_smoke.py PRECISION_GATE "TF32"),
    3xTF32 under a tenth of one TF32 pass's ("3xTF32"); bf16 products
    fail the TF32 gate."""
    f16, f1 = _inputs(1, 8, 16, 10 + seed)
    pack = icnet_head.pack_cff2_head(model)
    with torch.no_grad():
        want = model.CFF2(f16, f1)[0]

        def err(passes):
            return (kernel_tiles(f16, f1, pack, C, TR, passes, False)[0]
                    - want).abs().max().item()

        def control(rnd):
            return (rounded(model, rnd, lambda m: m.CFF2(f16, f1)[0],
                            ("CFF2",)) - want).abs().max().item()

        tf32, tf32x3, bf16 = err(1), err(3), err(-1)
        c_bf16, c_tf32 = control(round_bf16), control(round_tf32)
    assert tf32 <= 0.5 * c_bf16, (tf32, c_bf16)
    assert tf32x3 <= 0.1 * c_tf32, (tf32x3, c_tf32)
    assert bf16 > 0.5 * c_bf16, (bf16, c_bf16)


def test_precision_gate_premise_on_scores(model):
    """On the scores the kernel writes, one TF32 pass stays under half of
    the error of the plain version with CFF2's products in bf16 (the
    score route's gate in chip_smoke.py phase 7a)."""
    f16, f1 = _inputs(2, 16, 24, 30)
    pack = icnet_head.pack_cff2_head(model)
    with torch.no_grad():
        want = icnet_head.cff2_head8_entropy_score_plain(f16, f1, model)
        got = _entropy_score(kernel_tiles(f16, f1, pack, C, TR, 1)[1], C)
        lower = rounded(model, round_bf16,
                        lambda m: icnet_head.cff2_head8_entropy_score_plain(
                            f16, f1, m), ("CFF2",))
    err, c_bf16 = (got - want).abs().max(), (lower - want).abs().max()
    assert err <= 0.5 * c_bf16, (err, c_bf16)


# -- the CPU path against the Pallas kernels ----------------------------------------

def _variables(model):
    """The JAX ICNet's CFF2 and classifier variables (the Pallas pack's
    inputs) from the port's weights."""
    def branch(b):
        return ({"conv": {"kernel": packing.hwio(b.conv).numpy()},
                 "bn": {"scale": b.bn.weight.detach().numpy(),
                        "bias": b.bn.bias.detach().numpy()}},
                {"bn": {"mean": b.bn.running_mean.numpy(),
                        "var": b.bn.running_var.numpy()}})

    def conv_bias(c):
        return {"kernel": c.weight.detach().permute(2, 3, 1, 0).numpy(),
                "bias": c.bias.detach().numpy()}

    (lp, ls), (hp, hs) = branch(model.CFF2.low), branch(model.CFF2.high)
    return {"params": {"CFF2": {"low": lp, "high": hp,
                                "aux_cls": conv_bias(model.CFF2.aux_cls)},
                       "Classifier": conv_bias(model.Classifier)},
            "batch_stats": {"CFF2": {"low": ls, "high": hs}}}


def _jax_cff2_head(mdl, fused16, f1):
    """CFF2, the classifier at 1/4 and the 4x upsample of the JAX ICNet:
    full-res logits from fused16 and f1."""
    fused8 = mdl.cff2(fused16, f1, False)[0]
    h8, w8 = fused8.shape[1:3]
    return _resize_bilinear(mdl.head_pre_logits(fused8), (8 * h8, 8 * w8))


@pytest.mark.parametrize("route", ["score", "predict"])
def test_cpu_path_matches_pallas(model, route):
    """H8 = 6, W8 = 10: neither a multiple of the kernel's 8x8 tile."""
    f16, f1 = _inputs(2, 6, 10, 20)
    pack = pallas_kernels.pack_icnet_cff2_head(_variables(model), C)
    j16, j1 = jnp.asarray(f16.numpy()), jnp.asarray(f1.numpy())
    with torch.no_grad():
        if route == "score":
            want = pallas_kernels.fused_cff2_head8_entropy_score(
                j16, j1, pack, C, interpret=True)
            got = icnet_head.fused_cff2_head8_entropy_score(f16, f1, model)
            assert (0.05 < got).all() and (got < 0.95).all()
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-5)
        else:
            # the JAX ICNet's plain CFF2 + head, the predict kernel's
            # reference (tests/test_torch_icnet_kernels.py holds the port
            # to the Pallas predict kernel itself in interpret mode)
            want = JaxICNet(num_classes=C).apply(
                _variables(model), j16, j1, method=_jax_cff2_head)
            got = icnet_head.fused_cff2_head8_predict(f16, f1, model)
            assert got.dtype == torch.int8 and got.shape == (2, 48, 80)
            logits = xops.resize_bilinear(
                model.head_pre_logits(model.CFF2(f16, f1)[0]), (48, 80))
            np.testing.assert_allclose(logits.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-4)
            assert_labels_match(got.numpy(), np.asarray(want), margin=1e-3)
