"""The plain versions of the PyTorch port's six ICNet kernels
(ops/kernels/icnet_front.py, icnet_head.py) against the JAX package's
Pallas kernels, fp32 on the CPU: the front and front+stem kernels, the
head score kernel and both predict kernels in interpret mode, the CFF2 +
head score kernel through the JAX composition that tests/test_icnet.py
already pins it to (CFF2 by ``model.apply``, then the head kernel in
interpret mode), and ``chunked_upsample_mean_confidence``, the plain
head's tail. Inputs are
numpy-seeded; the weights are one JAX ``ICNet.init`` at 64x96 (a 2-tile
grid of the front kernels) with noised BatchNorm statistics, through
``train/bridge.py``, the classifier scaled by 25 on both sides.

On the CPU each wrapper runs its plain version, so these tests pin the
plain versions that the CUDA kernels are held against on the card
(chip_smoke.py phase 7 and the ``cuda``-marked tests of
test_torch_cuda.py).

Tolerances: features rtol 1e-4 / atol 1e-5 (x_half 1e-5 / 1e-6, one
resize); scores rtol 1e-4 / atol 1e-5, as tests/test_icnet.py holds the
Pallas kernels; labels equal wherever the plain version's top-2 logit
margin exceeds 1e-3 (the Pallas kernels sum the nine upsample taps in
another order than the two resizes), on at least 99% of the pixels."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semanticsegmentationactivelearning_tpu.ops import (
    acquisition as jax_acquisition)
from semanticsegmentationactivelearning_tpu.ops import pallas_kernels
from semanticsegmentationactivelearning_tpu_torch.models import ICNet
from semanticsegmentationactivelearning_tpu_torch.ops import acquisition
from semanticsegmentationactivelearning_tpu_torch.ops import nn as xops
from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
    icnet_front, icnet_head)

from _torch_parity import assert_labels_match, icnet_variables, port_icnet

HW = (64, 96)
C = 5
CLS_SCALE = 25.0
FEATURE_TOL = dict(rtol=1e-4, atol=1e-5)
SCORE_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process while the suite's workers share the
    cores: with a thread per core in each worker this file's torch work
    ran tens of times slower than alone. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    jm, v = icnet_variables(C, HW, 1)
    params = dict(v["params"])
    cls = params["Classifier"]
    params["Classifier"] = {"kernel": cls["kernel"] * CLS_SCALE,
                            "bias": cls["bias"]}
    variables = {"params": params, "batch_stats": v["batch_stats"]}
    return jm, variables, port_icnet(variables, C)


def _image(shape, seed):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _classifier(variables):
    p = variables["params"]["Classifier"]
    return jnp.asarray(p["kernel"][0, 0]), jnp.asarray(p["bias"])


# -- the front kernels -------------------------------------------------------

def test_front_matches_pallas(setup):
    _, variables, tm = setup
    x = _image((1, *HW, 3), 1)
    f1, x_half = pallas_kernels.fused_icnet_front(
        jnp.asarray(x), pallas_kernels.pack_icnet_front(variables),
        interpret=True)
    got_f1, got_xh = icnet_front.fused_icnet_front(torch.from_numpy(x), tm)
    assert got_f1.shape == (1, 8, 12, 64) and got_xh.shape == (1, 32, 48, 3)
    assert np.asarray(f1).max() > 0.1  # not vacuous
    np.testing.assert_allclose(got_f1.numpy(), np.asarray(f1), **FEATURE_TOL)
    np.testing.assert_allclose(got_xh.numpy(), np.asarray(x_half), rtol=1e-5,
                               atol=1e-6)


def test_front_stem_matches_pallas(setup):
    _, variables, tm = setup
    x = _image((1, *HW, 3), 2)
    f1, stem1 = pallas_kernels.fused_icnet_front_stem(
        jnp.asarray(x), pallas_kernels.pack_icnet_front_stem(variables),
        interpret=True)
    got_f1, got_st = icnet_front.fused_icnet_front_stem(torch.from_numpy(x),
                                                        tm)
    assert got_st.shape == (1, 8, 12, 64)
    assert np.asarray(stem1).max() > 0.1
    np.testing.assert_allclose(got_f1.numpy(), np.asarray(f1), **FEATURE_TOL)
    np.testing.assert_allclose(got_st.numpy(), np.asarray(stem1),
                               **FEATURE_TOL)


# -- the head kernels ----------------------------------------------------------

def test_head8_matches_pallas(setup):
    """At h8 = 8 the Pallas kernel's grid has two row tiles, so its
    clipped halo rows meet in the middle as well as at the edges."""
    _, variables, tm = setup
    f8 = (0.2 * np.maximum(np.random.default_rng(3).normal(
        size=(2, 8, 12, 128)), 0)).astype(np.float32)
    wcls, bcls = _classifier(variables)
    want = pallas_kernels.fused_head8_entropy_score(
        jnp.asarray(f8), wcls, bcls, C, interpret=True)
    twcls, tbcls = icnet_head.pack_classifier(tm)
    got = icnet_head.fused_head8_entropy_score(torch.from_numpy(f8), twcls,
                                               tbcls, C)
    assert got.dtype == torch.float32 and got.shape == (2,)
    assert (0.05 < got).all() and (got < 0.95).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)


def test_cff2_head_matches_jax_composition(setup):
    """CFF2 by model.apply, then the head kernel in interpret mode (the
    composition tests/test_icnet.py pins the CFF2 + head kernel to)."""
    jm, variables, tm = setup
    rng = np.random.default_rng(4)
    fused16 = (0.2 * rng.normal(size=(2, 4, 6, 128))).astype(np.float32)
    f1 = (0.2 * np.maximum(rng.normal(size=(2, 8, 12, 64)), 0)) \
        .astype(np.float32)

    def cff2(m):
        return m.cff2(jnp.asarray(fused16), jnp.asarray(f1), False)[0]

    fused8 = jm.apply(variables, method=cff2)
    want = pallas_kernels.fused_head8_entropy_score(
        fused8, *_classifier(variables), C, interpret=True)
    got = icnet_head.fused_cff2_head8_entropy_score(
        torch.from_numpy(fused16), torch.from_numpy(f1), tm)
    assert (0.05 < got).all() and (got < 0.95).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)


def _head_logits(fused8, tm):
    """The plain head's full-resolution logits, the decided-pixel rule's
    reference."""
    _, h8, w8, _ = fused8.shape
    return xops.resize_bilinear(tm.head_pre_logits(fused8), (8 * h8, 8 * w8))


def test_head8_predict_matches_pallas(setup):
    """At h8 = 8 the Pallas kernel's grid has two row tiles; random
    features, so a transposed row or column phase would show."""
    _, variables, tm = setup
    f8 = (0.2 * np.maximum(np.random.default_rng(13).normal(
        size=(2, 8, 12, 128)), 0)).astype(np.float32)
    want = pallas_kernels.fused_head8_predict(
        jnp.asarray(f8), *_classifier(variables), C, interpret=True)
    got = icnet_head.fused_head8_predict(
        torch.from_numpy(f8), *icnet_head.pack_classifier(tm), C)
    assert got.dtype == torch.int8 and got.shape == (2, 64, 96)
    with torch.no_grad():
        logits = _head_logits(torch.from_numpy(f8), tm).numpy()
    assert_labels_match(got.numpy(), logits, margin=1e-3)
    assert_labels_match(np.asarray(want), logits, margin=1e-3)


def test_cff2_head_predict_matches_pallas(setup):
    _, variables, tm = setup
    rng = np.random.default_rng(14)
    fused16 = (0.2 * rng.normal(size=(2, 4, 6, 128))).astype(np.float32)
    f1 = (0.2 * np.maximum(rng.normal(size=(2, 8, 12, 64)), 0)) \
        .astype(np.float32)
    want = pallas_kernels.fused_cff2_head8_predict(
        jnp.asarray(fused16), jnp.asarray(f1),
        pallas_kernels.pack_icnet_cff2_head(variables, C), C, interpret=True)
    got = icnet_head.fused_cff2_head8_predict(
        torch.from_numpy(fused16), torch.from_numpy(f1), tm)
    assert got.dtype == torch.int8 and got.shape == (2, 64, 96)
    with torch.no_grad():
        logits = _head_logits(
            tm.CFF2(torch.from_numpy(fused16), torch.from_numpy(f1))[0],
            tm).numpy()
    assert_labels_match(got.numpy(), logits, margin=1e-3)
    assert_labels_match(np.asarray(want), logits, margin=1e-3)


@pytest.mark.parametrize("measure", ["entropy", "margin", "confidence"])
@pytest.mark.parametrize("chunk", [2, 3, 32])
def test_chunked_upsample_matches_jax(measure, chunk):
    """Dividing (2), non-dividing (3: one chunk) and the default chunk."""
    low = (np.random.default_rng(5).normal(size=(2, 8, 12, C)) * 3) \
        .astype(np.float32)
    want = jax_acquisition.chunked_upsample_mean_confidence(
        jnp.asarray(low), 4, measure, C, chunk=chunk)
    got = acquisition.chunked_upsample_mean_confidence(
        torch.from_numpy(low), 4, measure, C, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)


# -- wrappers -------------------------------------------------------------------

def test_packs_hold_the_kernels_weights(setup):
    """Pack sizes are the C entries' formulas; packs are cached per
    device until load_state_dict."""
    tm = setup[2]
    # the fronts: six GEMM records (a 3-channel conv one tap of K = 27
    # padded to 32 rows, a 32-channel one nine taps of 32), the rows at
    # stride 40 for 32 outputs and 72 for 64, each with its bias
    rec = lambda taps, cout, stride: taps * 32 * stride + cout
    assert icnet_front.pack_icnet_front(tm).numel() == 2 * (
        rec(1, 32, 40) + rec(9, 32, 40) + rec(9, 64, 72))
    # CFF2 + head: two GEMM records, [kc ; kh] [1216, 136] with bc + bh,
    # the classifier [128, 8] with bcls, C = 5 padded to 8
    assert icnet_head.pack_cff2_head(tm).numel() == (
        1216 * 136 + 128 + 128 * 8 + 8)
    model = ICNet(C)
    model.load_state_dict(tm.state_dict())
    first = model.packed("cff2_head", "cpu", icnet_head.pack_cff2_head)
    assert model.packed("cff2_head", "cpu", icnet_head.pack_cff2_head) \
        is first
    model.load_state_dict(tm.state_dict())
    assert model.packed("cff2_head", "cpu", icnet_head.pack_cff2_head) \
        is not first


def test_wrappers_refuse_other_devices(setup):
    """A tensor that is neither on the CPU nor on a CUDA device raises
    instead of silently taking the plain path."""
    tm = setup[2]
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        icnet_front.fused_icnet_front(torch.empty(1, 32, 32, 3, **meta), tm)
    with pytest.raises(ValueError, match="CUDA"):
        icnet_front.fused_icnet_front_stem(torch.empty(1, 32, 32, 3, **meta),
                                           tm)
    with pytest.raises(ValueError, match="CUDA"):
        icnet_head.fused_head8_entropy_score(
            torch.empty(1, 4, 4, 128, **meta), torch.empty(128, C, **meta),
            torch.empty(C, **meta), C)
    for fn in (icnet_head.fused_cff2_head8_entropy_score,
               icnet_head.fused_cff2_head8_predict):
        with pytest.raises(ValueError, match="CUDA"):
            fn(torch.empty(1, 2, 2, 128, **meta),
               torch.empty(1, 4, 4, 64, **meta), tm)
    with pytest.raises(ValueError, match="CUDA"):
        icnet_head.fused_head8_predict(
            torch.empty(1, 4, 4, 128, **meta), torch.empty(128, C, **meta),
            torch.empty(C, **meta), C)


def test_launch_counters_stay_zero_on_cpu(setup):
    tm = setup[2]
    wrappers = (icnet_front.fused_icnet_front,
                icnet_front.fused_icnet_front_stem,
                icnet_head.fused_head8_entropy_score,
                icnet_head.fused_cff2_head8_entropy_score,
                icnet_head.fused_head8_predict,
                icnet_head.fused_cff2_head8_predict)
    before = [fn.launches for fn in wrappers]
    x = torch.zeros(1, 32, 32, 3)
    for flags in ({}, dict(fuse_cff2=False), dict(fuse_stem=False)):
        tm.fused_score(x, "entropy", **flags)
        tm.fused_predict(x, **flags)
    assert [fn.launches for fn in wrappers] == before == [0] * 6
