"""The PyTorch port's pool-scoring slice against the JAX package's: the
plain versions of the three score kernels (ops/kernels/tail.py,
decoder.py, deconv_score.py) against the Pallas kernels in interpret
mode, ``ENet.fused_score`` on each route against the JAX
``fused_score``'s plain reference (``use_pallas=False``), and ``make_score_step`` against the JAX
``make_score_step``, on the same numpy-seeded inputs and converted
weights (noised BatchNorm statistics, the Final kernel scaled by 25 on
both sides so that the scores sit well away from 0), fp32 on the CPU.

On the CPU each wrapper runs its plain version, so these tests pin the
plain versions that the CUDA kernels are held against on the card
(chip_smoke.py phase 5 and the ``cuda``-marked tests of
test_torch_cuda.py).

Tolerance: atol 1e-5 on the ``[N]`` scores of a kernel against its
Pallas counterpart on identical inputs (means over at most 3072 pixels,
summed in another order); atol 1e-4 on the scores of a whole chain, as
in the port's other whole-chain tests (the two chains feed each stage
slightly different fp32 inputs)."""

import collections

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticsegmentationactivelearning_tpu.models import ENet as JaxENet
from semanticsegmentationactivelearning_tpu.ops import pallas_kernels
from semanticsegmentationactivelearning_tpu.train import steps as jax_steps
from semanticsegmentationactivelearning_tpu_torch.ops import acquisition
from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
    deconv_score, decoder, front, packing, tail)
from semanticsegmentationactivelearning_tpu_torch.train import (bridge,
                                                                steps)

from _torch_parity import (fast_jit, noised_variables, port_model,
                           to_numpy_tree)

C = 5
FINAL_SCALE = 25.0
KERNEL_TOL = dict(rtol=0, atol=1e-5)
CHAIN_TOL = dict(rtol=0, atol=1e-4)


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
    jm = JaxENet(num_classes=C)
    v = noised_variables(jm, np.zeros((1, 16, 32, 3), np.float32), 4)
    params = dict(v["params"])
    params["Final"] = {"deconv": {
        "kernel": params["Final"]["deconv"]["kernel"] * FINAL_SCALE}}
    variables = {"params": params, "batch_stats": v["batch_stats"]}
    return jm, variables, port_model(variables, C)


def _image(shape, seed):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _switches(rng, shape):
    return rng.integers(0, 4, shape).astype(np.int8)


# -- each kernel's plain version against its Pallas kernel -------------

def test_tail_score_matches_pallas(setup):
    _, variables, tm = setup
    rng = np.random.default_rng(7)
    y = rng.normal(size=(1, 6, 8, 128)).astype(np.float32)
    sw2 = _switches(rng, (1, 6, 8, 64))
    mask1 = front.switches_to_mask(torch.from_numpy(
        _switches(rng, (1, 12, 16 * 16)))).numpy()
    want = pallas_kernels.fused_tail_entropy_score(
        jnp.asarray(y), jnp.asarray(sw2), jnp.asarray(mask1),
        pallas_kernels.pack_enet_tail(variables, C), C, interpret=True)
    got = tail.fused_tail_entropy_score(
        torch.from_numpy(y), torch.from_numpy(sw2), torch.from_numpy(mask1),
        tm)
    assert got.dtype == torch.float32 and got.shape == (1,)
    assert 0.05 < float(got[0]) < 0.95  # away from both ends
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


def test_decoder_score_matches_pallas(setup):
    _, variables, tm = setup
    rng = np.random.default_rng(8)
    f4 = rng.normal(size=(1, 4, 8, 64)).astype(np.float32)
    switches = _switches(rng, (1, 4, 8 * 16))
    want = np.asarray(pallas_kernels.fused_decoder_entropy_score(
        jnp.asarray(f4), jnp.asarray(switches),
        pallas_kernels.pack_enet_decoder(variables, C), C, interpret=True))
    f4_t, sw_t = torch.from_numpy(f4), torch.from_numpy(switches)
    by_switches = decoder.fused_decoder_entropy_score(f4_t, sw_t, tm)
    by_mask = decoder.fused_decoder_entropy_score(
        f4_t, None, tm, mask=front.switches_to_mask(sw_t))
    assert by_switches.dtype == torch.float32 and by_switches.shape == (1,)
    assert 0.05 < float(by_switches[0]) < 0.95
    np.testing.assert_allclose(by_switches.numpy(), want, **KERNEL_TOL)
    np.testing.assert_allclose(by_mask.numpy(), want, **KERNEL_TOL)
    with pytest.raises(ValueError, match="switches or mask"):
        decoder.fused_decoder_entropy_score(f4_t, None, tm)


def test_deconv_score_matches_pallas(setup):
    _, variables, tm = setup
    features = np.random.default_rng(9).normal(
        size=(1, 8, 16, 16)).astype(np.float32)
    kernel = variables["params"]["Final"]["deconv"]["kernel"]
    want = pallas_kernels.fused_deconv_entropy_score(
        jnp.asarray(features), kernel, C, interpret=True)
    # the port's Final kernel, converted through the bridge
    got = deconv_score.fused_deconv_entropy_score(
        torch.from_numpy(features), packing.deconv_hwio(tm.Final.deconv), C)
    assert got.dtype == torch.float32 and got.shape == (1,)
    assert 0.05 < float(got[0]) < 0.95
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


def test_bridge_carries_every_score_kernel_weight(setup):
    """The tail pack, which the tail and decoder routes read, holds
    B4_0..B5_1 and Final; the bridge converts each of their parameters
    and statistics, and the converted Final kernel is the JAX one
    exactly."""
    _, variables, tm = setup
    converted = bridge.state_dict_from_flax(to_numpy_tree(variables))
    prefixes = ("Bottleneck4_", "Bottleneck5_", "Final.")
    needed = {k for k in tm.state_dict() if k.startswith(prefixes)}
    assert needed and needed <= converted.keys()
    np.testing.assert_array_equal(
        packing.deconv_hwio(tm.Final.deconv).numpy(),
        np.asarray(variables["params"]["Final"]["deconv"]["kernel"]))
    # the decoder route's kernel (csrc/tail.cu tail5_kernel) reads the
    # tail pack from record T5_FIRST to its end: B5_0's four records,
    # B5_1's three and the Final's, each its layer's folded weights, zero
    # in the padding (the vectors: test_torch_tail_pack.py)
    layout = tail.tail_layout(C)
    pack = tail.pack_tail(tm)
    assert pack.numel() == layout[-1][0] + 9 * 16 * layout[-1][4]
    b50, b51 = tm.Bottleneck5_0, tm.Bottleneck5_1
    by_layer = [
        packing.conv_taps(b50.proj_conv, b50.proj_bn)[0],
        packing.hwio(b50.res_conv)[0],
        tail.phase_taps(packing.affine(packing.deconv_hwio(b50.deconv),
                                       b50.conv_bn, b50.conv_prelu)[0]),
        packing.conv_taps(b50.exp_conv, b50.exp_bn)[0],
        packing.conv_taps(b51.proj_conv, b51.proj_bn)[0],
        packing.conv_taps(b51.conv, b51.conv_bn)[0].reshape(1, 36, 4),
        packing.conv_taps(b51.exp_conv, b51.exp_bn)[0],
        tail.phase_taps(packing.deconv_hwio(tm.Final.deconv))]
    assert len(layout) - tail.T5_FIRST == len(by_layer)
    for (off, taps, k, n, s, _), want in zip(layout[tail.T5_FIRST:],
                                             by_layer):
        w = pack[off:off + taps * k * s].reshape(taps, k, s)
        t0, k0, n0 = want.shape
        assert t0 == taps and torch.equal(w[:, :k0, :n0], want)
        assert not w[:, k0:].any() and not w[:, :, n0:].any()


def test_scoring_seams_match_jax(setup):
    """return_stage4, return_pre_logits, forward_from_stage1,
    forward_stage4 and decode_from_stage4 against the JAX seams (one
    jitted reference: eager flax dispatch compiles every op alone)."""
    jm, variables, tm = setup
    x = _image((1, 16, 32, 3), 10)
    tx = torch.from_numpy(x)
    tol = dict(rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        f4, sw1 = tm(tx, return_stage4=True)
        pre = tm(tx, return_pre_logits=True)
        x1, _ = tm(tx, return_stage1=True)
        y, sw2 = tm.forward_stage23(x1)
        got = (f4, sw1, pre, tm.forward_from_stage1(x1),
               tm.forward_stage4(y, sw2), tm.decode_from_stage4(f4, sw1))

    def seams(v, x, x1, y, sw2):
        f4, sw1 = jm.apply(v, x, return_stage4=True)
        return (f4, sw1, jm.apply(v, x, return_pre_logits=True),
                jm.apply(v, x1, method="forward_from_stage1"),
                jm.apply(v, y, sw2, method="forward_stage4"),
                jm.apply(v, f4, sw1, method="decode_from_stage4"))

    args = (variables, x, x1.numpy(), y.numpy(), sw2.numpy())
    want = fast_jit(seams, *args)(*args)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    assert tm.supports_fused_scoring


# -- ENet.fused_score on each route against the JAX fused_score ---------

# (route, image shape, fused_score flags, the port wrapper it must take)
ROUTES = [
    ("tail", (1, 48, 64, 3), {}, (tail, "fused_tail_entropy_score")),
    # H/8 = 5 < 6: front and mid kernels, plain stage 4, decoder on mask1
    ("decoder_mask", (1, 40, 64, 3), {},
     (decoder, "fused_decoder_entropy_score")),
    # the same route asked for at the tail route's shape
    ("decoder_mask_no_tail", (1, 48, 64, 3), dict(fuse_tail=False),
     (decoder, "fused_decoder_entropy_score")),
    # H < 24: the plain encoder, decoder on the switches
    ("decoder_switches", (1, 16, 32, 3), {},
     (decoder, "fused_decoder_entropy_score")),
    ("deconv", (1, 16, 32, 3), dict(fuse_decoder=False),
     (deconv_score, "fused_deconv_entropy_score")),
]


@pytest.fixture(scope="module")
def route_scores(setup):
    """Each route's image and the JAX package's plain score of it
    (use_pallas=False, the reference its own tests hold each route's
    Pallas chain to), in one jitted call: eager flax dispatch compiles
    every op alone."""
    jm, variables, _ = setup
    images = [_image(shape, 11) for _, shape, _, _ in ROUTES]

    def scores(v, *xs):
        return [jm.fused_score(v, x, "entropy", use_pallas=False, **flags)
                for x, (_, _, flags, _) in zip(xs, ROUTES)]

    want = fast_jit(scores, variables, *images)(variables, *images)
    return {r[0]: (x, w) for r, x, w in zip(ROUTES, images, want)}


@pytest.mark.parametrize("route, shape, flags, wrapper", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_fused_score_route_matches_jax(setup, route_scores, monkeypatch,
                                       route, shape, flags, wrapper):
    # the kernel tests above hold each plain version to its Pallas kernel
    # in interpret mode, test_torch_kernels.py the front,
    # test_torch_mid_pack.py the mid
    jm, variables, tm = setup
    x, want = route_scores[route]
    assert x.shape == shape
    mod, name = wrapper
    calls = []
    real = getattr(mod, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(mod, name, spy)
    got = tm.fused_score(torch.from_numpy(x), "entropy", **flags)
    assert calls == [name]
    assert got.dtype == torch.float32 and got.shape == (1,)
    assert 0.05 < float(got[0]) < 0.95
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHAIN_TOL)


def test_short_inputs_take_the_decoder_on_mask1(setup, monkeypatch):
    """H/8 = 5 < 6: the front and mid kernels, then plain stage 4 and
    the decoder score on the front's mask, which equals the plain
    forward's score."""
    tm = setup[2]
    calls = []
    for mod, name in ((front, "fused_front_stage1"),
                      (decoder, "fused_decoder_entropy_score")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _real=real, _name=name,
                            **k: calls.append(_name) or _real(*a, **k))
    x = torch.from_numpy(_image((2, 40, 64, 3), 14))
    got = tm.fused_score(x, "entropy")
    assert calls == ["fused_front_stage1", "fused_decoder_entropy_score"]
    with torch.no_grad():
        want = acquisition.mean_confidence(tm(x), "entropy", C)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **CHAIN_TOL)


@pytest.fixture(scope="module")
def measure_scores(setup):
    """The JAX package's margin and confidence scores of one image, in
    one jitted call."""
    jm, variables, _ = setup
    x = _image((1, 16, 32, 3), 12)
    want = fast_jit(lambda v, x: {m: jm.fused_score(v, x, m) for m in
                                  ("margin", "confidence")},
                    variables, x)(variables, x)
    return x, want


@pytest.mark.parametrize("measure", ["margin", "confidence"])
def test_fused_score_other_measures_match_jax(setup, measure_scores,
                                              measure):
    tm = setup[2]
    x, want = measure_scores
    want = want[measure]
    got = tm.fused_score(torch.from_numpy(x), measure)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHAIN_TOL)


def test_fused_score_rejects_bad_shapes(setup):
    tm = setup[2]
    with pytest.raises(ValueError, match="divisible by 8"):
        tm.fused_score(torch.zeros(1, 20, 32, 3), "entropy")


def test_score_wrappers_refuse_other_devices(setup):
    """A tensor that is neither on the CPU nor on a CUDA device raises
    instead of silently taking the plain path."""
    tm = setup[2]
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tail.fused_tail_entropy_score(
            torch.empty(1, 2, 2, 128, **meta),
            torch.empty(1, 2, 2, 64, dtype=torch.int8, **meta),
            torch.empty(1, 4, 4, 64, **meta), tm)
    with pytest.raises(ValueError, match="CUDA"):
        decoder.fused_decoder_entropy_score(
            torch.empty(1, 2, 2, 64, **meta), None, tm,
            mask=torch.empty(1, 2, 2, 64, **meta))
    with pytest.raises(ValueError, match="CUDA"):
        deconv_score.fused_deconv_entropy_score(
            torch.empty(1, 2, 2, 16, **meta), torch.empty(3, 3, 16, C, **meta),
            C)


def test_score_launch_counters_stay_zero_on_cpu(setup):
    tm = setup[2]
    wrappers = (tail.fused_tail_entropy_score,
                decoder.fused_decoder_entropy_score,
                deconv_score.fused_deconv_entropy_score)
    tm.fused_score(torch.zeros(1, 48, 16, 3), "entropy")
    tm.fused_score(torch.zeros(1, 16, 16, 3), "entropy")
    tm.fused_score(torch.zeros(1, 16, 16, 3), "entropy", fuse_decoder=False)
    assert [fn.launches for fn in wrappers] == [0, 0, 0]


# -- make_score_step ------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
def test_make_score_step_matches_jax(setup, fused):
    jm, variables, tm = setup
    state = collections.namedtuple("State", "params batch_stats")(
        variables["params"], variables["batch_stats"])
    x = _image((2, 48, 64, 3), 13)
    want = jax_steps.make_score_step(jm, C, "entropy", fused=fused)(
        state, {"image": jnp.asarray(x)})
    got = steps.make_score_step(tm, C, "entropy", fused=fused)(
        {"image": torch.from_numpy(x)})
    assert got.dtype == torch.float32 and got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHAIN_TOL)
