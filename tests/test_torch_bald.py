"""The port's BALD (MC-dropout) acquisition against the JAX package's,
on the CPU:

- ``bald_confidence_map``, ``mean_bald_confidence`` and
  ``chunked_deconv_bald_confidence`` (ops/acquisition.py) on the same
  numpy-seeded probabilities, logits, features and kernel at T = 3,
  C = 5, with chunks that do and do not divide H2 (rtol = atol = 1e-5:
  fp32 softmax, logs and sums in another order);
- one MC pass of ENet-5 at 1x32x64 on the same weights (the port's
  seeded ENet and its flax tree) against the JAX ENet's
  ``apply(training=False, rngs={"dropout": ...}, return_pre_logits=True)``
  under the same masks, injected on both sides by replacing each
  package's ``spatial_dropout`` for the test (atol 1e-4, in float64 on
  both sides: see the test); the pass
  leaves the running statistics as they were, and plain eval and train
  mode take no MC masks;
- the MC step's rules (``train/steps.make_mc_score_step``): T passes at
  drop rates 0 and one pass score 1 (1e-6); one key gives the same
  scores twice, two keys differ; an image scores the same (1e-6) in a
  batch of 1 and of 4 under the same key and index, and the stacked
  passes score as a forward a pass; the masks are ``MCDropout``'s hash
  of key, index, pass and slot, the same bits on every device.

The JAX model runs through one jit at ``_torch_parity.FAST_COMPILE``
(about 2 s; run eagerly it took 12 s, a compile for every primitive).
Measured: about 14 s on one process.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semanticsegmentationactivelearning_tpu.models import ENet as JaxENet
from semanticsegmentationactivelearning_tpu.ops import acquisition as jacq
from semanticsegmentationactivelearning_tpu.ops import nn as jnn
from semanticsegmentationactivelearning_tpu_torch.ops import (
    acquisition as tacq)
from semanticsegmentationactivelearning_tpu_torch.ops import nn as tnn
from semanticsegmentationactivelearning_tpu_torch.ops.kernels import packing
from semanticsegmentationactivelearning_tpu_torch.train import steps

from _torch_parity import fast_jit, flax_variables, seeded_port_enet

TOL = dict(rtol=1e-5, atol=1e-5)
T, C = 3, 5
HW = (32, 64)
RATES = (0.2, 0.3, 0.25, 0.35, 0.4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def logits_t():
    return np.random.default_rng(0).normal(
        scale=3.0, size=(T, 2, 6, 10, C)).astype(np.float32)


def test_constants_match():
    assert tacq.MC_MEASURES == jacq.MC_MEASURES


def test_bald_map_and_mean_match_jax(logits_t):
    probs = np.array(jax.nn.softmax(jnp.asarray(logits_t), axis=-1))
    want = np.asarray(jacq.bald_confidence_map(jnp.asarray(probs), C))
    got = tacq.bald_confidence_map(torch.from_numpy(probs), C)
    assert got.dtype == torch.float32 and got.shape == (2, 6, 10)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the passes disagree: the map is not the clip's constant
    assert got.min() < 0.99
    want_mean = np.asarray(jacq.mean_bald_confidence(jnp.asarray(logits_t),
                                                     C))
    got_mean = tacq.mean_bald_confidence(torch.from_numpy(logits_t), C)
    assert got_mean.shape == (2,)
    np.testing.assert_allclose(got_mean.numpy(), want_mean, **TOL)


def test_bald_of_agreeing_passes_is_one(logits_t):
    same = np.repeat(logits_t[:1], T, axis=0)
    got = tacq.mean_bald_confidence(torch.from_numpy(same), C)
    np.testing.assert_allclose(got.numpy(), 1.0, rtol=0, atol=1e-6)


@pytest.mark.parametrize("chunk", [8, 4, 3, 2])
def test_chunked_deconv_bald_matches_jax(chunk):
    # H2 = 8: chunks 8, 4 and 2 divide it, 3 does not (one chunk)
    rng = np.random.default_rng(1)
    features = rng.normal(size=(T, 2, 8, 6, 16)).astype(np.float32)
    kernel = rng.normal(scale=0.5, size=(3, 3, 16, C)).astype(np.float32)
    want = np.asarray(jacq.chunked_deconv_bald_confidence(
        jnp.asarray(features), jnp.asarray(kernel), C, chunk=chunk))
    got = tacq.chunked_deconv_bald_confidence(
        torch.from_numpy(features), torch.from_numpy(kernel), C, chunk=chunk)
    assert got.shape == (2,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # and the unchunked tail on the full-res logits
    logits = np.stack([np.asarray(jax.lax.conv_transpose(
        jnp.asarray(f), jnp.asarray(kernel), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))) for f in features])
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jacq.mean_bald_confidence(
            jnp.asarray(logits), C)), **TOL)


# -- one MC pass of ENet, under injected masks ---------------------------

def _masks(seed, widths):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(size=(1, 1, 1, c)) >= rate) for c, rate in widths]


# (channels, rate) of every dropout call of an ENet forward, in order
WIDTHS = ([(64, RATES[0])] * 5 + [(128, RATES[1])] * 9
          + [(128, RATES[2])] * 8 + [(64, RATES[3])] * 3
          + [(16, RATES[4])] * 2)


def _inject(monkeypatch, masks):
    """Replace both packages' spatial_dropout by one that applies
    ``masks`` in call order; returns the port's call log."""
    seen = {"jax": 0, "port": []}

    def jax_dropout(x, rate, key, training=True):
        m = masks[seen["jax"]]
        seen["jax"] += 1
        assert x.shape[-1] == m.shape[-1]
        return jnp.where(m, x / (1.0 - rate), 0.0).astype(x.dtype)

    def port_dropout(x, rate, generator=None, training=True):
        if rate <= 0.0 or not (training
                               or isinstance(generator, tnn.MCDropout)):
            return x
        m = masks[len(seen["port"])]
        seen["port"].append(x.shape[-1])
        return torch.where(torch.from_numpy(m), x / (1.0 - rate),
                           torch.zeros_like(x))

    monkeypatch.setattr(jnn, "spatial_dropout", jax_dropout)
    monkeypatch.setattr(tnn, "spatial_dropout", port_dropout)
    return seen


@pytest.fixture(scope="module")
def enet():
    model = seeded_port_enet(C, 3, drop_rates=RATES, multiscale_heads=False)
    return model.eval(), flax_variables(model)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(4).uniform(size=(1, *HW, 3)) \
        .astype(np.float32)


def test_mc_pass_matches_jax_under_the_same_masks(enet, image,
                                                  monkeypatch):
    # in float64 on both sides: in float32 a 2x2 pool window whose top
    # two values nearly tie may take another switch in either package
    # (ROADMAP Queue 3, pool-switch flips), at this seed in plain eval too
    model, variables = enet
    model = copy.deepcopy(model).double()
    masks = _masks(5, WIDTHS)
    seen = _inject(monkeypatch, masks)
    with jax.enable_x64(True):
        jm = JaxENet(num_classes=C, drop_rates=RATES, dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     variables)
        fn = fast_jit(lambda v, x, k: jm.apply(
            v, x, training=False, rngs={"dropout": k},
            return_pre_logits=True), v64, jnp.asarray(image, jnp.float64),
            jax.random.PRNGKey(0))
        want = np.asarray(fn(v64, jnp.asarray(image, jnp.float64),
                             jax.random.PRNGKey(0)))
    assert seen["jax"] == len(WIDTHS)
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k}
    mc = tnn.MCDropout(0, torch.tensor([0]), [0])
    x = torch.from_numpy(image).double()
    with torch.no_grad():
        got = model(x, generator=mc, return_pre_logits=True)
        plain = model(x, return_pre_logits=True)
    assert seen["port"] == [c for c, _ in WIDTHS]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    for k, v in stats.items():
        assert torch.equal(model.state_dict()[k], v), k
    # the masks moved the features: the comparison is not plain eval's
    assert (got - plain).abs().max() > 1e-2


def test_plain_eval_and_train_take_no_mc_masks(enet, image):
    model, _ = enet
    x = torch.from_numpy(image)
    with torch.no_grad():
        a = model(x, return_pre_logits=True)
        b = model(x, generator=torch.Generator().manual_seed(0),
                  return_pre_logits=True)
        mc = model(x, generator=tnn.MCDropout(0, torch.tensor([0]), [0]),
                   return_pre_logits=True)
    assert torch.equal(a, b)
    assert not torch.equal(a, mc)
    # a train-mode forward draws from its torch.Generator as before
    y = torch.ones(2, 4, 4, 64)
    g = torch.Generator().manual_seed(1)
    want = torch.where(torch.rand((2, 1, 1, 64), generator=g) < 0.7,
                       y / 0.7, torch.zeros_like(y))
    got = tnn.spatial_dropout(y, 0.3, torch.Generator().manual_seed(1),
                              training=True)
    assert torch.equal(got, want)


# -- the MC step's rules --------------------------------------------------

@pytest.fixture(scope="module")
def batch4():
    return torch.from_numpy(np.random.default_rng(6).uniform(
        size=(4, *HW, 3)).astype(np.float32))


@pytest.mark.parametrize("rates,passes", [((0.0,) * 5, 3), (RATES, 1)])
def test_no_disagreement_scores_one(batch4, rates, passes):
    model = seeded_port_enet(C, 3, drop_rates=rates, multiscale_heads=False)
    step = steps.make_mc_score_step(model, C, passes)
    got = step({"image": batch4}, 7, torch.arange(4))
    np.testing.assert_allclose(got.numpy(), 1.0, rtol=0, atol=1e-6)


def test_mc_step_keys_and_batch_invariance(enet, batch4):
    model, _ = enet
    step = steps.make_mc_score_step(model, C, T)
    index = torch.tensor([10, 11, 12, 13])
    a = step({"image": batch4}, (1, 2), index)
    assert a.shape == (4,) and a.dtype == torch.float32
    assert torch.equal(a, step({"image": batch4}, (1, 2), index))
    assert (a - step({"image": batch4}, (1, 3), index)).abs().max() > 1e-5
    assert a.max() < 1.0
    one = step({"image": batch4[2:3]}, (1, 2), index[2:3])
    np.testing.assert_allclose(one.numpy(), a[2:3].numpy(), rtol=0,
                               atol=1e-6)
    # a forward a pass, each with its own pass's masks: the step's
    # stacked batch gives the same scores
    with torch.no_grad():
        feats = torch.stack([model(batch4, generator=tnn.MCDropout(
            (1, 2), index, [t]), return_pre_logits=True) for t in range(T)])
    alone = tacq.chunked_deconv_bald_confidence(
        feats, packing.deconv_hwio(model.Final.deconv), C)
    np.testing.assert_allclose(alone.numpy(), a.numpy(), rtol=0, atol=1e-6)


def test_mc_masks_follow_key_index_and_pass():
    index = torch.tensor([3, 9])
    masks = tnn.MCDropout((5, 1), index, range(4))
    u = masks.uniform(0, 300)
    assert torch.equal(u, torch.cat([masks.uniform(0, 100),
                                     masks.uniform(100, 200)], dim=1))
    # each call takes the next slots
    ones = torch.ones(8, 1, 1, 100)
    for start in (0, 100):
        want = torch.where((masks.uniform(start, 100) < 0.75)
                           .reshape(8, 1, 1, 100), ones / 0.75, 0.0)
        assert torch.equal(masks(ones, 0.25), want)
    # pass-major rows: image 9's pass 2 is row 2 * 2 + 1, whatever else
    # the batch holds
    alone = tnn.MCDropout((5, 1), index[1:], [2]).uniform(0, 300)
    assert torch.equal(u[5], alone[0])
    assert 0.0 <= u.min() and u.max() < 1.0
    assert abs(u.mean().item() - 0.5) < 0.02
    # pinned bits: the hash is integer arithmetic, the same on any device
    first = tnn.MCDropout(0, torch.tensor([0]), [0]).uniform(0, 4)
    assert first.dtype == torch.float32
    assert torch.equal(first, tnn.MCDropout(0, torch.tensor([0]), [0])
                       .uniform(0, 4))
    # a mask keeps each channel at 1 - rate
    mc = tnn.MCDropout(1, torch.arange(64), range(8))
    y = mc(torch.ones(512, 1, 1, 256), 0.25)
    assert abs((y > 0).float().mean().item() - 0.75) < 0.01
    assert torch.all((y == 0) | (y == 1 / 0.75))
