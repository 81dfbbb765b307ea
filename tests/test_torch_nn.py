"""Parity of the PyTorch port's ``ops/nn.py`` with the JAX package's:
pooling switches (first maximum on ties), unpooling, PReLU and spatial
dropout, on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticsegmentationactivelearning_tpu.ops import nn as jops
from semanticsegmentationactivelearning_tpu_torch.ops import nn as tops


def _inputs(kind, shape=(2, 6, 8, 5), seed=0):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        # few distinct values: most windows hold a tied maximum
        return rng.integers(-1, 2, size=shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_max_pool_with_switches_matches_jax(kind):
    x = _inputs(kind)
    jp, jsw = jops.max_pool_with_switches(jnp.asarray(x))
    tp, tsw = tops.max_pool_with_switches(torch.from_numpy(x))
    assert tsw.dtype == torch.int8 and tuple(tsw.shape) == jsw.shape
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tsw.numpy(), np.asarray(jsw))


def test_ties_keep_the_first_maximum():
    x = np.zeros((1, 2, 2, 1), np.float32)  # all four positions tie
    _, sw = tops.max_pool_with_switches(torch.from_numpy(x))
    assert sw.item() == 0
    x[0, 1, 0, 0] = x[0, 1, 1, 0] = 1.0      # positions 2 and 3 tie
    _, sw = tops.max_pool_with_switches(torch.from_numpy(x))
    assert sw.item() == 2


@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_unpool_with_switches_matches_jax(kind):
    x = _inputs(kind, seed=1)
    y = _inputs("normal", shape=(2, 3, 4, 5), seed=2)
    _, jsw = jops.max_pool_with_switches(jnp.asarray(x))
    _, tsw = tops.max_pool_with_switches(torch.from_numpy(x))
    want = np.asarray(jops.unpool_with_switches(jnp.asarray(y), jsw))
    got = tops.unpool_with_switches(torch.from_numpy(y), tsw).numpy()
    np.testing.assert_array_equal(got, want)


def test_switches_to_onehot_matches_jax():
    x = _inputs("ties", seed=3)
    _, jsw = jops.max_pool_with_switches(jnp.asarray(x))
    want = np.asarray(jops.switches_to_onehot(jsw, 5))
    got = tops.switches_to_onehot(torch.from_numpy(np.array(jsw)), 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pool_unpool_round_trip():
    # non-negative: the zeros unpooling writes never win a window
    x = torch.from_numpy(np.abs(_inputs("normal", seed=4)))
    pooled, sw = tops.max_pool_with_switches(x)
    again, _ = tops.max_pool_with_switches(
        tops.unpool_with_switches(pooled, sw))
    torch.testing.assert_close(again, pooled, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_max_pool_2x2_matches_jax(kind):
    x = _inputs(kind, seed=5)
    want = np.asarray(jops.max_pool_2x2(jnp.asarray(x)))
    np.testing.assert_array_equal(
        tops.max_pool_2x2(torch.from_numpy(x)).numpy(), want)


def test_odd_sizes_raise():
    with pytest.raises(ValueError):
        tops.max_pool_with_switches(torch.zeros(1, 3, 4, 2))


def test_prelu_matches_jax():
    x = _inputs("normal", seed=6)
    alpha = np.linspace(-0.5, 0.5, 5).astype(np.float32)
    want = np.asarray(jops.prelu(jnp.asarray(x), jnp.asarray(alpha)))
    got = tops.prelu(torch.from_numpy(x), torch.from_numpy(alpha))
    np.testing.assert_array_equal(got.numpy(), want)


def test_spatial_dropout():
    x = torch.ones(4, 3, 3, 16)
    assert tops.spatial_dropout(x, 0.5, training=False) is x
    assert tops.spatial_dropout(x, 0.0) is x
    gen = torch.Generator().manual_seed(0)
    out = tops.spatial_dropout(x, 0.5, generator=gen)
    # whole channels dropped, survivors scaled by 1/keep
    per_channel = out.reshape(4, 9, 16)
    assert torch.all(per_channel.amin(1) == per_channel.amax(1))
    assert set(out.unique().tolist()) <= {0.0, 2.0}
    again = tops.spatial_dropout(x, 0.5,
                                 generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(out, again)
