"""The PyTorch port's acquisition measures (ops/acquisition.py) against
the JAX package's, on the same numpy-seeded logits and features.

Tolerance: rtol = atol = 1e-5 (fp32 softmax, log and sums taken in
another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semanticsegmentationactivelearning_tpu.ops import acquisition as jacq
from semanticsegmentationactivelearning_tpu_torch.ops import (
    acquisition as tacq)

TOL = dict(rtol=1e-5, atol=1e-5)
C = 7


@pytest.fixture(scope="module")
def logits():
    return np.random.default_rng(0).normal(
        scale=3.0, size=(2, 6, 10, C)).astype(np.float32)


@pytest.fixture(scope="module")
def deconv_inputs():
    rng = np.random.default_rng(1)
    features = rng.normal(size=(2, 8, 6, 16)).astype(np.float32)
    kernel = rng.normal(scale=0.5, size=(3, 3, 16, C)).astype(np.float32)
    return features, kernel


def test_constants_match():
    assert tacq.EPSILON == jacq.EPSILON
    assert tacq.MEASURES == jacq.MEASURES


@pytest.mark.parametrize("measure", tacq.MEASURES)
def test_confidence_map_and_mean_match_jax(logits, measure):
    want = np.asarray(jacq.confidence_map(jnp.asarray(logits), measure, C))
    got = tacq.confidence_map(torch.from_numpy(logits), measure, C)
    assert got.dtype == torch.float32 and got.shape == (2, 6, 10)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want_mean = np.asarray(jacq.mean_confidence(jnp.asarray(logits),
                                                measure, C))
    got_mean = tacq.mean_confidence(torch.from_numpy(logits), measure, C)
    assert got_mean.shape == (2,)
    np.testing.assert_allclose(got_mean.numpy(), want_mean, **TOL)


def test_unknown_measure_raises(logits):
    with pytest.raises(NotImplementedError):
        tacq.confidence_map(torch.from_numpy(logits), "bald", C)


def test_conv_transpose_same_matches_lax(deconv_inputs):
    features, kernel = deconv_inputs
    want = jax.lax.conv_transpose(
        jnp.asarray(features), jnp.asarray(kernel), strides=(2, 2),
        padding="SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tacq.conv_transpose_same(torch.from_numpy(features),
                                   torch.from_numpy(kernel))
    assert got.shape == (2, 16, 12, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# H2 = 8: a chunk of 4 divides it, 3 does not (one whole chunk instead)
@pytest.mark.parametrize("chunk", [4, 3])
@pytest.mark.parametrize("measure", tacq.MEASURES)
def test_chunked_deconv_mean_confidence_matches_jax(deconv_inputs, measure,
                                                    chunk):
    features, kernel = deconv_inputs
    want = np.asarray(jacq.chunked_deconv_mean_confidence(
        jnp.asarray(features), jnp.asarray(kernel), measure, C, chunk=chunk))
    got = tacq.chunked_deconv_mean_confidence(
        torch.from_numpy(features), torch.from_numpy(kernel), measure, C,
        chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the chunks' halos reproduce the unchunked score
    whole = tacq.mean_confidence(tacq.conv_transpose_same(
        torch.from_numpy(features), torch.from_numpy(kernel)), measure, C)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **TOL)


@pytest.mark.parametrize("measure", tacq.MEASURES)
def test_pseudo_annotate_matches_jax(logits, measure):
    want = jacq.pseudo_annotate(jnp.asarray(logits), measure, C, 0.5)
    got = tacq.pseudo_annotate(torch.from_numpy(logits), measure, C, 0.5)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # the mask may differ only where the confidence sits at the threshold
    conf = np.asarray(jacq.confidence_map(jnp.asarray(logits), measure, C))
    clear = np.abs(conf - 0.5) > 1e-5
    assert 0.0 < np.asarray(want[1]).mean() < 1.0
    np.testing.assert_array_equal(got[1].numpy()[clear],
                                  np.asarray(want[1])[clear])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **TOL)
