"""The active-learning slice's host and data pieces against the JAX
package on the CPU:

- ``data/sampler.IndexSampler`` (a copy): the same ``epoch_order()``
  sequence as the JAX class from the same seed, across ``set_indices``
  and ``set_sample_size`` calls;
- the pool pass's crop: ``pipeline.score_crops`` on the draws the JAX
  ``score_batch_indexed`` derives from ``fold_in(pass_key, index)``
  (recomputed here with ``jax.random``) is bit-equal to the JAX
  function's output; ``score_batch`` equals ``augment_batch``'s
  undistorted crop for one generator state; the port's own per-example
  draws (``score_batch_indexed``) do not change with the batching or
  the order of the pool, stay inside each example's valid region and
  follow the JAX law (uniform origins, flips at 1/2).

Measured: about 3 s on one process.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semanticsegmentationactivelearning_tpu.data import (
    pipeline as jax_pipeline, sampler as jax_sampler)
from semanticsegmentationactivelearning_tpu_torch.data import (pipeline,
                                                               sampler)

CROP = (8, 12)


def test_sampler_matches_jax():
    files = [f"f{i}" for i in range(23)]
    ours = sampler.IndexSampler(files, rng=np.random.default_rng(4))
    theirs = jax_sampler.IndexSampler(files, rng=np.random.default_rng(4))
    calls = [("set_indices", ([3, 7, 1, 9, 12],)),
             ("set_sample_size", (3,)),
             ("set_indices", ([0, 5, 6, 2, 8, 20, 21],)),
             ("set_sample_size", (30,)),
             ("set_indices", (None,)),
             ("set_sample_size", (0,))]
    orders = 0
    for name, call_args in calls:
        getattr(ours, name)(*call_args)
        getattr(theirs, name)(*call_args)
        assert ours.size == theirs.size
        for _ in range(3):
            np.testing.assert_array_equal(ours.epoch_order(),
                                          theirs.epoch_order())
            orders += 1
    assert orders == 18


def _pool(seed, n=6, planes=3):
    rng = np.random.default_rng(seed)
    stack = rng.integers(0, 256, (n, 16, 20, planes), dtype=np.uint8)
    heights = rng.integers(CROP[0] - 2, 17, n).astype(np.int32)
    widths = rng.integers(CROP[1] - 2, 21, n).astype(np.int32)
    return stack, heights, widths


def _jax_draws(pass_key, heights, widths, index, crop):
    """The JAX ``score_batch_indexed``'s own draws
    (data/pipeline.py:160-170)."""
    tops, lefts, flips = [], [], []
    for h, w, i in zip(heights, widths, index):
        kt, kl, kf = jax.random.split(jax.random.fold_in(pass_key, i), 3)
        tops.append(int(jnp.floor(jax.random.uniform(kt)
                                  * (max(h - crop[0], 0) + 1))))
        lefts.append(int(jnp.floor(jax.random.uniform(kl)
                                   * (max(w - crop[1], 0) + 1))))
        flips.append(bool(jax.random.bernoulli(kf, 0.5)))
    return tops, lefts, flips


@pytest.mark.parametrize("case", ["pool", "every_value"])
def test_score_core_matches_jax_bit_for_bit(case):
    """On a pool of varied sizes, and on one image of every uint8 value
    (so each value's float is JAX's)."""
    if case == "pool":
        stack, heights, widths = _pool(0)
        index, crop, channels = np.array([5, 0, 17, 3, 9, 2]), CROP, 2
    else:
        stack = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
        heights = widths = np.array([16])
        index, crop, channels = np.array([4]), (16, 16), None
    pass_key = jax.random.fold_in(jax.random.PRNGKey(13), 2)
    want = np.asarray(jax_pipeline.score_batch_indexed(
        jnp.asarray(stack), jnp.asarray(heights), jnp.asarray(widths),
        pass_key, jnp.asarray(index), crop_hw=crop, channels=channels))
    draws = _jax_draws(pass_key, heights, widths, index, crop)
    if case == "pool":
        assert any(draws[2]) and not all(draws[2])
    got = pipeline.score_crops(torch.from_numpy(stack), *draws, crop,
                               channels=channels)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_score_batch_is_the_augmentation_raw_crop():
    stack, heights, widths = _pool(1, planes=4)
    labelled = torch.from_numpy(stack)
    raw = pipeline.augment_batch(labelled, heights, widths,
                                 torch.Generator().manual_seed(3), CROP)[0]
    got = pipeline.score_batch(labelled[..., :3], heights, widths,
                               torch.Generator().manual_seed(3), CROP)
    assert torch.equal(got, raw)


def test_score_draws_do_not_depend_on_the_batching():
    stack, heights, widths = _pool(2, n=8)
    index = np.arange(40, 48)
    key = (13, 1)
    whole = pipeline.score_batch_indexed(torch.from_numpy(stack), heights,
                                         widths, key, index, CROP)
    order = np.array([6, 1, 7, 3, 0, 5, 2, 4])
    for part in (order[:3], order[3:]):
        got = pipeline.score_batch_indexed(
            torch.from_numpy(stack[part]), heights[part], widths[part], key,
            index[part], CROP)
        assert torch.equal(got, whole[part])
    other = pipeline.score_batch_indexed(torch.from_numpy(stack), heights,
                                         widths, (13, 2), index, CROP)
    assert not torch.equal(other, whole)


@pytest.mark.parametrize("excess", [0, 3])
def test_score_draws_follow_the_jax_law(excess):
    n = 4000
    heights = np.full(n, CROP[0] + excess)
    widths = np.full(n, CROP[1] + 2 * excess)
    tops, lefts, flips = pipeline.draw_score_crops(
        heights, widths, CROP, (13, 0), np.arange(n))
    for draws, top in ((tops, excess), (lefts, 2 * excess)):
        counts = np.bincount(draws.numpy(), minlength=top + 1)
        assert len(counts) == top + 1
        np.testing.assert_allclose(counts / n, 1.0 / (top + 1), atol=0.03)
    assert abs(flips.float().mean().item() - 0.5) < 0.03
