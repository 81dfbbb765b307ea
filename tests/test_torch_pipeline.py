"""The port's device data path (``data/pipeline.py``) against the JAX
package's: the deterministic core of ``augment_batch`` (crop, flip,
scale, mask) on JAX's own draws, bit for bit; ``eval_batch``'s centre
crop, bit for bit; and the law of the port's draws (crop origins
uniform over the valid range, flips at 1/2, scales uniform on
[0.8, 1.4)). Measured: about 6 s on one process.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semanticsegmentationactivelearning_tpu.data import (
    pipeline as jpipeline)
from semanticsegmentationactivelearning_tpu_torch.data import pipeline

CROP = (16, 24)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stack(seed, n=6, hs=28, ws=40, channels=3):
    rng = np.random.default_rng(seed)
    stack = rng.integers(0, 256, (n, hs, ws, channels + 1)).astype(np.uint8)
    stack[..., channels] = rng.integers(0, 20, (n, hs, ws))
    stack[:, :3, :5, channels] = 255                    # ignored pixels
    # valid sizes: smaller than the storage, one exactly the crop, one
    # below it (the window then takes padding, as dynamic_slice does)
    heights = np.array([28, 20, 16, 12, 25, 28], np.int32)[:n]
    widths = np.array([40, 30, 24, 20, 33, 26], np.int32)[:n]
    return stack, heights, widths


def _jax_draws(key, heights, widths):
    """The draws of the JAX ``_random_crop_flip`` and ``augment_batch``
    for ``key`` (the same splits and formulas)."""
    n = len(heights)
    k_top, k_left, k_flip, k_scale = jax.random.split(key, 4)
    max_top = np.maximum(heights - CROP[0], 0)
    max_left = np.maximum(widths - CROP[1], 0)
    tops = np.floor(np.asarray(jax.random.uniform(k_top, (n,)))
                    * (max_top + 1)).astype(np.int64)
    lefts = np.floor(np.asarray(jax.random.uniform(k_left, (n,)))
                     * (max_left + 1)).astype(np.int64)
    flips = np.asarray(jax.random.bernoulli(k_flip, 0.5, (n,)))
    scales = np.asarray(jax.random.uniform(k_scale, (n, 1, 1, 3),
                                           minval=0.8, maxval=1.4))
    return tops, lefts, flips, scales


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_core_equals_jax_on_its_draws(seed):
    stack, heights, widths = _stack(seed)
    key = jax.random.PRNGKey(seed)
    want = jpipeline.augment_batch(jnp.asarray(stack), heights, widths, key,
                                   crop_hw=CROP, channels=3)
    tops, lefts, flips, scales = _jax_draws(key, heights, widths)
    assert flips.any() and not flips.all()
    got = pipeline.crop_flip_scale(
        torch.from_numpy(stack), torch.tensor(tops), torch.tensor(lefts),
        torch.tensor(flips), torch.tensor(scales), CROP, channels=3)
    names = ("image_raw", "image", "label", "mask")
    for name, w, g in zip(names, want, got):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert got[2].dtype == torch.int64 and got[3].dtype == torch.float32
    assert (got[3] == 0).any() and (got[2][got[3] == 0] == 0).all()


def test_eval_batch_equals_jax():
    stack, heights, widths = _stack(5)
    want = jpipeline.eval_batch(jnp.asarray(stack), heights, widths,
                                crop_hw=CROP, channels=3)
    got = pipeline.eval_batch(torch.from_numpy(stack), heights, widths,
                              CROP, channels=3)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_draws_follow_the_jax_law():
    n = 6000
    heights = np.full(n, 20)
    widths = np.full(n, 30)
    gen = torch.Generator().manual_seed(0)
    tops, lefts, flips, scales = pipeline.draw_augmentation(
        heights, widths, CROP, 3, gen)
    # origins uniform over 0..max (5 and 7 values): every value, each
    # within 5 standard deviations of n / values
    for draws, values in ((tops, 5), (lefts, 7)):
        counts = np.bincount(draws.numpy(), minlength=values)
        assert len(counts) == values
        sd = np.sqrt(n * (1 / values) * (1 - 1 / values))
        assert np.abs(counts - n / values).max() < 5 * sd
    share = flips.float().mean().item()
    assert abs(share - 0.5) < 5 * np.sqrt(0.25 / n)
    assert scales.shape == (n, 1, 1, 3)
    assert scales.min() >= 0.8 and scales.max() < 1.4
    assert abs(scales.mean().item() - 1.1) < 5 * 0.6 / np.sqrt(12 * 3 * n)
    again = pipeline.draw_augmentation(heights, widths, CROP, 3,
                                       torch.Generator().manual_seed(0))
    for a, b in zip((tops, lefts, flips, scales), again):
        assert torch.equal(a, b)


def test_augment_batch_is_the_core_on_the_draws():
    stack, heights, widths = _stack(7)
    t = torch.from_numpy(stack)
    got = pipeline.augment_batch(t, heights, widths,
                                 torch.Generator().manual_seed(3), CROP)
    draws = pipeline.draw_augmentation(heights, widths, CROP, 3,
                                       torch.Generator().manual_seed(3))
    want = pipeline.crop_flip_scale(t, *draws, crop_hw=CROP)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the distorted image is the raw one scaled per channel, clipped
    np.testing.assert_allclose(got[1].numpy(),
                               torch.clamp(got[0] * draws[3], 0, 1).numpy(),
                               rtol=2e-7, atol=0)
