"""Device-side input preprocessing, the PyTorch port of
``semanticsegmentationactivelearning_tpu/data/pipeline.py`` (reference:
tensortools/input.py:235-329).

A batch arrives as a uint8 stack ``[B, Hs, Ws, C+1]`` (image channels
and the label plane) on the device, padded to a common storage size,
with each example's valid ``heights`` and ``widths``. The train path
(:func:`augment_batch`):

- a random crop inside each example's valid region,
- a random left-right flip (p = 0.5),
- uint8 -> float32 in [0, 1],
- a per-example, per-channel intensity scale U[0.8, 1.4), clipped to
  [0, 1] (the reference's ``px_scaling``, input.py:308-326),
- the ignore mask ``label != 255``, masked labels set to 0.

It returns the undistorted crop (``image_raw``, the pseudo-labelling
forward's input) beside the distorted one, as ``_default_augmentation``
does (input.py:296-329). The draws (:func:`draw_augmentation`) are
split from the deterministic core (:func:`crop_flip_scale`), which
computes what the JAX function computes from the same draws; the draws
follow the JAX law from a ``torch.Generator`` on the device.
:func:`eval_batch` is the evaluation path's centre crop.

The pool pass of the active-learning loop scores the undistorted crop
of a label-free stack: :func:`score_batch` draws its crops and flips as
:func:`augment_batch` does (so for one generator state it returns
``augment_batch``'s ``image_raw``), and :func:`score_batch_indexed`
draws each row's from a CPU generator seeded by the pass's key and the
row's global example index alone, so that an example's crop does not
depend on the batch, the size bucket or the order it is scored in. Both
share the deterministic core :func:`score_crops`. The JAX package keys
a row by ``fold_in(pass_key, index)``; its PRNG stream is not
reproduced, only the law: ``top = floor(u * (max(h - ch, 0) + 1))``,
the same for ``left``, and ``flip = u < 0.5``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def generate_mask(labels: torch.Tensor, mask_index: int = 255
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``mask = label != mask_index``; masked labels mapped to 0
    (reference: input.py:18-36). Returns (int64 labels, float32 mask)."""
    mask = labels != mask_index
    clean = torch.where(mask, labels, torch.zeros_like(labels)).long()
    return clean, mask.float()


# uint8 -> float32 in [0, 1] as XLA compiles the JAX package's
# ``/ 255.0``: a product with the float32 reciprocal
_UNIT = 1.0 / 255.0


def _as_index(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).long()


def _crops(stack: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
           flips, crop_hw: Tuple[int, int]) -> torch.Tensor:
    """``[B, ch, cw, planes]`` windows of ``stack`` at each example's
    (top, left), columns reversed where ``flips``, in one gather. Like
    ``lax.dynamic_slice``, an origin is clamped so the window fits."""
    n, hs, ws, _ = stack.shape
    ch, cw = crop_hw
    dev = stack.device
    tops = _as_index(tops, dev).clamp(0, hs - ch)
    lefts = _as_index(lefts, dev).clamp(0, ws - cw)
    rows = tops[:, None] + torch.arange(ch, device=dev)
    j = torch.arange(cw, device=dev)
    if flips is not None:
        j = torch.where(_as_index(flips, dev).bool()[:, None], cw - 1 - j, j)
    cols = lefts[:, None] + j
    b = torch.arange(n, device=dev)
    return stack[b[:, None, None], rows[:, :, None], cols[:, None, :]]


def _span(heights, span) -> Tuple[int, int]:
    """``(first row, rows drawn)``: a batch's rows within the global
    batch whose draws are made (``span``), by default the batch."""
    return (0, len(heights)) if span is None else span


def draw_crops(heights, widths, crop_hw: Tuple[int, int],
               generator: torch.Generator, span=None):
    """A batch's crop and flip draws on the generator's device: crop
    origins ``floor(u * (max(valid - crop, 0) + 1))`` for u ~ U[0, 1)
    and flips ~ Bernoulli(0.5). ``span = (first, total)``: the batch is
    rows ``first ..`` of a global batch of ``total`` rows, whose draws
    are made and this batch's kept (a rank's rows draw what one process
    draws for them). Returns (tops, lefts, flips)."""
    dev = generator.device
    heights = _as_index(heights, dev)
    widths = _as_index(widths, dev)
    first, total = _span(heights, span)
    rows = slice(first, first + heights.shape[0])
    max_top = (heights - crop_hw[0]).clamp(min=0)
    max_left = (widths - crop_hw[1]).clamp(min=0)
    u = torch.rand((3, total), generator=generator, device=dev)[:, rows]
    tops = torch.floor(u[0] * (max_top + 1)).long()
    lefts = torch.floor(u[1] * (max_left + 1)).long()
    return tops, lefts, u[2] < 0.5


def draw_augmentation(heights, widths, crop_hw: Tuple[int, int],
                      channels: int, generator: torch.Generator,
                      span=None):
    """The train path's random draws for a batch, on the generator's
    device: :func:`draw_crops`, then scales ~ U[0.8, 1.4) of shape
    ``[B, 1, 1, channels]`` (``span``: as :func:`draw_crops`). Returns
    (tops, lefts, flips, scales)."""
    tops, lefts, flips = draw_crops(heights, widths, crop_hw, generator,
                                    span)
    first, total = _span(tops, span)
    scales = 0.8 + 0.6 * torch.rand((total, 1, 1, channels),
                                    generator=generator,
                                    device=generator.device)
    return tops, lefts, flips, scales[first:first + tops.shape[0]]


def crop_flip_scale(stack: torch.Tensor, tops, lefts, flips,
                    scales: torch.Tensor, crop_hw: Tuple[int, int],
                    channels: int = 3):
    """The deterministic core of :func:`augment_batch` on given draws.
    Returns ``(image_raw, image, label, mask)``: float32 images
    ``[B, ch, cw, channels]``, int64 labels and a float32 mask."""
    crops = _crops(stack, tops, lefts, flips, crop_hw)
    pixels = crops[..., :channels].float()
    label, mask = generate_mask(crops[..., channels])
    # XLA folds the two products of (x / 255) * scale into x * (scale /
    # 255); the same association gives the same bits
    image_dist = torch.clamp(pixels * (scales * _UNIT), 0.0, 1.0)
    return pixels * _UNIT, image_dist, label, mask


def augment_batch(stack: torch.Tensor, heights, widths,
                  generator: torch.Generator, crop_hw: Tuple[int, int],
                  channels: int = 3, span=None):
    """Training-path augmentation of a uint8 ``[B, Hs, Ws, channels+1]``
    stack; ``generator`` lives on the stack's device; ``span``: the
    batch's rows in a global batch (:func:`draw_crops`). Returns
    ``(image_raw, image, label, mask)`` (see :func:`crop_flip_scale`)."""
    draws = draw_augmentation(heights, widths, crop_hw, channels, generator,
                              span)
    return crop_flip_scale(stack, *draws, crop_hw=crop_hw, channels=channels)


def score_crops(stack: torch.Tensor, tops, lefts, flips,
                crop_hw: Tuple[int, int], channels: Optional[int] = None
                ) -> torch.Tensor:
    """The deterministic core of the pool pass's crop: the windows of a
    label-free uint8 stack ``[B, Hs, Ws, planes]`` at the given origins,
    flipped where ``flips``, as float32 in [0, 1] with the bits of the
    JAX package's ``score_batch``. ``channels``: the planes to keep
    (default all)."""
    crops = _crops(stack, tops, lefts, flips, crop_hw)
    if channels is not None:
        crops = crops[..., :channels]
    return crops.float() * _UNIT


def score_batch(stack: torch.Tensor, heights, widths,
                generator: torch.Generator, crop_hw: Tuple[int, int],
                channels: Optional[int] = None) -> torch.Tensor:
    """The pool pass's undistorted crop with a batch's draws: for one
    generator state it equals ``augment_batch(...)[0]`` on the labelled
    stack (the same :func:`draw_crops`)."""
    tops, lefts, flips = draw_crops(heights, widths, crop_hw, generator)
    return score_crops(stack, tops, lefts, flips, crop_hw, channels)


def draw_score_crops(heights, widths, crop_hw: Tuple[int, int],
                     pass_key: Sequence[int], index):
    """Each row's crop and flip for the pool pass, on the CPU: row ``i``
    draws three U[0, 1) from ``np.random.default_rng([*pass_key,
    index[i]])``, so its draws depend on the pass's key (the AL loop's
    ``(seed + 13, round)``) and its global example index alone. Returns
    int64 (tops, lefts) and bool flips, CPU tensors."""
    heights = np.asarray(heights, dtype=np.int64)
    widths = np.asarray(widths, dtype=np.int64)
    key = [int(k) for k in pass_key]
    u = np.stack([np.random.default_rng(key + [int(i)]).random(3)
                  for i in np.asarray(index).reshape(-1)]).reshape(-1, 3)
    tops = np.floor(u[:, 0] * (np.maximum(heights - crop_hw[0], 0) + 1))
    lefts = np.floor(u[:, 1] * (np.maximum(widths - crop_hw[1], 0) + 1))
    return (torch.from_numpy(tops.astype(np.int64)),
            torch.from_numpy(lefts.astype(np.int64)),
            torch.from_numpy(u[:, 2] < 0.5))


def score_batch_indexed(stack: torch.Tensor, heights, widths,
                        pass_key: Sequence[int], index,
                        crop_hw: Tuple[int, int],
                        channels: Optional[int] = None) -> torch.Tensor:
    """:func:`score_batch` with per-example draws
    (:func:`draw_score_crops`): pool scores do not change with the batch
    size, the size buckets or the order of the pool. ``heights``,
    ``widths`` and ``index`` are the loader's host arrays."""
    draws = draw_score_crops(heights, widths, crop_hw, pass_key, index)
    return score_crops(stack, *draws, crop_hw=crop_hw, channels=channels)


def eval_batch(stack: torch.Tensor, heights, widths,
               crop_hw: Tuple[int, int], channels: int = 3):
    """Evaluation-path preprocessing: the centre crop
    ``max(valid // 2 - crop // 2, 0)`` (reference: input.py:277-293).
    Returns ``(image, label, mask)``."""
    dev = stack.device
    tops = (_as_index(heights, dev) // 2 - crop_hw[0] // 2).clamp(min=0)
    lefts = (_as_index(widths, dev) // 2 - crop_hw[1] // 2).clamp(min=0)
    crops = _crops(stack, tops, lefts, None, crop_hw)
    image = crops[..., :channels].float() * _UNIT
    label, mask = generate_mask(crops[..., channels])
    return image, label, mask
