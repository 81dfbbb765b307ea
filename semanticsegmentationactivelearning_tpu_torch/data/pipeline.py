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
"""

from __future__ import annotations

from typing import Tuple

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


def draw_augmentation(heights, widths, crop_hw: Tuple[int, int],
                      channels: int, generator: torch.Generator):
    """The train path's random draws for a batch, on the generator's
    device: crop origins ``floor(u * (max(valid - crop, 0) + 1))`` for
    u ~ U[0, 1), flips ~ Bernoulli(0.5), scales ~ U[0.8, 1.4) of shape
    ``[B, 1, 1, channels]``. Returns (tops, lefts, flips, scales)."""
    dev = generator.device
    heights = _as_index(heights, dev)
    widths = _as_index(widths, dev)
    n = heights.shape[0]
    max_top = (heights - crop_hw[0]).clamp(min=0)
    max_left = (widths - crop_hw[1]).clamp(min=0)
    u = torch.rand((3, n), generator=generator, device=dev)
    tops = torch.floor(u[0] * (max_top + 1)).long()
    lefts = torch.floor(u[1] * (max_left + 1)).long()
    flips = u[2] < 0.5
    scales = 0.8 + 0.6 * torch.rand((n, 1, 1, channels),
                                    generator=generator, device=dev)
    return tops, lefts, flips, scales


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
                  channels: int = 3):
    """Training-path augmentation of a uint8 ``[B, Hs, Ws, channels+1]``
    stack; ``generator`` lives on the stack's device. Returns
    ``(image_raw, image, label, mask)`` (see :func:`crop_flip_scale`)."""
    draws = draw_augmentation(heights, widths, crop_hw, channels, generator)
    return crop_flip_scale(stack, *draws, crop_hw=crop_hw, channels=channels)


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
