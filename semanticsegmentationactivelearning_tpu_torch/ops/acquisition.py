"""Acquisition / confidence measures for active learning, the PyTorch
port of ``semanticsegmentationactivelearning_tpu/ops/acquisition.py``.

The reference's pseudo-annotation subgraph (active_learning.py:229-269):
softmax over the logits, then one of

- ``entropy``:    1 - H(p)/log(C)   (normalized to [0,1], class-count
                  independent, active_learning.py:240-251)
- ``margin``:     p_top1 - p_top2   (252-255)
- ``confidence``: max_c p_c         (256-258)

plus the per-image mean used as the acquisition score (261-263) and the
pixel-level threshold mask for pseudo-labelling (265-269). Logits are
NHWC ``[B, H, W, C]``, as in the JAX package.

All of it is plain PyTorch. The entropy measure's hot path is the score
kernels of ``ops/kernels`` (ENet's tail, decoder and deconv; ICNet's
CFF2 + head and head); the other measures take
:func:`chunked_deconv_mean_confidence` (ENet) and
:func:`chunked_upsample_mean_confidence` (ICNet), as the JAX package
leaves them to XLA. The Monte-Carlo measure (BALD) scores T MC-dropout
passes: :func:`bald_confidence_map`, :func:`mean_bald_confidence` and,
for ENet's pre-logits, :func:`chunked_deconv_bald_confidence`; none of
them reaches a Pallas kernel in the JAX package either.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import nn as xops

# Lowest representable float32 (reference: active_learning.py:40)
EPSILON = float(np.finfo(np.float32).tiny)

MEASURES = ("entropy", "margin", "confidence")
# Monte-Carlo measures need several stochastic forwards per image and a
# key; they are acquisition-only (pseudo-labelling falls back to
# "entropy": a per-pixel MI is not a confidence in the predicted label)
MC_MEASURES = ("bald",)


def confidence_map(logits: torch.Tensor, measure: str,
                   num_classes: int) -> torch.Tensor:
    """Per-pixel confidence ``[B,H,W]`` from logits ``[B,H,W,C]``."""
    prob = torch.softmax(logits.float(), dim=-1)
    if measure == "entropy":
        entropy = -torch.sum(prob * torch.log(prob + EPSILON), dim=-1)
        return 1.0 - entropy / math.log(num_classes)
    if measure == "margin":
        top2 = torch.topk(prob, 2, dim=-1).values
        return top2[..., 0] - top2[..., 1]
    if measure == "confidence":
        return prob.amax(dim=-1)
    raise NotImplementedError(
        f"Uncertainty function {measure!r} not implemented.")


def mean_confidence(logits: torch.Tensor, measure: str,
                    num_classes: int) -> torch.Tensor:
    """Per-image mean confidence ``[B]``, the pool acquisition score
    (active_learning.py:261-263)."""
    return confidence_map(logits, measure, num_classes).mean(dim=(1, 2))


def conv_transpose_same(x: torch.Tensor, kernel: torch.Tensor
                        ) -> torch.Tensor:
    """``lax.conv_transpose(x, kernel, (2, 2), "SAME")`` on NHWC ``x``
    with the flax kernel ``[3, 3, cin, cout]``: the spatially flipped
    kernel through ``conv_transpose2d(stride=2)``, cropped to 2H x 2W."""
    _, h, w, _ = x.shape
    weight = kernel.permute(2, 3, 0, 1).flip(2, 3).to(x.dtype)
    out = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight, stride=2)
    return out[:, :, :2 * h, :2 * w].permute(0, 2, 3, 1)


def chunked_deconv_mean_confidence(features: torch.Tensor,
                                   kernel: torch.Tensor, measure: str,
                                   num_classes: int,
                                   chunk: int = 32) -> torch.Tensor:
    """The scoring tail as plain PyTorch: 3x3/s2 transposed conv (the
    ENet ``Final`` layer) -> softmax -> confidence -> per-image mean,
    over row chunks of the half-resolution features, so that only a
    ``[N, 2*chunk+4, W, C]`` logits window is live at a time.

    Chunks carry a one-row halo on each side: a stride-2 kernel-3
    transposed conv's output row ``y`` draws from input rows
    ``floor((y-1)/2)..floor((y+1)/2)``, so after running SAME on the
    haloed slice the two outermost output rows on each side are invalid
    and dropped.

    :param features: ``[N, H2, W2, cin]`` pre-Final features (H = 2*H2)
    :param kernel:   ``[3, 3, cin, C]`` flax ConvTranspose kernel
    :returns: ``[N]`` mean confidence (float32)
    """
    n, h2, w2, _cin = features.shape
    if h2 % chunk != 0:
        # one chunk if the height doesn't divide evenly
        chunk = h2
    # zero-pad one feature row top and bottom so halo slices never clamp
    padded = F.pad(features, (0, 0, 0, 0, 1, 1))
    sums = torch.zeros(n, dtype=torch.float32, device=features.device)
    for i in range(h2 // chunk):
        rows = padded[:, i * chunk:i * chunk + chunk + 2]
        logits = conv_transpose_same(rows, kernel)[:, 2:-2].float()
        sums += confidence_map(logits, measure, num_classes).sum(dim=(1, 2))
    return sums / float(h2 * 2 * w2 * 2)


def chunked_upsample_mean_confidence(logits_low: torch.Tensor, scale: int,
                                     measure: str, num_classes: int,
                                     chunk: int = 32) -> torch.Tensor:
    """The scoring tail of a model that classifies at reduced resolution
    (ICNet's 1/4-res head) as plain PyTorch: bilinear ``scale``x
    upsample -> softmax -> confidence -> per-image mean, over row chunks
    of the low-res logits, so that only a ``[N, (chunk+2)*scale, W, C]``
    logits window is live at a time.

    Each chunk carries a one-row halo from an edge-replicated pad: a
    bilinear upsample's output row draws on at most the low-res rows
    next to it, so the kept interior rows of a slice's resize equal the
    global resize, at the image edges too, where the replicated row is
    the resize's own clamp.

    :param logits_low: ``[N, Hl, Wl, C]`` low-resolution logits
    :param scale:      integer upsample factor to full resolution
    :returns: ``[N]`` mean confidence (float32)
    """
    n, hl, wl, _c = logits_low.shape
    if hl % chunk != 0:
        # one chunk if the height doesn't divide evenly
        chunk = hl
    low = logits_low.float()
    padded = torch.cat([low[:, :1], low, low[:, -1:]], dim=1)
    sums = torch.zeros(n, dtype=torch.float32, device=logits_low.device)
    for i in range(hl // chunk):
        rows = padded[:, i * chunk:i * chunk + chunk + 2]
        up = xops.resize_bilinear(rows, ((chunk + 2) * scale, wl * scale))
        conf = confidence_map(up[:, scale:-scale], measure, num_classes)
        sums += conf.sum(dim=(1, 2))
    return sums / float(hl * scale * wl * scale)


def bald_confidence_map(probs_t: torch.Tensor,
                        num_classes: int) -> torch.Tensor:
    """Per-pixel BALD confidence ``[B,H,W]`` from T MC-dropout
    probability maps ``[T,B,H,W,C]``: ``1 - I(y; w | x) / log C`` with
    ``I = H(E_t[p_t]) - E_t[H(p_t)]`` (Houlsby et al., arXiv:1112.5745),
    both entropies normalised by ``log C`` and the difference clipped to
    [0, 1], which by Jensen's inequality only guards rounding."""
    probs_t = probs_t.float()
    log_c = math.log(num_classes)
    ent_t = -torch.sum(probs_t * torch.log(probs_t + EPSILON), dim=-1)
    mean_ent = ent_t.mean(dim=0) / log_c
    mean_p = probs_t.mean(dim=0)
    pred_ent = -torch.sum(mean_p * torch.log(mean_p + EPSILON),
                          dim=-1) / log_c
    return 1.0 - torch.clamp(pred_ent - mean_ent, 0.0, 1.0)


def mean_bald_confidence(logits_t: torch.Tensor,
                         num_classes: int) -> torch.Tensor:
    """Per-image mean BALD confidence ``[B]`` from stacked MC logits
    ``[T,B,H,W,C]`` (the scoring tail of a model without pre-logits)."""
    probs_t = torch.softmax(logits_t.float(), dim=-1)
    return bald_confidence_map(probs_t, num_classes).mean(dim=(1, 2))


def chunked_deconv_bald_confidence(features_t: torch.Tensor,
                                   kernel: torch.Tensor, num_classes: int,
                                   chunk: int = 8) -> torch.Tensor:
    """The BALD scoring tail of ENet's pre-logits as plain PyTorch: the
    T passes' half-res features ``[T,N,H2,W2,cin]`` through the Final
    3x3/s2 transposed conv -> softmax -> per-pixel mutual information
    -> per-image mean, over row chunks, so that only a
    ``[T,N,2*chunk+4,W,C]`` window of the T full-res probability maps
    is live at a time. The halo arithmetic is
    :func:`chunked_deconv_mean_confidence`'s.

    :param kernel: ``[3, 3, cin, C]`` flax ConvTranspose kernel
    :returns: ``[N]`` mean confidence (float32)
    """
    t, n, h2, w2, cin = features_t.shape
    if h2 % chunk != 0:
        # one chunk if the height doesn't divide evenly
        chunk = h2
    padded = F.pad(features_t, (0, 0, 0, 0, 1, 1))
    sums = torch.zeros(n, dtype=torch.float32, device=features_t.device)
    for i in range(h2 // chunk):
        rows = padded[:, :, i * chunk:i * chunk + chunk + 2]
        logits = conv_transpose_same(
            rows.reshape(t * n, chunk + 2, w2, cin), kernel)[:, 2:-2]
        probs = torch.softmax(logits.float(), dim=-1)
        conf = bald_confidence_map(probs.reshape(t, n, *probs.shape[1:]),
                                   num_classes)
        sums += conf.sum(dim=(1, 2))
    return sums / float(h2 * 2 * w2 * 2)


def pseudo_annotate(logits: torch.Tensor, measure: str, num_classes: int,
                    threshold: float):
    """Pseudo-label + high-confidence mask from a no-dropout forward
    (active_learning.py:231-269).

    :returns: (pseudo_label int32 ``[B,H,W]``,
               pseudo_mask float32 ``[B,H,W]``,
               mean_conf float32 ``[B]``)
    """
    logits = logits.detach()
    pseudo_label = logits.argmax(dim=-1).to(torch.int32)
    conf = confidence_map(logits, measure, num_classes)
    pseudo_mask = (conf >= threshold).float()
    return pseudo_label, pseudo_mask, conf.mean(dim=(1, 2))
