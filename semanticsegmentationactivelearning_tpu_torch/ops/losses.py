"""Segmentation losses, the PyTorch port of
``semanticsegmentationactivelearning_tpu/ops/losses.py`` (reference:
tensortools/losses.py).

``masked_softmax_cross_entropy``: label smoothing through the on/off
one-hot values, the ignore mask as a weight, the optional ENet
log-inverse class weighting ``w = 1/log(c + (e - c) * p_true)`` and the
two-phase reduction (sum over the batch, divide by the mask sum, sum
over the plane), all in float32 as the JAX package computes them.

Under several ranks each returns the rank's share of the global
batch's loss (the divisor is the global mask sum), which the train
step's gradient sum completes.

``multiscale_masked_softmax_cross_entropy`` sums the CE over the
model's loss heads, nearest-resizing labels and mask to each head
(TF1's legacy rule ``src = floor(dst * in/out)``).

``regularization_loss`` is the Keras-style L1/L2 penalty on conv
kernels and PReLU alphas. The JAX function selects the leaves named
``kernel`` and ``alpha``; in the port a conv's kernel and a batch
norm's scale are both named ``weight``, so this one selects by module
type (the blocks' ``Conv`` and ``ConvTranspose``, the multiscale heads
among them, ICNet's 1x1 classifiers with bias, ``Conv1x1Bias``, by their
kernels alone, and ``PReLU``) and never touches a ``BatchNorm``.
"""

from __future__ import annotations

import math
import weakref
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..parallel import distributed

_EULER = 1.718281828459045  # the reference's constant (losses.py:27)


def masked_softmax_cross_entropy(labels: torch.Tensor, logits: torch.Tensor,
                                 mask: torch.Tensor, num_classes: int,
                                 weight: float = 0.0,
                                 label_smoothing: float = 0.0
                                 ) -> torch.Tensor:
    """Mean masked (optionally class-weighted, smoothed) cross-entropy.

    :param labels: ``[B,H,W]`` int class ids (ignored pixels already 0
                   and excluded through ``mask``)
    :param logits: ``[B,H,W,C]``
    :param mask:   ``[B,H,W]`` float 0/1
    """
    on_value = 1.0 - label_smoothing
    off_value = label_smoothing / (num_classes - 1.0)
    # sum_c onehot_c * logp_c
    #   = (on - off) * (logit[label] - lse) + off * (sum_c logit_c - C*lse)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    labels = labels.long()
    # a label outside [0, C) picks nothing, as the JAX iota compare does
    inside = (labels >= 0) & (labels < num_classes)
    picked_logit = logits.gather(
        -1, labels.clamp(0, num_classes - 1).unsqueeze(-1)).squeeze(-1)
    logit_label = torch.where(inside, picked_logit,
                              torch.zeros_like(picked_logit))
    picked = (on_value - off_value) * (logit_label - lse)
    if label_smoothing != 0.0:
        picked = picked + off_value * (logits.sum(dim=-1)
                                       - num_classes * lse)
    mask = mask.float()
    loss = -picked * mask

    if weight > 1.0:
        p_true = torch.exp(logit_label - lse)
        p_class = (on_value - off_value) * p_true + off_value
        w_class = 1.0 / torch.log(weight + (_EULER - weight) * p_class)
        loss = loss * w_class

    # two-phase reduction (losses.py:63-73). A batch with no pixel in
    # the mask (in the AL loop: a tail batch of pseudo-labelled rows of
    # which no pixel clears the threshold) has a loss of 0, where the
    # JAX package's 0 / 0 gives NaN, which the update spreads to every
    # weight; with one pixel or more the divisor is the mask's sum. Under
    # several ranks (parallel.distributed) it is the global batch's mask
    # sum and this is the rank's share of the global loss: the shares sum
    # to it, and so do their gradients
    loss = loss.sum(dim=0)
    total = distributed.all_reduce_sum(mask.sum())
    return (loss / total.clamp(min=1.0)).sum()


def _nearest_resize_2d(x: torch.Tensor, out_hw: Tuple[int, int]
                       ) -> torch.Tensor:
    """TF1-legacy nearest resize of the two trailing dims of ``[B,H,W]``:
    ``src = floor(dst * in/out)`` (the product in float32, as in the JAX
    package)."""
    in_h, in_w = x.shape[1], x.shape[2]
    out_h, out_w = out_hw

    def src(n_out, n_in):
        pos = torch.arange(n_out, dtype=torch.float32, device=x.device)
        return (pos * (n_in / n_out)).long().clamp(max=n_in - 1)

    return x[:, src(out_h, in_h)][:, :, src(out_w, in_w)]


def multiscale_masked_softmax_cross_entropy(
        labels: torch.Tensor, logits_per_scale: Sequence[torch.Tensor],
        mask: torch.Tensor, num_classes: int, weight: float = 0.0,
        label_smoothing: float = 0.0, normalize: bool = False,
        scale_weights: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Sum of the masked CE over heads at decreasing scales
    (``[primary, head_1/2, head_1/4, ...]``); labels and mask are
    nearest-resized to each head. ``scale_weights`` weighs each head's
    term (None: all 1); ``normalize`` averages over the heads."""
    total = 0.0
    for i, logits in enumerate(logits_per_scale):
        if logits.shape[1:3] == labels.shape[1:3]:
            labels_s, mask_s = labels, mask
        else:
            out_hw = (logits.shape[1], logits.shape[2])
            labels_s = _nearest_resize_2d(labels, out_hw)
            mask_s = _nearest_resize_2d(mask, out_hw)
        term = masked_softmax_cross_entropy(labels_s, logits, mask_s,
                                            num_classes, weight,
                                            label_smoothing)
        if scale_weights is not None:
            term = term * scale_weights[i]
        total = total + term
    if normalize:
        total = total / len(logits_per_scale)
    return total


def _regularized(model: nn.Module) -> List[Tuple[nn.Parameter,
                                                            bool]]:
    """``(parameter, is_kernel)`` for every parameter the regulariser
    covers: the kernels of the blocks' convs and transposed convs (the
    multiscale heads are such convs) and of ICNet's classifiers (not
    their biases, as flax names only the kernel ``kernel``) and the
    PReLU alphas, in module order."""
    from ..models.blocks import Conv, ConvTranspose, PReLU
    from ..models.icnet import Conv1x1Bias
    out = []
    for m in model.modules():
        if isinstance(m, (Conv, ConvTranspose, Conv1x1Bias)):
            out.append((m.weight, True))
        elif isinstance(m, PReLU):
            out.append((m.alpha, False))
    return out


def _coefficients(leaves, l1: float, l2: float, glorot_scaling: bool):
    """Each leaf's (L1, L2) coefficient. ``glorot_scaling`` divides a
    kernel's by its initializer's variance ``2/(kh*kw*(cin+cout))``:
    ``l2 / var`` and ``l1 / sqrt(var / 2)``."""
    out = []
    for p, is_kernel in leaves:
        c1, c2 = l1, l2
        if glorot_scaling and is_kernel:
            # [out, in, kh, kw] (conv) or [in, out, kh, kw] (transposed)
            var = 2.0 / (p.shape[2] * p.shape[3] * (p.shape[0] + p.shape[1]))
            c1, c2 = l1 / math.sqrt(var / 2.0), l2 / var
        out.append((c1, c2, p.numel()))
    return out


# model -> {(device, l1, l2, glorot): the per-element L1 and L2
# coefficients on the device}: built once, so a step uploads nothing
_COEF_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def regularization_loss(model: nn.Module, l1: float = 0.0, l2: float = 0.0,
                        glorot_scaling: bool = False) -> torch.Tensor:
    """Keras-style L1/L2 weight regularization over the conv kernels and
    PReLU alphas of ``model`` (batch norm is never regularized), as one
    float32 scalar on the model's device. The covered parameters are
    flattened into one vector and weighed element by element, so the
    penalty is a handful of launches however many layers there are."""
    leaves = _regularized(model)
    device = leaves[0][0].device if leaves else torch.device("cpu")
    if (l1 <= 0.0 and l2 <= 0.0) or not leaves:
        return torch.zeros((), dtype=torch.float32, device=device)
    key = (device, float(l1), float(l2), bool(glorot_scaling))
    per_model = _COEF_CACHE.setdefault(model, {})
    if key not in per_model:
        coefs = _coefficients(leaves, l1, l2, glorot_scaling)
        counts = torch.tensor([n for _, _, n in coefs])

        def expand(i):
            vals = torch.tensor([c[i] for c in coefs], dtype=torch.float32)
            return torch.repeat_interleave(vals, counts).to(device)

        per_model[key] = (expand(0) if l1 > 0.0 else None,
                          expand(1) if l2 > 0.0 else None)
    c1, c2 = per_model[key]
    flat = torch.cat([p.reshape(-1) for p, _ in leaves]).float()
    total = torch.zeros((), dtype=torch.float32, device=device)
    if c1 is not None:
        total = total + (c1 * flat.abs()).sum()
    if c2 is not None:
        total = total + (c2 * flat.square()).sum()
    return total
