"""ICNet heads: fused8 (or CFF2's inputs) -> the per-image mean entropy
confidence (score) or per-pixel labels (predict).

The port of ``fused_head8_entropy_score``, ``fused_head8_predict``,
``fused_cff2_head8_entropy_score`` and ``fused_cff2_head8_predict``
(``ops/pallas_kernels.py:198``, ``:267``, ``:3604`` and ``:3677``); the
CUDA kernels are ``csrc/icnet_head.cu``, two templates that end in one
head device function. Same contracts: ``fused8 [N, H8, W8, 128]``,
``wcls [128, C]``, ``bcls [C]`` -> float32 ``[N]``, the mean over the
``8*H8 x 8*W8`` pixels of ``1 - H(softmax)/log C`` of
``resize4x(classifier(resize2x(fused8)))``, or int8 ``[N, 8*H8, 8*W8]``,
its first-maximum class; and ``fused16 [N, H8/2, W8/2, 128]`` (CFF1's
output) with ``f1 [N, H8, W8, 64]`` -> the same of ``CFF2(fused16,
f1)``. Full-resolution (and 1/4-res) logits never reach memory on the
kernel path.
"""

from __future__ import annotations

from typing import List

import torch

from .. import acquisition
from ...ops import nn as xops
from . import build, packing

MAX_CLASSES = 128  # the kernels' shared-memory logits buffer
MAX_PREDICT_CLASSES = 127  # labels are int8


def pack_classifier(model) -> List[torch.Tensor]:
    """The classifier as ``[wcls [128, C], bcls [C]]``."""
    return [model.Classifier.weight.detach()[:, :, 0, 0].t(),
            model.Classifier.bias.detach()]


def pack_cff2_head(model) -> torch.Tensor:
    """Fold BN into CFF2's low (dilated 3x3) and high (1x1) convs and
    append the classifier (layout of ``csrc/icnet_head.cu``
    ``ssal_cff2_head_score``)."""
    cff2 = model.CFF2
    parts = (packing.affine(packing.hwio(cff2.low.conv), cff2.low.bn)
             + packing.affine(packing.hwio(cff2.high.conv)[0, 0],
                              cff2.high.bn)
             + pack_classifier(model))
    return packing.flat(parts)


def _check_classes(c: int, predict: bool = False) -> None:
    if c > MAX_CLASSES:
        raise ValueError(f"the head kernels take at most {MAX_CLASSES} "
                         f"classes, got {c}")
    if predict and c > MAX_PREDICT_CLASSES:
        raise ValueError(f"int8 labels hold at most {MAX_PREDICT_CLASSES} "
                         f"classes, got {c}")


def head_pre_logits(features8: torch.Tensor, wcls: torch.Tensor,
                    bcls: torch.Tensor) -> torch.Tensor:
    """1/8-res fused features -> 2x upsample -> classifier -> 1/4-res
    logits (float32); ``ICNet.head_pre_logits`` and the plain versions
    below."""
    _, h8, w8, _ = features8.shape
    return (xops.resize_bilinear(features8, (2 * h8, 2 * w8)).float() @ wcls
            + bcls)


def head8_entropy_score_plain(features8: torch.Tensor, wcls: torch.Tensor,
                              bcls: torch.Tensor, num_classes: int
                              ) -> torch.Tensor:
    """The plain PyTorch version: ``head_pre_logits`` ->
    ``acquisition.chunked_upsample_mean_confidence`` (4x upsample and
    the entropy mean over row chunks)."""
    return acquisition.chunked_upsample_mean_confidence(
        head_pre_logits(features8, wcls, bcls), 4, "entropy", num_classes)


def head8_predict_plain(features8: torch.Tensor, wcls: torch.Tensor,
                        bcls: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``head_pre_logits`` -> 4x upsample to
    ``(8*H8, 8*W8)`` -> first-maximum argmax -> int8 (it does
    materialize the full-resolution logits)."""
    _, h8, w8, _ = features8.shape
    logits = xops.resize_bilinear(head_pre_logits(features8, wcls, bcls),
                                  (8 * h8, 8 * w8))
    return logits.argmax(dim=-1).to(torch.int8)


def _head8_checked(features8, wcls, bcls, num_classes, predict):
    """Check the head kernel's inputs; returns its C entry's shape
    arguments ``(n, h8, w8, c)``."""
    c = num_classes
    _check_classes(c, predict)
    build.require(features8, "features8", torch.float32,
                  (None, None, None, 128))
    build.require(wcls, "wcls", torch.float32, (128, c))
    build.require(bcls, "bcls", torch.float32, (c,))
    n, h8, w8, _ = features8.shape
    return n, h8, w8, c


@torch.no_grad()
def fused_head8_predict(features8: torch.Tensor, wcls: torch.Tensor,
                        bcls: torch.Tensor, num_classes: int
                        ) -> torch.Tensor:
    """Labels int8 ``[N, 8*H8, 8*W8]``: the CUDA kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if features8.device.type == "cpu":
        return head8_predict_plain(features8, wcls, bcls)
    n, h8, w8, c = _head8_checked(features8, wcls, bcls, num_classes, True)
    labels = torch.empty((n, 8 * h8, 8 * w8), dtype=torch.int8,
                         device=features8.device)
    with torch.cuda.device(features8.device):
        build.check(build.library().ssal_head8_predict(
            build.ptr(features8), build.ptr(wcls), build.ptr(bcls),
            build.ptr(labels), n, h8, w8, c, build.stream_of(features8)),
            "head8 predict kernel")
    fused_head8_predict.launches += 1
    return labels


fused_head8_predict.launches = 0


@torch.no_grad()
def fused_head8_entropy_score(features8: torch.Tensor, wcls: torch.Tensor,
                              bcls: torch.Tensor, num_classes: int
                              ) -> torch.Tensor:
    """Per-image mean entropy confidence float32 ``[N]``: the CUDA kernel
    on CUDA tensors, the plain version on CPU tensors."""
    if features8.device.type == "cpu":
        return head8_entropy_score_plain(features8, wcls, bcls, num_classes)
    n, h8, w8, c = _head8_checked(features8, wcls, bcls, num_classes, False)
    lib = build.library()
    partials = torch.empty((n, lib.ssal_head8_partials(h8, w8)),
                           device=features8.device)
    with torch.cuda.device(features8.device):
        build.check(lib.ssal_head8_score(build.ptr(features8),
                                         build.ptr(wcls), build.ptr(bcls),
                                         build.ptr(partials), n, h8, w8, c,
                                         build.stream_of(features8)),
                    "head8 score kernel")
    fused_head8_entropy_score.launches += 1
    return partials.sum(dim=1) / float(64 * h8 * w8)


fused_head8_entropy_score.launches = 0


def cff2_head8_entropy_score_plain(fused16: torch.Tensor, f1: torch.Tensor,
                                   model) -> torch.Tensor:
    """The plain PyTorch version: the model's CFF2, then the head's."""
    wcls, bcls = pack_classifier(model)
    return head8_entropy_score_plain(model.CFF2(fused16, f1)[0], wcls, bcls,
                                     model.num_classes)


def cff2_head8_predict_plain(fused16: torch.Tensor, f1: torch.Tensor,
                             model) -> torch.Tensor:
    """The plain PyTorch version: the model's CFF2, then the head's."""
    return head8_predict_plain(model.CFF2(fused16, f1)[0],
                               *pack_classifier(model))


def _cff2_checked(fused16, f1, model, predict):
    """Check the CFF2 + head kernel's inputs; returns its weight pack
    and its C entry's shape arguments ``(n, h8, w8, c)``."""
    c = model.num_classes
    _check_classes(c, predict)
    build.require(fused16, "fused16", torch.float32, (None, None, None, 128))
    n, h16, w16, _ = fused16.shape
    build.require(f1, "f1", torch.float32, (n, 2 * h16, 2 * w16, 64))
    pack = model.packed("cff2_head", fused16.device, pack_cff2_head)
    build.require_pack(pack, build.library().ssal_cff2_head_pack_size(c),
                       "cff2 head")
    return pack, (n, 2 * h16, 2 * w16, c)


@torch.no_grad()
def fused_cff2_head8_predict(fused16: torch.Tensor, f1: torch.Tensor,
                             model) -> torch.Tensor:
    """Labels int8 ``[N, 8*H8, 8*W8]`` of CFF2 + the head: the CUDA
    kernel on CUDA tensors (fused8 stays on chip), the plain version on
    CPU tensors."""
    if fused16.device.type == "cpu":
        return cff2_head8_predict_plain(fused16, f1, model)
    pack, (n, h8, w8, c) = _cff2_checked(fused16, f1, model, True)
    labels = torch.empty((n, 8 * h8, 8 * w8), dtype=torch.int8,
                         device=fused16.device)
    with torch.cuda.device(fused16.device):
        build.check(build.library().ssal_cff2_head_predict(
            build.ptr(fused16), build.ptr(f1), build.ptr(pack),
            build.ptr(labels), n, h8, w8, c, build.stream_of(fused16)),
            "cff2 head predict kernel")
    fused_cff2_head8_predict.launches += 1
    return labels


fused_cff2_head8_predict.launches = 0


@torch.no_grad()
def fused_cff2_head8_entropy_score(fused16: torch.Tensor, f1: torch.Tensor,
                                   model) -> torch.Tensor:
    """Per-image mean entropy confidence float32 ``[N]`` of CFF2 + the
    head: the CUDA kernel on CUDA tensors (fused8 stays on chip), the
    plain version on CPU tensors."""
    if fused16.device.type == "cpu":
        return cff2_head8_entropy_score_plain(fused16, f1, model)
    pack, (n, h8, w8, c) = _cff2_checked(fused16, f1, model, False)
    lib = build.library()
    partials = torch.empty((n, lib.ssal_head8_partials(h8, w8)),
                           device=fused16.device)
    with torch.cuda.device(fused16.device):
        build.check(lib.ssal_cff2_head_score(build.ptr(fused16), build.ptr(f1),
                                             build.ptr(pack),
                                             build.ptr(partials), n, h8, w8,
                                             c, build.stream_of(fused16)),
                    "cff2 head score kernel")
    fused_cff2_head8_entropy_score.launches += 1
    return partials.sum(dim=1) / float(64 * h8 * w8)


fused_cff2_head8_entropy_score.launches = 0
