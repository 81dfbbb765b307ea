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
kernel path, nor does fused8 on the CFF2 + head path.

The CFF2 + head kernel runs CFF2 on the tensor cores at the precision
of its route (:data:`PRECISION`), from two GEMM records
(:func:`pack_cff2_head`); both kernels run the classifier on the tensor
cores in 3xTF32 (:data:`CLASSIFIER_PRECISION`), the head kernel from
``wcls`` staged at that record's stride; both heads' upsample and
entropy or argmax are fp32 on the CUDA cores.
"""

from __future__ import annotations

from typing import List

import torch

from .. import acquisition
from ...ops import nn as xops
from . import build, packing

MAX_CLASSES = 128  # the kernels' shared-memory logits buffer
MAX_PREDICT_CLASSES = 127  # labels are int8
# The tensor-core precision of CFF2's products on the CFF2 + head
# kernel's routes (csrc/icnet_head.cu kPredictPasses, kScorePasses), as
# the ENet kernels': 3xTF32 (hi/lo split of both operands) for labels,
# TF32 for scores, the weights as hi + lo in two passes (one pass's
# rounding of the weights shifted an image's score by 1.29e-4 at
# chip_smoke.py --seed 3, PERF.md); each is held one precision below by
# chip_smoke.py's PRECISION_GATE on fused8. The classifier's products
# are 3xTF32 on both routes: one pass shifts every logit alike and took
# the error of a score from 5.9e-5 to 9.8e-5 of the 1e-4 tolerance,
# measured on the H100 by tools/probe_cff2.py (PERF.md).
PRECISION = {"predict": "3xTF32", "score": "TF32"}
# The classifier's products in both kernels on both routes
# (csrc/icnet_head.cu kClassifierPasses, classify())
CLASSIFIER_PRECISION = "3xTF32"
KMAIN = 9 * 128 + 64  # the CFF2 record's k rows: the dilated taps, f1


def pack_classifier(model) -> List[torch.Tensor]:
    """The classifier as ``[wcls [128, C], bcls [C]]``."""
    return [model.Classifier.weight.detach()[:, :, 0, 0].t(),
            model.Classifier.bias.detach()]


def pack_cff2_head(model) -> torch.Tensor:
    """CFF2 + the classifier as two GEMM records (``csrc/icnet_head.cu``
    ``ssal_cff2_head_pack_size``): BN folded into the low (dilated 3x3)
    and high (1x1) convs, their weights stacked as ``[kc (9 taps x 128,
    tap-major) ; kh (64)]`` ``[1216, 128]`` with the one bias ``bc +
    bh``, since the two are summed before the ReLU; then ``wcls [128,
    C]`` with ``bcls``, C padded to 8s."""
    cff2 = model.CFF2
    kc, bc = packing.affine(packing.hwio(cff2.low.conv), cff2.low.bn)
    kh, bh = packing.affine(packing.hwio(cff2.high.conv)[0, 0],
                            cff2.high.bn)
    wcls, bcls = pack_classifier(model)
    c = wcls.shape[1]
    w = torch.cat([kc.reshape(9 * 128, 128), kh])
    return packing.flat(
        packing.gemm_record(w[None], KMAIN, 128, [bc + bh])
        + packing.gemm_record(wcls[None], 128, -(-c // 8) * 8, [bcls]))


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
    logits in the classifier's dtype (float32; float64 for a model in
    float64); ``ICNet.head_pre_logits`` and the plain versions below."""
    _, h8, w8, _ = features8.shape
    up = xops.resize_bilinear(features8, (2 * h8, 2 * w8))
    return up.to(wcls.dtype) @ wcls + bcls


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


def launch_cff2(kind: str, fused16: torch.Tensor, f1: torch.Tensor,
                model) -> torch.Tensor:
    """One launch of the CFF2 + head kernel on CUDA tensors, uncounted
    (the wrappers below count theirs): ``kind`` "score" (the per-block
    partial sums ``[N, blocks]``), "predict" (labels) or "fused8_score"
    / "fused8_predict" (the GEMM alone at that route's precision, for
    the precision gate and ``tools/probe_cff2.py``'s split: fused8
    ``[N, H8, W8, 128]``)."""
    pack, (n, h8, w8, c) = _cff2_checked(fused16, f1, model,
                                         kind == "predict")
    lib = build.library()
    dev = fused16.device
    args = (build.ptr(fused16), build.ptr(f1), build.ptr(pack))
    tail = (n, h8, w8, c)
    with torch.cuda.device(dev):
        stream = build.stream_of(fused16)
        if kind == "score":
            out = torch.empty((n, lib.ssal_cff2_head_partials(h8, w8)),
                              device=dev)
            status = lib.ssal_cff2_head_score(*args, build.ptr(out), *tail,
                                              stream)
        elif kind == "predict":
            out = torch.empty((n, 8 * h8, 8 * w8), dtype=torch.int8,
                              device=dev)
            status = lib.ssal_cff2_head_predict(*args, build.ptr(out), *tail,
                                                stream)
        else:
            out = torch.empty((n, h8, w8, 128), device=dev)
            status = lib.ssal_cff2_fused8(*args, build.ptr(out), *tail,
                                          int(kind == "fused8_score"),
                                          stream)
        build.check(status, f"cff2 head {kind} kernel")
    return out


@torch.no_grad()
def fused_cff2_head8_predict(fused16: torch.Tensor, f1: torch.Tensor,
                             model) -> torch.Tensor:
    """Labels int8 ``[N, 8*H8, 8*W8]`` of CFF2 + the head: the CUDA
    kernel on CUDA tensors (3xTF32 products, fused8 stays on chip), the
    plain version on CPU tensors."""
    if fused16.device.type == "cpu":
        return cff2_head8_predict_plain(fused16, f1, model)
    labels = launch_cff2("predict", fused16, f1, model)
    fused_cff2_head8_predict.launches += 1
    return labels


fused_cff2_head8_predict.launches = 0


@torch.no_grad()
def fused_cff2_head8_entropy_score(fused16: torch.Tensor, f1: torch.Tensor,
                                   model) -> torch.Tensor:
    """Per-image mean entropy confidence float32 ``[N]`` of CFF2 + the
    head: the CUDA kernel on CUDA tensors (one TF32 pass, fused8 stays
    on chip), the plain version on CPU tensors."""
    if fused16.device.type == "cpu":
        return cff2_head8_entropy_score_plain(fused16, f1, model)
    partials = launch_cff2("score", fused16, f1, model)
    fused_cff2_head8_entropy_score.launches += 1
    _, h16, w16, _ = fused16.shape
    return partials.sum(dim=1) / float(64 * 4 * h16 * w16)


fused_cff2_head8_entropy_score.launches = 0
