"""ENet tail: (stage-3 features, B2_0 switches, B1_0 mask) ->
per-pixel labels (predict) or the per-image mean entropy confidence
(score).

The port of ``fused_tail_predict`` and ``fused_tail_entropy_score``
(``ops/pallas_kernels.py:2810`` and ``:2720``, one body); the CUDA
kernel is ``csrc/tail.cu``, one template for both. Same contracts:
``y [N, H8, W8, 128]`` float32, ``sw2`` int8 ``[N, H8, W8, 64]``,
``mask1 [N, 2*H8, 2*W8, 64]`` float32 one-hot -> int8 labels
``[N, 8*H8, 8*W8]``, the first maximum of the class logits, or float32
``[N]``, the mean over pixels of ``1 - H(softmax)/log C``.
Full-resolution logits never reach memory on the kernel path.
"""

from __future__ import annotations

import torch

from .. import acquisition
from . import build, packing

MAX_CLASSES = 127  # labels are int8


def pack_tail(model) -> torch.Tensor:
    """Fold BN into B4_0, B4_1, B4_2, B5_0, B5_1 and append the Final
    kernel (layout of ``csrc/tail.cu`` ``ssal_tail_predict`` and
    ``ssal_tail_score``)."""
    parts = packing.upsample(model.Bottleneck4_0)
    for blk in model.blocks(model.stage4):
        parts += packing.bottleneck(blk)
    return packing.flat(parts + packing.stage5(model))


def mask_to_switches(mask1: torch.Tensor) -> torch.Tensor:
    """The one-hot mask ``[N, h, w, 64]`` -> int8 switches
    ``[N, h, w*16]`` (the inverse of ``front.switches_to_mask``)."""
    n, h, w, _ = mask1.shape
    return (mask1.reshape(n, h, w, 4, 16).argmax(dim=3)
            .to(torch.int8).reshape(n, h, w * 16))


def tail_predict_plain(y: torch.Tensor, sw2: torch.Tensor,
                       mask1: torch.Tensor, model) -> torch.Tensor:
    """The plain PyTorch version, from the model's own blocks (it does
    materialize the full-resolution logits)."""
    n, h8, w8, _ = y.shape
    logits = model.forward_tail(y, sw2.reshape(n, h8, w8 * 64),
                                mask_to_switches(mask1))
    return logits.argmax(dim=-1).to(torch.int8)


def fused_tail_predict(y: torch.Tensor, sw2: torch.Tensor,
                       mask1: torch.Tensor, model) -> torch.Tensor:
    """Labels int8 ``[N, H, W]``: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if y.device.type == "cpu":
        return tail_predict_plain(y, sw2, mask1, model)
    build.require(y, "y", torch.float32, (None, None, None, 128))
    n, h8, w8, _ = y.shape
    build.require(sw2, "sw2", torch.int8, (n, h8, w8, 64))
    build.require(mask1, "mask1", torch.float32, (n, 2 * h8, 2 * w8, 64))
    c = model.num_classes
    if c > MAX_CLASSES:
        raise ValueError(f"int8 labels hold at most {MAX_CLASSES} "
                         f"classes, got {c}")
    lib = build.library()
    pack = model.packed("tail", y.device, pack_tail)
    build.require_pack(pack, lib.ssal_tail_pack_size(c), "tail")
    labels = torch.empty((n, 8 * h8, 8 * w8), dtype=torch.int8,
                         device=y.device)
    with torch.cuda.device(y.device):
        build.check(lib.ssal_tail_predict(build.ptr(y), build.ptr(sw2),
                                          build.ptr(mask1), build.ptr(pack),
                                          build.ptr(labels), n, h8, w8, c,
                                          build.stream_of(y)),
                    "tail predict kernel")
    fused_tail_predict.launches += 1
    return labels


fused_tail_predict.launches = 0


def tail_score_plain(y: torch.Tensor, sw2: torch.Tensor,
                     mask1: torch.Tensor, model) -> torch.Tensor:
    """The plain PyTorch version of the score, from the model's own
    blocks and ``acquisition.mean_confidence`` (it materializes the
    full-resolution logits)."""
    n, h8, w8, _ = y.shape
    logits = model.forward_tail(y, sw2.reshape(n, h8, w8 * 64),
                                mask_to_switches(mask1))
    return acquisition.mean_confidence(logits, "entropy", model.num_classes)


@torch.no_grad()
def fused_tail_entropy_score(y: torch.Tensor, sw2: torch.Tensor,
                             mask1: torch.Tensor, model) -> torch.Tensor:
    """Per-image mean entropy confidence float32 ``[N]``: the CUDA
    kernel on CUDA tensors, the plain version on CPU tensors. The
    kernel writes one partial sum per block; their sum over the pixel
    count is the JAX wrapper's ``sum(partial_sums, 1) / pixels``."""
    if y.device.type == "cpu":
        return tail_score_plain(y, sw2, mask1, model)
    build.require(y, "y", torch.float32, (None, None, None, 128))
    n, h8, w8, _ = y.shape
    build.require(sw2, "sw2", torch.int8, (n, h8, w8, 64))
    build.require(mask1, "mask1", torch.float32, (n, 2 * h8, 2 * w8, 64))
    c = model.num_classes
    lib = build.library()
    pack = model.packed("tail", y.device, pack_tail)
    build.require_pack(pack, lib.ssal_tail_pack_size(c), "tail")
    partials = torch.empty((n, lib.ssal_tail_partials(h8, w8)),
                           device=y.device)
    with torch.cuda.device(y.device):
        build.check(lib.ssal_tail_score(build.ptr(y), build.ptr(sw2),
                                        build.ptr(mask1), build.ptr(pack),
                                        build.ptr(partials), n, h8, w8, c,
                                        build.stream_of(y)),
                    "tail score kernel")
    fused_tail_entropy_score.launches += 1
    return partials.sum(dim=1) / float(64 * h8 * w8)


fused_tail_entropy_score.launches = 0
