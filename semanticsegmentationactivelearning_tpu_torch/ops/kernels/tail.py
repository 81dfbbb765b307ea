"""ENet tail: (stage-3 features, B2_0 switches, B1_0 mask) ->
per-pixel labels (predict) or the per-image mean entropy confidence
(score).

The port of ``fused_tail_predict`` and ``fused_tail_entropy_score``
(``ops/pallas_kernels.py:2810`` and ``:2720``, one body); the CUDA
kernels are ``csrc/tail.cu``. Same contracts: ``y [N, H8, W8, 128]``
float32, ``sw2`` int8 ``[N, H8, W8, 64]``, ``mask1 [N, 2*H8, 2*W8, 64]``
float32 one-hot -> int8 labels ``[N, 8*H8, 8*W8]``, the first maximum of
the class logits, or float32 ``[N]``, the mean over pixels of
``1 - H(softmax)/log C``. Each call is :data:`LAUNCHES_PER_CALL`
launches: stage 4 (``tail4_kernel``) writes the stage-4 features ``x4
[N, 2*H8, 2*W8, 64]``, the one intermediate that reaches memory, and
``tail5_kernel`` computes stage 5, the Final and the argmax or the
entropy from it. Half-resolution activations and full-resolution logits
never reach memory on the kernel path.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .. import acquisition
from . import build, packing
from .packing import bstride, conv_taps, gemm_record

MAX_CLASSES = 127  # labels are int8
LAUNCHES_PER_CALL = 2
# The tensor-core precision of each route (csrc/tail.cu kPredictPasses,
# kScorePasses): 3xTF32 (hi/lo split of both operands, about fp32's
# accuracy) for labels, one TF32 pass for scores. One pass moves a few
# decided labels of a 1024x2048 batch (fails the label gate) but keeps
# the scores within 2e-5 of fp32's (the gate is 1e-4), measured on the
# H100 by chip_smoke.py (PERF.md). The score route's Final takes its
# weights as hi + lo in two passes (kFinalScorePasses): one pass's
# rounding of a saturated Final's weights shifts every pixel's
# confidence alike, 3.3e-4 an image at its kernel x1000 (PERF.md).
PRECISION = {"predict": "3xTF32", "score": "TF32"}
# half-res positions a side of the score kernels' tile (csrc/tail.cu T5;
# deconv_score_kernel's DECONV_ROWS x T5): 32x32 pixels, one partial sum
# of confidences each
T5 = 16

# The taps (kh, kw) of the JAX transposed-conv kernel k[kh][kw][in][out]
# that each output phase (2a + b) uses, in the kernels' order: row
# (tr, kh) = (0, 2), (1, 0) for even rows, (0, 1) for odd ones, the same
# for columns; tap (tr, tc) reads the coarse position (i - tr, j - tc).
PHASE_TAPS = (((2, 2), (2, 0), (0, 2), (0, 0)), ((2, 1), (0, 1)),
              ((1, 2), (1, 0)), ((1, 1),))

# (taps, k, n, vectors) of each GEMM record of the pack, in order
# (csrc/tail.cu tail_layout); the Final's n is final_cp(classes)
_RECORDS = ((1, 128, 32, 2), (1, 128, 64, 0), (9, 32, 16, 2),
            (1, 16, 64, 2),                                  # B4_0
            (1, 64, 16, 2), (9, 16, 16, 2), (1, 16, 64, 2),  # B4_1
            (1, 64, 16, 2), (9, 16, 16, 2), (1, 16, 64, 2),  # B4_2
            (1, 64, 16, 2), (1, 64, 16, 0), (9, 16, 8, 2),
            (1, 8, 16, 2),                                   # B5_0
            (1, 16, 8, 2), (1, 40, 8, 2), (1, 8, 16, 2))     # B5_1
# the first record that tail5_kernel reads, B5_0's projection (csrc/
# tail.cu T5_FIRST): it reads the pack from there to its end
T5_FIRST = 10


def final_cp(c: int) -> int:
    """The Final's class count padded to whole chunks of n-tiles (1-4
    tiles of 8 classes a chunk)."""
    ntf = 1 if c <= 8 else 2 if c <= 16 else 3 if c <= 24 else 4
    nt = (c + 7) // 8
    return 8 * ntf * -(-nt // ntf)


def tail_layout(c: int) -> List[Tuple[int, int, int, int, int, int]]:
    """``(offset, taps, k, n, stride, vectors)`` of each record of the
    pack for ``c`` classes."""
    out, off = [], 0
    for taps, k, n, nv in _RECORDS + ((9, 16, final_cp(c), 0),):
        s = bstride(n)
        out.append((off, taps, k, n, s, nv))
        off += taps * k * s + nv * n
    return out


def phase_taps(k: torch.Tensor) -> torch.Tensor:
    """A transposed conv's JAX kernel ``[3, 3, in, out]`` as its nine
    taps ``[9, in, out]`` grouped by output phase (:data:`PHASE_TAPS`)."""
    return torch.stack([k[kh, kw] for taps in PHASE_TAPS
                        for kh, kw in taps])


def final_size(c: int) -> int:
    """Floats of the Final's record for ``c`` classes (:func:`pack_final`,
    the last record of :func:`tail_layout`)."""
    return 9 * 16 * bstride(final_cp(c))


def pack_final(kernel: torch.Tensor, c: int) -> torch.Tensor:
    """The Final's GEMM record (``csrc/tail.cu`` FIN) of its flax kernel
    ``[3, 3, 16, C]``: the nine taps by phase, ``[9, 16,
    bstride(final_cp(c))]`` flat, on the kernel's device. The tail pack
    holds the same bits; the deconv score kernel reads it alone."""
    return packing.flat(gemm_record(phase_taps(kernel), 16, final_cp(c)))


def _upsample(blk, fo: int) -> List[torch.Tensor]:
    """A ``BottleneckUpsample``'s four records: projection, residual 1x1
    conv, transposed conv by phase, expand (+ the residual PReLU)."""
    w, v = conv_taps(blk.proj_conv, blk.proj_bn, blk.proj_prelu)
    parts = gemm_record(w, w.shape[1], w.shape[2], v)
    res = packing.hwio(blk.res_conv)
    parts += gemm_record(res.reshape(1, *res.shape[2:]), res.shape[2],
                     res.shape[3])
    d, *v = packing.affine(packing.deconv_hwio(blk.deconv), blk.conv_bn,
                           blk.conv_prelu)
    parts += gemm_record(phase_taps(d), d.shape[2], fo, v)
    w, (t,) = conv_taps(blk.exp_conv, blk.exp_bn)
    return parts + gemm_record(w, 8 * -(-w.shape[1] // 8), w.shape[2],
                           (t, blk.res_prelu.alpha))


def _bottleneck(blk, k_conv: int, n_small: int) -> List[torch.Tensor]:
    """A plain ``Bottleneck``'s three records; its 3x3 conv is nine taps
    (64-channel blocks) or one K = 9 x 4 record (B5_1, ``k_conv`` 40)."""
    w, v = conv_taps(blk.proj_conv, blk.proj_bn, blk.proj_prelu)
    parts = gemm_record(w, w.shape[1], n_small, v)
    w, v = conv_taps(blk.conv, blk.conv_bn, blk.conv_prelu)
    if k_conv != w.shape[1]:
        w = w.reshape(1, -1, w.shape[2])
    parts += gemm_record(w, k_conv, n_small, v)
    w, (t,) = conv_taps(blk.exp_conv, blk.exp_bn)
    return parts + gemm_record(w, 8 * -(-w.shape[1] // 8), w.shape[2],
                           (t, blk.res_prelu.alpha))


def pack_tail(model) -> torch.Tensor:
    """Fold BN into B4_0, B4_1, B4_2, B5_0, B5_1 and lay them and the
    Final out as ``csrc/tail.cu``'s GEMM records (:func:`tail_layout`)."""
    parts = _upsample(model.Bottleneck4_0, 16)
    for blk in model.blocks(model.stage4):
        parts += _bottleneck(blk, 16, 16)
    parts += _upsample(model.Bottleneck5_0, 8)
    parts += _bottleneck(model.Bottleneck5_1, 40, 8)
    parts.append(pack_final(packing.deconv_hwio(model.Final.deconv),
                            model.num_classes))
    return packing.flat(parts)


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


def tail_score_plain(y: torch.Tensor, sw2: torch.Tensor,
                     mask1: torch.Tensor, model) -> torch.Tensor:
    """The plain PyTorch version of the score, from the model's own
    blocks and ``acquisition.mean_confidence`` (it materializes the
    full-resolution logits)."""
    n, h8, w8, _ = y.shape
    logits = model.forward_tail(y, sw2.reshape(n, h8, w8 * 64),
                                mask_to_switches(mask1))
    return acquisition.mean_confidence(logits, "entropy", model.num_classes)


def _require_inputs(y, sw2, mask1=None):
    build.require(y, "y", torch.float32, (None, None, None, 128))
    n, h8, w8, _ = y.shape
    build.require(sw2, "sw2", torch.int8, (n, h8, w8, 64))
    if mask1 is not None:
        build.require(mask1, "mask1", torch.float32, (n, 2 * h8, 2 * w8, 64))
    return n, h8, w8


def _pack(model, device):
    lib = build.library()
    pack = model.packed("tail", device, pack_tail)
    build.require_pack(pack, lib.ssal_tail_pack_size(model.num_classes),
                       "tail")
    return lib, pack


def _stage4(y, sw2, model, score: bool) -> torch.Tensor:
    """Launch ``tail4_kernel`` at the precision of the score or the
    predict route (counted by the caller)."""
    n, h8, w8 = _require_inputs(y, sw2)
    lib, pack = _pack(model, y.device)
    x4 = torch.empty((n, 2 * h8, 2 * w8, 64), device=y.device)
    with torch.cuda.device(y.device):
        build.check(lib.ssal_tail_stage4(build.ptr(y), build.ptr(sw2),
                                         build.ptr(pack), build.ptr(x4), n,
                                         h8, w8, int(score),
                                         build.stream_of(y)),
                    "tail stage-4 kernel")
    return x4


@torch.no_grad()
def fused_tail_stage4(y: torch.Tensor, sw2: torch.Tensor, model,
                      score: bool = False) -> torch.Tensor:
    """Stage 4, ``x4 [N, 2*H8, 2*W8, 64]``: ``tail4_kernel`` on CUDA
    tensors, at the score route's precision with ``score`` (else the
    predict route's), ``model.forward_stage4`` on CPU tensors."""
    if y.device.type == "cpu":
        n, h8, w8, _ = y.shape
        return model.forward_stage4(y, sw2.reshape(n, h8, w8 * 64))
    x4 = _stage4(y, sw2, model, score)
    fused_tail_stage4.launches += 1
    return x4


fused_tail_stage4.launches = 0


def decode_plain(x4: torch.Tensor, mask1: torch.Tensor, model,
                 score: bool) -> torch.Tensor:
    """The plain version of :func:`fused_tail_decode`."""
    logits = model.Final(model.decode_from_stage4(x4,
                                                  mask_to_switches(mask1)))
    if score:
        return acquisition.mean_confidence(logits, "entropy",
                                           model.num_classes)
    return logits.argmax(dim=-1).to(torch.int8)


def tile_sums(conf: torch.Tensor) -> torch.Tensor:
    """Per-pixel confidences ``[N, H, W]`` summed over the score kernels'
    tiles (:data:`T5`), ``[N, tiles]`` with the tiles row by row, as the
    kernels write their partial sums (partial tiles at the bottom and
    right sum the pixels they hold)."""
    t = 2 * T5
    n, h, w = conf.shape
    conf = torch.nn.functional.pad(conf, (0, -w % t, 0, -h % t))
    return conf.reshape(n, conf.shape[1] // t, t, conf.shape[2] // t,
                        t).sum((2, 4)).reshape(n, -1)


def decode_partials_plain(x4: torch.Tensor, mask1: torch.Tensor,
                          model) -> torch.Tensor:
    """The plain version of :func:`launch_decode`'s partial sums."""
    logits = model.Final(model.decode_from_stage4(x4,
                                                  mask_to_switches(mask1)))
    return tile_sums(acquisition.confidence_map(logits, "entropy",
                                                model.num_classes))


def partials_mean(partials: torch.Tensor, pixels: int) -> torch.Tensor:
    """Per-image scores from a score kernel's partial sums: the JAX
    wrappers' ``sum(partial_sums, 1) / pixels``."""
    return partials.sum(dim=1) / float(pixels)


def launch_decode(x4, mask1, model, score: bool) -> torch.Tensor:
    """Launch ``tail5_kernel`` on CUDA tensors, uncounted (the callers
    count theirs: :func:`fused_tail_decode`, the tail's wrappers and
    ``decoder.fused_decoder_entropy_score``). With ``score`` it returns
    the kernel's partial sums of confidences, one a tile (as
    :func:`tile_sums`), for :func:`partials_mean`."""
    build.require(x4, "x4", torch.float32, (None, None, None, 64))
    n, hq, wq, _ = x4.shape
    build.require(mask1, "mask1", torch.float32, (n, hq, wq, 64))
    if hq % 2 or wq % 2:
        raise ValueError(f"x4 must have an even height and width, got "
                         f"{tuple(x4.shape)}")
    c = model.num_classes
    if not score and c > MAX_CLASSES:
        raise ValueError(f"int8 labels hold at most {MAX_CLASSES} "
                         f"classes, got {c}")
    lib, pack = _pack(model, x4.device)
    h8, w8 = hq // 2, wq // 2
    with torch.cuda.device(x4.device):
        if score:
            out = torch.empty((n, lib.ssal_tail_partials(h8, w8)),
                              device=x4.device)
            status = lib.ssal_tail_decode_score(
                build.ptr(x4), build.ptr(mask1), build.ptr(pack),
                build.ptr(out), n, h8, w8, c, build.stream_of(x4))
        else:
            out = torch.empty((n, 8 * h8, 8 * w8), dtype=torch.int8,
                              device=x4.device)
            status = lib.ssal_tail_decode_predict(
                build.ptr(x4), build.ptr(mask1), build.ptr(pack),
                build.ptr(out), n, h8, w8, c, build.stream_of(x4))
    build.check(status, "tail stage-5 kernel")
    return out


@torch.no_grad()
def fused_tail_decode(x4: torch.Tensor, mask1: torch.Tensor, model,
                      score: bool) -> torch.Tensor:
    """Stage 5 + Final from ``x4``: int8 labels ``[N, 4*Hq, 4*Wq]`` or,
    with ``score``, the float32 ``[N]`` mean entropy confidences, each
    at its route's precision; ``tail5_kernel`` on CUDA tensors,
    :func:`decode_plain` on CPU tensors."""
    if x4.device.type == "cpu":
        return decode_plain(x4, mask1, model, score)
    out = launch_decode(x4, mask1, model, score)
    fused_tail_decode.launches += 1
    return partials_mean(out, 16 * x4.shape[1] * x4.shape[2]) if score \
        else out


fused_tail_decode.launches = 0


@torch.no_grad()
def fused_tail_predict(y: torch.Tensor, sw2: torch.Tensor,
                       mask1: torch.Tensor, model) -> torch.Tensor:
    """Labels int8 ``[N, H, W]``: the two CUDA kernels on CUDA tensors,
    the plain version on CPU tensors."""
    if y.device.type == "cpu":
        return tail_predict_plain(y, sw2, mask1, model)
    _require_inputs(y, sw2, mask1)
    if model.num_classes > MAX_CLASSES:
        raise ValueError(f"int8 labels hold at most {MAX_CLASSES} "
                         f"classes, got {model.num_classes}")
    x4 = _stage4(y, sw2, model, False)
    fused_tail_predict.launches += 1
    labels = launch_decode(x4, mask1, model, False)
    fused_tail_predict.launches += 1
    return labels


fused_tail_predict.launches = 0


@torch.no_grad()
def fused_tail_entropy_score(y: torch.Tensor, sw2: torch.Tensor,
                             mask1: torch.Tensor, model) -> torch.Tensor:
    """Per-image mean entropy confidence float32 ``[N]``: the two CUDA
    kernels on CUDA tensors, the plain version on CPU tensors."""
    if y.device.type == "cpu":
        return tail_score_plain(y, sw2, mask1, model)
    _require_inputs(y, sw2, mask1)
    x4 = _stage4(y, sw2, model, True)
    fused_tail_entropy_score.launches += 1
    parts = launch_decode(x4, mask1, model, True)
    fused_tail_entropy_score.launches += 1
    return partials_mean(parts, 16 * x4.shape[1] * x4.shape[2])


fused_tail_entropy_score.launches = 0
