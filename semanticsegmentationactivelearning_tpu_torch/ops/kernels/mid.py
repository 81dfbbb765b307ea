"""ENet mid section: stage-1 features -> (stage-3 features, B2_0
switches).

The port of ``fused_mid_stage23_w`` / ``fused_mid_stage23``
(``ops/pallas_kernels.py:2184`` / ``:1808``); the CUDA kernels are in
``csrc/mid.cu``. Same contract: ``x1 [N, Hq, Wq, 64]`` float32 ->
``y [N, Hq/2, Wq/2, 128]`` float32 and ``sw2`` int8
``[N, Hq/2, Wq/2, 64]`` (window positions 0..3).

The TPU kernel keeps a whole image in VMEM; on the GPU each bottleneck
is its own launch and the activations between them go through device
memory. B2_0 is one launch (``b20_kernel``); a stage-2/3 bottleneck is
one launch with its projection fused (the asymmetric ones and those of
dilation <= :data:`FUSE_MAX_DILATION`), else two (``proj_kernel``, then
``block_kernel`` reading the 32-channel projection tap by tap):
:data:`LAUNCHES_PER_CALL` in all. Every product runs on the tensor cores
at the precision of the caller's route (:data:`PRECISION`).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ...models.enet import DILATED_SPEC
from . import build, packing
from .packing import bstride, conv_taps, gemm_record, vec4_order

# The tensor-core precision of each route (csrc/mid.cu kPredictPasses,
# kScorePasses), as the tail's: 3xTF32 (hi/lo split of both operands,
# about fp32's accuracy) for labels, one TF32 pass for scores.
PRECISION = {"predict": "3xTF32", "score": "TF32"}
# The dilated blocks up to this dilation compute their projection over
# the tile and its halo themselves; the larger ones read it from a
# separate launch (csrc/mid.cu MAX_FUSED_HALO: at most 4).
# Chosen by tools/probe_mid.py's split on the H100: at dilation 4 the
# fused block still runs slightly faster than projection + block
# (PERF.md).
FUSE_MAX_DILATION = 4


def fused(dilation: int, asymmetric: bool) -> bool:
    """Whether a stage-2/3 block runs with its projection fused."""
    return asymmetric or dilation <= FUSE_MAX_DILATION


LAUNCHES_PER_CALL = 1 + 2 * sum(1 if fused(d, a) else 2
                                for d, a in DILATED_SPEC)

# (taps, k, n, vectors) of each GEMM record of a pack (csrc/mid.cu
# mid_layout): B2_0, a dilated block, an asymmetric block
KINDS = {"b20": ((4, 64, 32, 2), (9, 32, 32, 2), (1, 32, 128, 2)),
         "dilated": ((1, 128, 32, 2), (9, 32, 32, 2), (1, 32, 128, 2)),
         "asymmetric": ((1, 128, 32, 2), (5, 32, 32, 0), (5, 32, 32, 2),
                        (1, 32, 128, 2))}
KIND_ID = {"b20": 0, "dilated": 1, "asymmetric": 2}


def mid_layout(kind: str) -> List[Tuple[int, int, int, int, int, int]]:
    """``(offset, taps, k, n, stride, vectors)`` of each record of a
    pack of ``kind``."""
    out, off = [], 0
    for taps, k, n, nv in KINDS[kind]:
        s = bstride(n)
        out.append((off, taps, k, n, s, nv))
        off += taps * k * s + nv * n
    return out


def block_kind(blk) -> str:
    return "asymmetric" if blk.asymmetric else "dilated"


def _expand(blk) -> List[torch.Tensor]:
    w, (t,) = conv_taps(blk.exp_conv, blk.exp_bn)
    return gemm_record(w, 32, 128, (t, blk.res_prelu.alpha))


def _projection(blk) -> List[torch.Tensor]:
    """PROJ, its k rows in the order of the kernels' 16-byte reads of x
    (:func:`packing.vec4_order` within each tap)."""
    w, v = conv_taps(blk.proj_conv, blk.proj_bn, blk.proj_prelu)
    k = w.shape[1]
    return gemm_record(w[:, vec4_order(k)], k, 32, v)


def pack_block(blk) -> torch.Tensor:
    """A stage-2/3 bottleneck's BN-folded GEMM records: PROJ, then CONV
    (nine taps) or COL and ROW (five taps each), then EXP."""
    parts = _projection(blk)
    if blk.asymmetric:
        col = packing.hwio(blk.conv_col)
        parts += gemm_record(col.reshape(5, 32, 32), 32, 32)
        w, v = conv_taps(blk.conv_row, blk.conv_bn, blk.conv_prelu)
    else:
        w, v = conv_taps(blk.conv, blk.conv_bn, blk.conv_prelu)
    return packing.flat(parts + gemm_record(w, 32, 32, v) + _expand(blk))


def pack_b20(blk) -> torch.Tensor:
    """B2_0's records: the 2x2/s2 projection as four taps of 64, the
    3x3, the expand."""
    parts = _projection(blk)
    w, v = conv_taps(blk.conv, blk.conv_bn, blk.conv_prelu)
    return packing.flat(parts + gemm_record(w, 32, 32, v) + _expand(blk))


def pack_mid(model) -> List[torch.Tensor]:
    """``[B2_0, block x 16]`` packs (:func:`mid_layout`)."""
    return [pack_b20(model.Bottleneck2_0)] + [
        pack_block(blk) for blk in model.blocks(model.stage23)]


def mid_stage23_plain(x1: torch.Tensor, model
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version, from the model's own blocks."""
    y, switches2 = model.forward_stage23(x1)
    n, h8, w8, _ = y.shape
    return y, switches2.reshape(n, h8, w8, 64)


def _launch(lib, x1, packs, model, score: bool, stream
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every launch of one call on ``x1``'s device, counted."""
    n, hq, wq, _ = x1.shape
    h8, w8 = hq // 2, wq // 2
    blocks = model.blocks(model.stage23)
    build.require_pack(packs[0], lib.ssal_mid_pack_size(KIND_ID["b20"]),
                       "mid B2_0")
    for blk, pack in zip(blocks, packs[1:]):
        build.require_pack(pack, lib.ssal_mid_pack_size(
            KIND_ID[block_kind(blk)]), "mid block")
    y = torch.empty((n, h8, w8, 128), device=x1.device)
    sw2 = torch.empty((n, h8, w8, 64), dtype=torch.int8, device=x1.device)
    build.check(lib.ssal_mid_b20(build.ptr(x1), build.ptr(packs[0]),
                                 build.ptr(y), build.ptr(sw2), n, h8, w8,
                                 int(score), stream), "mid B2_0 kernel")
    fused_mid_stage23.launches += 1
    # the ping-pong partner of ``y`` and the unfused blocks' projection
    cur, nxt = y, torch.empty_like(y)
    proj = None
    for blk, pack in zip(blocks, packs[1:]):
        p = None
        if not fused(blk.dilation, blk.asymmetric):
            if proj is None:
                proj = torch.empty((n, h8, w8, 32), device=x1.device)
            build.check(lib.ssal_mid_proj(build.ptr(cur), build.ptr(pack),
                                          build.ptr(proj), n * h8 * w8,
                                          int(score), stream),
                        "mid projection kernel")
            fused_mid_stage23.launches += 1
            p = build.ptr(proj)
        build.check(lib.ssal_mid_block(build.ptr(cur), p, build.ptr(pack),
                                       build.ptr(nxt), n, h8, w8,
                                       blk.dilation, int(blk.asymmetric),
                                       int(score), stream),
                    "mid block kernel")
        fused_mid_stage23.launches += 1
        cur, nxt = nxt, cur
    # an even number of blocks leaves the result in ``y``
    assert cur is y
    return y, sw2


@torch.no_grad()
def fused_mid_stage23(x1: torch.Tensor, model, score: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x1 -> (y, sw2)``: the CUDA kernels on a CUDA tensor, at the
    score route's precision with ``score`` (else the predict route's);
    the plain version on a CPU tensor."""
    if x1.device.type == "cpu":
        return mid_stage23_plain(x1, model)
    build.require(x1, "x1", torch.float32, (None, None, None, 64))
    n, hq, wq, _ = x1.shape
    if hq % 2 or wq % 2:
        raise ValueError(f"x1 H, W must be even, got {hq}x{wq}")
    lib = build.library()
    packs = model.packed("mid", x1.device, pack_mid)
    with torch.cuda.device(x1.device):
        return _launch(lib, x1, packs, model, score, build.stream_of(x1))


fused_mid_stage23.launches = 0
