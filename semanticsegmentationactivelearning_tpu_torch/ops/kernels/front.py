"""ENet front: image -> (stage-1 features, B1_0 switch mask).

The port of ``fused_front_stage1_w`` / ``fused_front_stage1``
(``ops/pallas_kernels.py:1474`` / ``:1030``); the CUDA kernels are in
``csrc/front.cu``. Same contract: image ``[N, H, W, 3]`` float32 ->
``x1 [N, H/4, W/4, 64]`` float32 and ``mask1 [N, H/4, W/4, 64]``
float32, the one-hot of each B1_0 pool switch at channel ``p*16 + c``
(``p`` = window position, row-major).

The TPU kernel keeps the whole front in VMEM; on the GPU Initial and
B1_0 are one launch (``b10_kernel``) and each stage-1 bottleneck
B1_1..1_4 one more (``stage1_kernel``), the 64-channel activations
between launches in device memory: :data:`LAUNCHES_PER_CALL` in all.
Initial and the pool run in fp32 on both routes; every product of
B1_0..B1_4 runs on the tensor cores at the precision of the caller's
route (:data:`PRECISION`).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from ...ops import nn as xops
from . import build, packing
from .packing import conv_taps, gemm_record

# The tensor-core precision of each route (csrc/front.cu kPredictPasses,
# kScorePasses), as the tail's and the mid's: 3xTF32 for labels, one
# TF32 pass for scores. Initial and B1_0's pool (the switches) are fp32
# on both.
PRECISION = {"predict": "3xTF32", "score": "TF32"}
# One launch per stage-1 bottleneck. Fusing G of them into a launch over
# the tile plus a halo of G was measured on the H100 (PERF.md):
# B1_1..1_4 took 0.544, 0.614 and 0.668 ms at G = 1, 2, 4 on the predict
# route at batch 2, 1024x2048 (0.398, 0.433, 0.453 on the score route):
# the halo's recompute costs more than the bytes that fewer launches save.
STAGE1_BLOCKS = 4
LAUNCHES_PER_CALL = 1 + STAGE1_BLOCKS
# the blocks whose products run on the tensor cores at the route's
# precision (Initial's stay fp32)
TC_BLOCKS = tuple(f"Bottleneck1_{i}" for i in range(1 + STAGE1_BLOCKS))


def acc_order(k: int) -> torch.Tensor:
    """The order of an expand record's k rows where the kernel feeds the
    3x3's accumulators to it as A fragments (``csrc/front.cu``
    ``conv3_expand``): within each 8, row r holds channel 2r (r < 4) or
    2(r - 4) + 1."""
    return torch.tensor([8 * (i // 8) + (2 * (i % 8) if i % 8 < 4
                                         else 2 * (i % 8 - 4) + 1)
                         for i in range(k)])


def pack_bottleneck(blk) -> List[torch.Tensor]:
    """A stage-1 bottleneck's (or B1_0's) BN-folded GEMM records: PROJ
    (B1_0's 2x2/s2 conv as one tap of its four positions x 16), CONV
    (nine taps), EXP (k rows in :func:`acc_order`)."""
    wp, vp = conv_taps(blk.proj_conv, blk.proj_bn, blk.proj_prelu)
    wc, vc = conv_taps(blk.conv, blk.conv_bn, blk.conv_prelu)
    we, (te,) = conv_taps(blk.exp_conv, blk.exp_bn)
    f = wc.shape[1]
    wp = wp.reshape(1, -1, f)
    return (gemm_record(wp, wp.shape[1], f, vp) + gemm_record(wc, f, f, vc)
            + gemm_record(we[:, acc_order(f)], f, we.shape[2],
                          (te, blk.res_prelu.alpha)))


def pack_front(model) -> torch.Tensor:
    """Initial's folded weights ``[27][16]`` (13 used), its BN scale and
    shift and PReLU alpha, then the records of B1_0 and B1_1..1_4
    (layout of ``csrc/front.cu``)."""
    ini = model.Initial
    s, t = ini.bn.scale_shift()
    w = F.pad((packing.hwio(ini.conv) * s[:13]).reshape(27, 13), (0, 3))
    parts = [w, s, t, ini.prelu.alpha]
    parts += pack_bottleneck(model.Bottleneck1_0)
    for blk in model.blocks(model.stage1):
        parts += pack_bottleneck(blk)
    return packing.flat(parts)


def switches_to_mask(switches: torch.Tensor) -> torch.Tensor:
    """B1_0's int8 switches ``[N, h, w*16]`` -> the kernels' one-hot
    mask ``[N, h, w, 64]`` (channel ``p*16 + c``)."""
    onehot = xops.switches_to_onehot(switches, 16)  # [N,h,w,4,16]
    n, h, w = onehot.shape[:3]
    return onehot.reshape(n, h, w, 64)


def front_stage1_plain(image: torch.Tensor, model
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version, from the model's own blocks."""
    x1, switches1 = model(image, return_stage1=True)
    return x1, switches_to_mask(switches1)


def b10_plain(image: torch.Tensor, model
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``b10_kernel``'s function: Initial and B1_0 -> ``(x, mask1)``."""
    x, switches1 = model.Bottleneck1_0(model.Initial(image))
    return x, switches_to_mask(switches1)


def block_plain(x: torch.Tensor, model, index: int) -> torch.Tensor:
    """``stage1_kernel``'s: Bottleneck1_{index+1}."""
    return model.blocks(model.stage1)[index](x)


@torch.no_grad()
def fused_front_stage1(image: torch.Tensor, model, score: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Image -> ``(x1, mask1)``: the CUDA kernels on a CUDA tensor, at
    the score route's precision with ``score`` (else the predict
    route's); the plain version on a CPU tensor."""
    if image.device.type == "cpu":
        return front_stage1_plain(image, model)
    build.require(image, "image", torch.float32, (None, None, None, 3))
    n, h, w, _ = image.shape
    if h % 8 or w % 8:
        raise ValueError(f"image H and W must be multiples of 8, got "
                         f"{h}x{w}")
    lib = build.library()
    pack = model.packed("front", image.device, pack_front)
    build.require_pack(pack, lib.ssal_front_pack_size(), "front")
    x = torch.empty((n, h // 4, w // 4, 64), device=image.device)
    mask1 = torch.empty_like(x)
    with torch.cuda.device(image.device):
        stream = build.stream_of(image)
        build.check(lib.ssal_front_b10(build.ptr(image), build.ptr(pack),
                                       build.ptr(x), build.ptr(mask1), n, h,
                                       w, int(score), stream),
                    "front B1_0 kernel")
        fused_front_stage1.launches += 1
        cur, nxt = x, torch.empty_like(x)
        for index in range(STAGE1_BLOCKS):
            build.check(lib.ssal_front_block(
                build.ptr(cur), build.ptr(pack), build.ptr(nxt), n, h // 4,
                w // 4, index, int(score), stream), "front stage-1 kernel")
            fused_front_stage1.launches += 1
            cur, nxt = nxt, cur
    return cur, mask1


fused_front_stage1.launches = 0
