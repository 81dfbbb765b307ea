"""ENet front: image -> (stage-1 features, B1_0 switch mask).

The port of ``fused_front_stage1_w`` / ``fused_front_stage1``
(``ops/pallas_kernels.py:1474`` / ``:1030``); the CUDA kernel is
``csrc/front.cu``. Same contract: image ``[N, H, W, 3]`` float32 ->
``x1 [N, H/4, W/4, 64]`` float32 and ``mask1 [N, H/4, W/4, 64]``
float32, the one-hot of each B1_0 pool switch at channel ``p*16 + c``
(``p`` = window position, row-major).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...ops import nn as xops
from . import build, packing


def pack_front(model) -> torch.Tensor:
    """Fold BN into the Initial, B1_0 and B1_1..1_4 weights (layout of
    ``csrc/front.cu`` ``ssal_front``)."""
    ini = model.Initial
    s, t = ini.bn.scale_shift()
    parts = [packing.hwio(ini.conv) * s[:13], s, t, ini.prelu.alpha]
    parts += packing.bottleneck(model.Bottleneck1_0)
    for blk in model.blocks(model.stage1):
        parts += packing.bottleneck(blk)
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


def fused_front_stage1(image: torch.Tensor, model
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Image -> ``(x1, mask1)``: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
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
    x1 = torch.empty((n, h // 4, w // 4, 64), device=image.device)
    mask1 = torch.empty_like(x1)
    with torch.cuda.device(image.device):
        build.check(lib.ssal_front(build.ptr(image), build.ptr(pack),
                                   build.ptr(x1), build.ptr(mask1), n, h, w,
                                   build.stream_of(image)), "front kernel")
    fused_front_stage1.launches += 1
    return x1, mask1


fused_front_stage1.launches = 0
