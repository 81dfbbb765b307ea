"""ENet mid section: stage-1 features -> (stage-3 features, B2_0
switches).

The port of ``fused_mid_stage23_w`` / ``fused_mid_stage23``
(``ops/pallas_kernels.py:2184`` / ``:1808``); the CUDA kernels are in
``csrc/mid.cu``. Same contract: ``x1 [N, Hq, Wq, 64]`` float32 ->
``y [N, Hq/2, Wq/2, 128]`` float32 and ``sw2`` int8
``[N, Hq/2, Wq/2, 64]`` (window positions 0..3).

The TPU kernel keeps a whole image in VMEM; on the GPU each block is
its own launch over L2-resident activations: B2_0 is one launch and
each of the 16 stage-2/3 bottlenecks two (the 1x1 projection, then the
spatial conv + expand + residual), :data:`LAUNCHES_PER_CALL` = 33.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ...models.enet import DILATED_SPEC
from . import build, packing

LAUNCHES_PER_CALL = 1 + 2 * 2 * len(DILATED_SPEC)


def pack_mid(model) -> List[torch.Tensor]:
    """``[B2_0, (proj, conv) x 16]`` BN-folded packs (layouts of
    ``csrc/mid.cu`` ``ssal_mid_b20``, ``ssal_mid_proj`` and
    ``ssal_mid_conv``)."""
    packs = [packing.flat(packing.bottleneck(model.Bottleneck2_0))]
    for blk in model.blocks(model.stage23):
        packs.append(packing.flat(packing.affine(
            packing.hwio(blk.proj_conv), blk.proj_bn, blk.proj_prelu)))
        if blk.asymmetric:
            spatial = [packing.hwio(blk.conv_col)] + packing.affine(
                packing.hwio(blk.conv_row), blk.conv_bn, blk.conv_prelu)
        else:
            spatial = packing.affine(packing.hwio(blk.conv), blk.conv_bn,
                                     blk.conv_prelu)
        packs.append(packing.flat(
            spatial + packing.affine(packing.hwio(blk.exp_conv),
                                     blk.exp_bn)
            + [blk.res_prelu.alpha]))
    return packs


def mid_stage23_plain(x1: torch.Tensor, model
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version, from the model's own blocks."""
    y, switches2 = model.forward_stage23(x1)
    n, h8, w8, _ = y.shape
    return y, switches2.reshape(n, h8, w8, 64)


def fused_mid_stage23(x1: torch.Tensor, model
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x1 -> (y, sw2)``: the CUDA kernels on a CUDA tensor, the
    plain version on a CPU tensor."""
    if x1.device.type == "cpu":
        return mid_stage23_plain(x1, model)
    build.require(x1, "x1", torch.float32, (None, None, None, 64))
    n, hq, wq, _ = x1.shape
    if hq % 2 or wq % 2:
        raise ValueError(f"x1 H, W must be even, got {hq}x{wq}")
    lib = build.library()
    packs = model.packed("mid", x1.device, pack_mid)
    build.require_pack(packs[0], lib.ssal_mid_b20_pack_size(), "mid B2_0")
    for k, blk in enumerate(model.blocks(model.stage23)):
        build.require_pack(packs[1 + 2 * k], lib.ssal_mid_proj_pack_size(),
                           "mid projection")
        build.require_pack(packs[2 + 2 * k],
                           lib.ssal_mid_conv_pack_size(int(blk.asymmetric)),
                           "mid conv")
    h8, w8 = hq // 2, wq // 2
    y = torch.empty((n, h8, w8, 128), device=x1.device)
    sw2 = torch.empty((n, h8, w8, 64), dtype=torch.int8, device=x1.device)
    # the 32-channel projection and the ping-pong partner of ``y``
    proj = torch.empty((n, h8, w8, 32), device=x1.device)
    cur, nxt = y, torch.empty_like(y)
    with torch.cuda.device(x1.device):
        stream = build.stream_of(x1)
        build.check(lib.ssal_mid_b20(build.ptr(x1), build.ptr(packs[0]),
                                     build.ptr(y), build.ptr(sw2), n, h8, w8,
                                     stream), "mid B2_0 kernel")
        fused_mid_stage23.launches += 1
        for k, blk in enumerate(model.blocks(model.stage23)):
            build.check(lib.ssal_mid_proj(build.ptr(cur),
                                          build.ptr(packs[1 + 2 * k]),
                                          build.ptr(proj), n * h8 * w8,
                                          stream), "mid projection kernel")
            fused_mid_stage23.launches += 1
            build.check(lib.ssal_mid_conv(build.ptr(cur), build.ptr(proj),
                                          build.ptr(packs[2 + 2 * k]),
                                          build.ptr(nxt), n, h8, w8,
                                          blk.dilation, int(blk.asymmetric),
                                          stream), "mid conv kernel")
            fused_mid_stage23.launches += 1
            cur, nxt = nxt, cur
    # an even number of blocks leaves the result in ``y``
    assert cur is y
    return y, sw2


fused_mid_stage23.launches = 0
