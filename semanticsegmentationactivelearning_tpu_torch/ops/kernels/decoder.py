"""ENet decoder score: (stage-4 features, B1_0 switches or mask) -> the
per-image mean entropy confidence.

The port of ``fused_decoder_entropy_score``
(``ops/pallas_kernels.py:687``); the CUDA kernel is
``csrc/decoder.cu`` ``decoder_score_kernel``, which runs the tail
kernel's stage-5, Final and entropy code (``csrc/decoder.cuh``). Same
contract: ``f4 [N, Hq, Wq, 64]`` float32 plus either B1_0's int8
``switches [N, Hq, Wq*16]`` or the one-hot ``mask [N, Hq, Wq, 64]`` of
the front kernel -> float32 ``[N]``, the mean over pixels of
``1 - H(softmax)/log C`` (Bottleneck5_0 + Bottleneck5_1 + Final + the
entropy mean). Switches become the mask here, before either version
runs, so that the kernel and its plain version take the same inputs.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import acquisition
from . import build, front, packing, tail


def pack_decoder(model) -> torch.Tensor:
    """BN-folded B5_0, B5_1 and the Final kernel (layout of
    ``csrc/decoder.cu`` ``ssal_decoder_score``)."""
    return packing.flat(packing.stage5(model))


def decoder_score_plain(f4: torch.Tensor, mask1: torch.Tensor,
                        model) -> torch.Tensor:
    """The plain PyTorch version, from the model's own blocks and
    ``acquisition.mean_confidence`` (it materializes the
    full-resolution logits)."""
    pre = model.decode_from_stage4(f4, tail.mask_to_switches(mask1))
    return acquisition.mean_confidence(model.Final(pre), "entropy",
                                       model.num_classes)


@torch.no_grad()
def fused_decoder_entropy_score(f4: torch.Tensor,
                                switches: Optional[torch.Tensor], model,
                                mask: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Per-image mean entropy confidence float32 ``[N]`` from ``f4`` and
    ``switches`` (or ``mask``, which takes precedence): the CUDA kernel
    on CUDA tensors, the plain version on CPU tensors."""
    if mask is None:
        if switches is None:
            raise ValueError("fused_decoder_entropy_score needs switches "
                             "or mask")
        mask = front.switches_to_mask(switches)
    if f4.device.type == "cpu":
        return decoder_score_plain(f4, mask, model)
    build.require(f4, "f4", torch.float32, (None, None, None, 64))
    n, hq, wq, _ = f4.shape
    build.require(mask, "mask", torch.float32, (n, hq, wq, 64))
    c = model.num_classes
    lib = build.library()
    pack = model.packed("decoder", f4.device, pack_decoder)
    build.require_pack(pack, lib.ssal_decoder_pack_size(c), "decoder")
    partials = torch.empty((n, lib.ssal_decoder_partials(hq, wq)),
                           device=f4.device)
    with torch.cuda.device(f4.device):
        build.check(lib.ssal_decoder_score(build.ptr(f4), build.ptr(mask),
                                           build.ptr(pack),
                                           build.ptr(partials), n, hq, wq,
                                           c, build.stream_of(f4)),
                    "decoder score kernel")
    fused_decoder_entropy_score.launches += 1
    return partials.sum(dim=1) / float(16 * hq * wq)


fused_decoder_entropy_score.launches = 0
