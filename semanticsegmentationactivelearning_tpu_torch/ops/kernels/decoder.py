"""ENet decoder score: (stage-4 features, B1_0 switches or mask) -> the
per-image mean entropy confidence.

The port of ``fused_decoder_entropy_score``
(``ops/pallas_kernels.py:687``). Same contract: ``f4 [N, Hq, Wq, 64]``
float32 plus either B1_0's int8 ``switches [N, Hq, Wq*16]`` or the
one-hot ``mask [N, Hq, Wq, 64]`` of the front kernel -> float32 ``[N]``,
the mean over pixels of ``1 - H(softmax)/log C`` (Bottleneck5_0 +
Bottleneck5_1 + Final + the entropy mean). Switches become the mask
here, before either version runs, so that the kernel and its plain
version take the same inputs.

The kernel is the tail's second half, ``csrc/tail.cu`` ``tail5_kernel``
on the score route (``ssal_tail_decode_score``: one TF32 pass, the
Final's weights as hi + lo, ``tail.PRECISION``), which has this contract with ``f4`` as its x4: it
reads the tail's GEMM records (``tail.pack_tail``), keeps the half-res
activations in shared memory and the logits in registers, and writes
one partial sum of confidences a block.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import acquisition
from . import front, tail


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
    on CUDA tensors (Hq and Wq even), the plain version on CPU
    tensors."""
    if mask is None:
        if switches is None:
            raise ValueError("fused_decoder_entropy_score needs switches "
                             "or mask")
        mask = front.switches_to_mask(switches)
    if f4.device.type == "cpu":
        return decoder_score_plain(f4, mask, model)
    parts = tail.launch_decode(f4, mask, model, score=True)
    fused_decoder_entropy_score.launches += 1
    return tail.partials_mean(parts, 16 * f4.shape[1] * f4.shape[2])


fused_decoder_entropy_score.launches = 0
