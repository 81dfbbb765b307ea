"""ENet Final score: (pre-Final features, Final kernel) -> the per-image
mean entropy confidence.

The port of ``fused_deconv_entropy_score``
(``ops/pallas_kernels.py:344``); the CUDA kernel is ``csrc/decoder.cu``
``deconv_score_kernel``, which runs the tail kernel's Final and entropy
code (``csrc/decoder.cuh``). Same contract: ``features [N, H2, W2, 16]``
float32 and the flax kernel ``[3, 3, 16, C]`` -> float32 ``[N]``, the
mean over the ``2*H2 x 2*W2`` pixels of ``1 - H(softmax)/log C`` of the
3x3/s2 transposed conv (``x[-1] = 0`` at the top and left edges).
"""

from __future__ import annotations

import torch

from .. import acquisition
from . import build


def deconv_score_plain(features: torch.Tensor, kernel: torch.Tensor,
                       num_classes: int) -> torch.Tensor:
    """The plain PyTorch version: the whole transposed conv, then
    ``acquisition.mean_confidence`` (it materializes the
    full-resolution logits)."""
    logits = acquisition.conv_transpose_same(features, kernel)
    return acquisition.mean_confidence(logits, "entropy", num_classes)


@torch.no_grad()
def fused_deconv_entropy_score(features: torch.Tensor, kernel: torch.Tensor,
                               num_classes: int) -> torch.Tensor:
    """Per-image mean entropy confidence float32 ``[N]``: the CUDA
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if features.device.type == "cpu":
        return deconv_score_plain(features, kernel, num_classes)
    build.require(features, "features", torch.float32, (None, None, None, 16))
    build.require(kernel, "kernel", torch.float32, (3, 3, 16, num_classes))
    n, h2, w2, _ = features.shape
    lib = build.library()
    partials = torch.empty((n, lib.ssal_deconv_partials(h2, w2)),
                           device=features.device)
    with torch.cuda.device(features.device):
        build.check(lib.ssal_deconv_score(build.ptr(features),
                                          build.ptr(kernel),
                                          build.ptr(partials), n, h2, w2,
                                          num_classes,
                                          build.stream_of(features)),
                    "deconv score kernel")
    fused_deconv_entropy_score.launches += 1
    return partials.sum(dim=1) / float(4 * h2 * w2)


fused_deconv_entropy_score.launches = 0
