"""ENet Final score: (pre-Final features, Final kernel) -> the per-image
mean entropy confidence.

The port of ``fused_deconv_entropy_score``
(``ops/pallas_kernels.py:344``). Same contract: ``features [N, H2, W2,
16]`` float32 and the flax kernel ``[3, 3, 16, C]`` -> float32 ``[N]``,
the mean over the ``2*H2 x 2*W2`` pixels of ``1 - H(softmax)/log C`` of
the 3x3/s2 transposed conv (``x[-1] = 0`` at the top and left edges).

The CUDA kernel is ``csrc/tail.cu`` ``deconv_score_kernel``: the tail's
Final (``final_phases``, which ``tail5_kernel`` runs too) on tiles of
the features staged in shared memory, its four exact-tap phase GEMMs on
the tensor cores in TF32 with the weights as hi + lo, two passes
(``tail.PRECISION["score"]``, ``csrc/tail.cu`` kFinalScorePasses), the
entropy online over the classes in registers, one partial sum of
confidences a tile of ``tail.T5`` x ``tail.T5`` half-res positions
(:func:`deconv_partials`). It reads the Final's GEMM record
(``tail.pack_final``), the bits of the tail pack's Final.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import acquisition
from . import build, tail


def deconv_score_plain(features: torch.Tensor, kernel: torch.Tensor,
                       num_classes: int) -> torch.Tensor:
    """The plain PyTorch version: the whole transposed conv, then
    ``acquisition.mean_confidence`` (it materializes the
    full-resolution logits)."""
    logits = acquisition.conv_transpose_same(features, kernel)
    return acquisition.mean_confidence(logits, "entropy", num_classes)


def deconv_partials_plain(features: torch.Tensor, kernel: torch.Tensor,
                          num_classes: int) -> torch.Tensor:
    """The plain version of :func:`deconv_partials`: the transposed
    conv's per-pixel entropy confidences summed by ``tail.tile_sums``."""
    logits = acquisition.conv_transpose_same(features, kernel)
    return tail.tile_sums(acquisition.confidence_map(logits, "entropy",
                                                     num_classes))


@torch.no_grad()
def deconv_partials(features: torch.Tensor, kernel: torch.Tensor,
                    num_classes: int,
                    record: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each tile's sum of entropy confidences, float32 ``[N, tiles]``
    (``tail.tile_sums``' order): the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors. The kernel reads ``record``,
    ``tail.pack_final(kernel, num_classes)``, packed here unless the
    caller passes it (``ENet.fused_score`` caches it). Each launch counts
    in ``fused_deconv_entropy_score.launches``, the route's count."""
    if features.device.type == "cpu":
        return deconv_partials_plain(features, kernel, num_classes)
    build.require(features, "features", torch.float32, (None, None, None, 16))
    build.require(kernel, "kernel", torch.float32, (3, 3, 16, num_classes))
    if record is None:
        record = tail.pack_final(kernel, num_classes)
    build.require(record, "record", torch.float32,
                  (tail.final_size(num_classes),))
    n, h2, w2, _ = features.shape
    lib = build.library()
    partials = torch.empty((n, lib.ssal_deconv_partials(h2, w2)),
                           device=features.device)
    with torch.cuda.device(features.device):
        build.check(lib.ssal_deconv_score(build.ptr(features),
                                          build.ptr(record),
                                          build.ptr(partials), n, h2, w2,
                                          num_classes,
                                          build.stream_of(features)),
                    "deconv score kernel")
    fused_deconv_entropy_score.launches += 1
    return partials


@torch.no_grad()
def fused_deconv_entropy_score(features: torch.Tensor, kernel: torch.Tensor,
                               num_classes: int,
                               record: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Per-image mean entropy confidence float32 ``[N]``: the sum of
    :func:`deconv_partials` over the pixel count on CUDA tensors, the
    plain version on CPU tensors."""
    if features.device.type == "cpu":
        return deconv_score_plain(features, kernel, num_classes)
    return tail.partials_mean(
        deconv_partials(features, kernel, num_classes, record),
        4 * features.shape[1] * features.shape[2])


fused_deconv_entropy_score.launches = 0
