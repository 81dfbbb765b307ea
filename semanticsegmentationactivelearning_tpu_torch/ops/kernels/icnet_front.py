"""ICNet front: image -> (f1, x_half) or (f1, stem1).

The port of ``fused_icnet_front`` and ``fused_icnet_front_stem``
(``ops/pallas_kernels.py:3189`` and ``:3346``); the CUDA kernels are
``csrc/icnet_front.cu``. Same contracts: image ``[N, H, W, 3]`` float32
with H and W multiples of 32 -> Branch1's ``f1 [N, H/8, W/8, 64]`` and
either the antialiased half-res image ``x_half [N, H/2, W/2, 3]`` or the
SharedStem's pooled front ``stem1 [N, H/8, W/8, 64]``, all float32.

Every conv (Branch1_1..1_3, SharedStem conv1_1..1_3) runs on the tensor
cores at the precision of the caller's route (:data:`PRECISION`), from
BN-folded GEMM records (:func:`pack_icnet_front`); the downsample and
the pool are fp32. The front is one launch (Branch1 and x_half); the
front + stem is Branch1's launch and the stem's two
(:data:`STEM_PARTS`), whose intermediate, conv1_2's output ``c12 [N,
H/4, W/4, 32]``, passes through device memory (an amendment to the TPU
kernel's contract, ROADMAP North star: the stem's halo of 5 quarter-res
positions against 227 KB of shared memory a block).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...ops import nn as xops
from . import build, packing

# The tensor-core precision of each route (csrc/icnet_front.cu
# kPredictPasses, kScorePasses), as the ENet kernels' and CFF2's: 3xTF32
# for labels, one TF32 pass for scores (on the CPU, one TF32 pass in all
# six convs moved ICNet's pool scores by 6e-6 of the 1e-4 tolerance at
# batch 2, 1024x2048). chip_smoke.py's PRECISION_GATE holds each route
# one precision below on f1 and stem1.
PRECISION = {"predict": "3xTF32", "score": "TF32"}
# the convs whose products run at the route's precision: all of them
TC_CONVS = ("Branch1_1", "Branch1_2", "Branch1_3", "SharedStem.conv1_1",
            "SharedStem.conv1_2", "SharedStem.conv1_3")
# The C entry ssal_icnet_front_part's launches (csrc/icnet_front.cu).
PARTS = {"branch1": 0, "front": 1, "stem12": 2, "stem3": 3}
# The stem's launches on the front + stem route after Branch1's: conv1_1
# + conv1_2 on quarter-res tiles, their output c12 through device memory,
# then conv1_3 + the pool on eighth-res tiles. tools/probe_icnet_front.py
# measured it on the H100 against the stem in one launch and against
# Branch1 + the stem in one launch a tile: 2.76 against 3.09 and 3.37 ms
# (score, batch 8), 1.17 against 1.26 and 1.34 (predict, batch 2;
# PERF.md).
STEM_PARTS = ("stem12", "stem3")
LAUNCHES_PER_CALL = 1 + len(STEM_PARTS)


def pack_icnet_front(model) -> torch.Tensor:
    """Six BN-folded GEMM records (``csrc/icnet_front.cu``): Branch1_1,
    1_2, 1_3, then SharedStem conv1_1, 1_2, 1_3. A 3-channel conv is one
    tap ``[27 (dy, dx, c) padded to 32, 32]``; a 32-channel one nine taps
    ``[9, 32, out]``; each with its bias."""
    stem = model.SharedStem
    parts = []
    for cbn in (model.Branch1_1, model.Branch1_2, model.Branch1_3,
                stem.conv1_1, stem.conv1_2, stem.conv1_3):
        w, t = packing.affine(packing.hwio(cbn.conv), cbn.bn)
        kh, kw, ci, co = w.shape
        taps = 1 if ci == 3 else kh * kw
        parts += packing.gemm_record(w.reshape(taps, -1, co), 32, co, [t])
    return packing.flat(parts)


def _check(image: torch.Tensor) -> Tuple[int, int, int]:
    build.require(image, "image", torch.float32, (None, None, None, 3))
    n, h, w, _ = image.shape
    if h % 32 or w % 32:
        raise ValueError(f"image H and W must be multiples of 32, got "
                         f"{h}x{w}")
    return n, h, w


def launch_part(part: str, x: torch.Tensor, model, score: bool,
                hw: Tuple[int, int]) -> tuple:
    """One launch of ``part`` (:data:`PARTS`) on CUDA tensors, uncounted
    (the wrappers below count theirs), at the score route's precision
    with ``score``: ``x`` is the image, or for "stem3" conv1_2's output
    ``c12 [N, H/4, W/4, 32]``; ``hw`` the image's (H, W). Returns the
    part's outputs: "branch1" (f1,), "front" (f1, x_half), "stem12"
    (c12,), "stem3" (stem1,)."""
    n = x.shape[0]
    h, w = hw
    lib = build.library()
    pack = model.packed("icnet_front", x.device, pack_icnet_front)
    build.require_pack(pack, lib.ssal_icnet_front_pack_size(), "icnet front")
    eighth = (n, h // 8, w // 8, 64)
    shapes = {"branch1": (eighth,), "front": (eighth, (n, h // 2, w // 2, 3)),
              "stem12": ((n, h // 4, w // 4, 32),), "stem3": (eighth,)}[part]
    outs = tuple(torch.empty(s, device=x.device) for s in shapes)
    out2 = build.ptr(outs[1]) if len(outs) > 1 else None
    with torch.cuda.device(x.device):
        build.check(lib.ssal_icnet_front_part(
            PARTS[part], build.ptr(x), build.ptr(pack), build.ptr(outs[0]),
            out2, n, h, w, int(score), build.stream_of(x)),
            f"icnet front {part} kernel")
    return outs


def icnet_front_plain(image: torch.Tensor, model
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: the model's Branch1 and the antialiased
    ``F.interpolate``."""
    _, h, w, _ = image.shape
    return model.branch1(image), xops.resize_bilinear(image,
                                                      (h // 2, w // 2))


@torch.no_grad()
def fused_icnet_front(image: torch.Tensor, model, score: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Image -> ``(f1, x_half)``: the CUDA kernel on a CUDA tensor, at the
    score route's precision with ``score`` (else the predict route's);
    the plain version on a CPU tensor."""
    if image.device.type == "cpu":
        return icnet_front_plain(image, model)
    n, h, w = _check(image)
    out = launch_part("front", image, model, score, (h, w))
    fused_icnet_front.launches += 1
    return out


fused_icnet_front.launches = 0


def icnet_front_stem_plain(image: torch.Tensor, model
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: the model's Branch1, the antialiased
    ``F.interpolate`` and the SharedStem's conv1_1..max pool."""
    f1, x_half = icnet_front_plain(image, model)
    return f1, model.SharedStem.front(x_half)


@torch.no_grad()
def fused_icnet_front_stem(image: torch.Tensor, model, score: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Image -> ``(f1, stem1)``: the CUDA kernels on a CUDA tensor
    (Branch1's launch, then the stem's :data:`STEM_PARTS`; the half-res
    image stays on chip), at the score route's precision with ``score``;
    the plain version on a CPU tensor."""
    if image.device.type == "cpu":
        return icnet_front_stem_plain(image, model)
    n, h, w = _check(image)
    (f1,) = launch_part("branch1", image, model, score, (h, w))
    fused_icnet_front_stem.launches += 1
    x = image
    for part in STEM_PARTS:
        (x,) = launch_part(part, x, model, score, (h, w))
        fused_icnet_front_stem.launches += 1
    return f1, x


fused_icnet_front_stem.launches = 0
