"""ICNet front: image -> (f1, x_half) or (f1, stem1).

The port of ``fused_icnet_front`` and ``fused_icnet_front_stem``
(``ops/pallas_kernels.py:3189`` and ``:3346``); the CUDA kernel is
``csrc/icnet_front.cu``, one template for both. Same contracts: image
``[N, H, W, 3]`` float32 with H and W multiples of 32 -> Branch1's
``f1 [N, H/8, W/8, 64]`` and either the antialiased half-res image
``x_half [N, H/2, W/2, 3]`` or the SharedStem's pooled front
``stem1 [N, H/8, W/8, 64]``, all float32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...ops import nn as xops
from . import build, packing


def pack_icnet_front(model) -> torch.Tensor:
    """Fold BN into Branch1_1..1_3 and SharedStem conv1_1..1_3 (layout
    of ``csrc/icnet_front.cu``; the front kernel reads the first three)."""
    stem = model.SharedStem
    parts = []
    for cbn in (model.Branch1_1, model.Branch1_2, model.Branch1_3,
                stem.conv1_1, stem.conv1_2, stem.conv1_3):
        parts += packing.affine(packing.hwio(cbn.conv), cbn.bn)
    return packing.flat(parts)


def _check(image: torch.Tensor) -> Tuple[int, int, int]:
    build.require(image, "image", torch.float32, (None, None, None, 3))
    n, h, w, _ = image.shape
    if h % 32 or w % 32:
        raise ValueError(f"image H and W must be multiples of 32, got "
                         f"{h}x{w}")
    return n, h, w


def _launch(entry: str, image: torch.Tensor, model, second: tuple):
    """Run ``entry`` on a checked image; returns (f1, the second output
    of shape ``second``)."""
    n, h, w, _ = image.shape
    lib = build.library()
    pack = model.packed("icnet_front", image.device, pack_icnet_front)
    build.require_pack(pack, lib.ssal_icnet_front_pack_size(), "icnet front")
    f1 = torch.empty((n, h // 8, w // 8, 64), device=image.device)
    out2 = torch.empty(second, device=image.device)
    with torch.cuda.device(image.device):
        build.check(getattr(lib, entry)(build.ptr(image), build.ptr(pack),
                                        build.ptr(f1), build.ptr(out2), n, h,
                                        w, build.stream_of(image)), entry)
    return f1, out2


def icnet_front_plain(image: torch.Tensor, model
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: the model's Branch1 and the antialiased
    ``F.interpolate``."""
    _, h, w, _ = image.shape
    return model.branch1(image), xops.resize_bilinear(image,
                                                      (h // 2, w // 2))


@torch.no_grad()
def fused_icnet_front(image: torch.Tensor, model
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Image -> ``(f1, x_half)``: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if image.device.type == "cpu":
        return icnet_front_plain(image, model)
    n, h, w = _check(image)
    out = _launch("ssal_icnet_front", image, model,
                  (n, h // 2, w // 2, 3))
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
def fused_icnet_front_stem(image: torch.Tensor, model
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Image -> ``(f1, stem1)``: the CUDA kernel on a CUDA tensor (the
    half-res image stays on chip), the plain version on a CPU tensor."""
    if image.device.type == "cpu":
        return icnet_front_stem_plain(image, model)
    n, h, w = _check(image)
    out = _launch("ssal_icnet_front_stem", image, model,
                  (n, h // 8, w // 8, 64))
    fused_icnet_front_stem.launches += 1
    return out


fused_icnet_front_stem.launches = 0
