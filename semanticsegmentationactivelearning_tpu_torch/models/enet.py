"""ENet (arXiv:1606.02147), the PyTorch port of
``semanticsegmentationactivelearning_tpu/models/enet.py``.

Stage layout as in the JAX package:

    Initial (1/2, 16ch)
    Stage 1: downsample (1/4, 64ch, switches1) + 4 bottlenecks
    Stage 2: downsample (1/8, 128ch, switches2) + 8 bottlenecks with
             dilation 2/4/8/16 at 2_2/2_4/2_6/2_8 and asymmetric 5x5 at
             2_3/2_7
    Stage 3: the stage-2 pattern again without the downsample
    Stage 4: upsample (1/4, 64ch, consumes switches2) + 2 bottlenecks
    Stage 5: upsample (1/2, 16ch, consumes switches1) + 1 bottleneck
    Final:   transposed conv to ``num_classes`` at full resolution

Submodules carry the flax names (``Initial``, ``Bottleneck1_0``, ...,
``Final``). The seams the kernels plug into are ``forward(...,
return_stage1=True)``, :meth:`ENet.forward_stage23` and
:meth:`ENet.forward_tail`; :meth:`ENet.fused_predict` chains the three
kernels of ``ops/kernels``. The multiscale loss heads are training-only
and are not ported yet (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from .blocks import (Bottleneck, BottleneckDownsample, BottleneckUpsample,
                     Final, Initial)

# (dilation, asymmetric) of Bottleneck{2,3}_1..8
DILATED_SPEC = ((1, False), (2, False), (1, True), (4, False),
                (1, False), (8, False), (1, True), (16, False))


class ENet(nn.Module):
    # input H and W must divide this (three pool/unpool levels)
    input_divisor = 8

    def __init__(self, num_classes: int):
        super().__init__()
        self.num_classes = num_classes
        self.Initial = Initial(3, 16)
        self.Bottleneck1_0 = BottleneckDownsample(16, 64)
        self.stage1 = self._add_blocks(
            (f"Bottleneck1_{i}", Bottleneck(64)) for i in range(1, 5))
        self.Bottleneck2_0 = BottleneckDownsample(64, 128)
        self.stage23 = self._add_blocks(
            (f"Bottleneck{s}_{i}",
             Bottleneck(128, kernel_size=5 if asym else 3,
                        asymmetric=asym, dilation=d))
            for s in (2, 3)
            for i, (d, asym) in enumerate(DILATED_SPEC, start=1))
        self.Bottleneck4_0 = BottleneckUpsample(128, 64)
        self.stage4 = self._add_blocks(
            (f"Bottleneck4_{i}", Bottleneck(64)) for i in (1, 2))
        self.Bottleneck5_0 = BottleneckUpsample(64, 16)
        self.Bottleneck5_1 = Bottleneck(16)
        self.Final = Final(16, num_classes)
        self._packs: Dict[Tuple[str, torch.device], object] = {}

    def _add_blocks(self, named) -> Tuple[str, ...]:
        names = []
        for name, block in named:
            self.add_module(name, block)
            names.append(name)
        return tuple(names)

    def blocks(self, names: Tuple[str, ...]):
        return [getattr(self, n) for n in names]

    # -- kernel weight packs -------------------------------------------

    def packed(self, name: str, device: torch.device,
               build: Callable[["ENet"], object]):
        """The BN-folded weight pack ``build(self)`` for one kernel on
        ``device``, built once and cached until the next
        ``load_state_dict``. Call :meth:`clear_packs` after editing
        weights in place."""
        key = (name, torch.device(device))
        if key not in self._packs:
            with torch.no_grad():
                pack = build(self)
            self._packs[key] = _to_device(pack, key[1])
        return self._packs[key]

    def clear_packs(self) -> None:
        self._packs.clear()

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        self.clear_packs()
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)

    # -- forward and seams ---------------------------------------------

    def forward(self, x: torch.Tensor, return_stage1: bool = False):
        """``x`` NHWC float -> float32 logits ``[N, H, W, classes]``;
        with ``return_stage1`` the stage-1 features and switches."""
        h, switches1 = self.Bottleneck1_0(self.Initial(x))
        for block in self.blocks(self.stage1):
            h = block(h)
        if return_stage1:
            return h, switches1
        y, switches2 = self.forward_stage23(h)
        return self.forward_tail(y, switches2, switches1)

    def forward_stage23(self, x1: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stage-1 features -> (stage-3 features, B2_0 switches)."""
        h, switches2 = self.Bottleneck2_0(x1)
        for block in self.blocks(self.stage23):
            h = block(h)
        return h, switches2

    def forward_tail(self, y: torch.Tensor, switches2: torch.Tensor,
                     switches1: torch.Tensor) -> torch.Tensor:
        """Stages 4 and 5 and Final: stage-3 features and both switch
        tensors (int8, ``[N, h, w*C]``) -> logits."""
        h = self.Bottleneck4_0(y, switches2)
        for block in self.blocks(self.stage4):
            h = block(h)
        h = self.Bottleneck5_0(h, switches1)
        return self.Final(self.Bottleneck5_1(h))

    @torch.no_grad()
    def fused_predict(self, image: torch.Tensor) -> torch.Tensor:
        """Per-pixel argmax labels, int32 ``[N, H, W]``, through the
        front -> mid -> tail kernel chain: on a CUDA tensor the
        hand-written kernels, on a CPU tensor their plain versions.
        Full-resolution logits never reach memory on the kernel path.
        Needs a 3-channel image with H and W divisible by 8."""
        # imported here: ops/kernels/mid.py imports this module
        from ..ops.kernels import front, mid, tail
        n, h, w, c = image.shape
        if c != 3 or h % 8 or w % 8:
            raise ValueError(
                f"fused_predict needs [N,H,W,3] with H, W divisible by "
                f"8, got {tuple(image.shape)}")
        x1, mask1 = front.fused_front_stage1(image, self)
        y, sw2 = mid.fused_mid_stage23(x1, self)
        labels = tail.fused_tail_predict(y, sw2, mask1, self)
        return labels.to(torch.int32)


def _to_device(pack, device):
    """A pack (a tensor or a list of tensors) on ``device``."""
    if isinstance(pack, list):
        return [p.to(device).contiguous() for p in pack]
    return pack.to(device).contiguous()
