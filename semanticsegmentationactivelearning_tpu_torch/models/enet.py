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
return_stage1=True)``, ``forward(..., return_stage4=True)``,
``forward(..., return_pre_logits=True)``, :meth:`ENet.forward_stage23`,
:meth:`ENet.forward_from_stage1`, :meth:`ENet.forward_stage4`,
:meth:`ENet.decode_from_stage4` and :meth:`ENet.forward_tail`.
:meth:`ENet.fused_predict` chains the front, mid and tail-predict
kernels of ``ops/kernels``; :meth:`ENet.fused_score` routes the
acquisition score through the front, mid and one of the three score
kernels.

``in_channels`` (default 3) sets the input planes the Initial block
takes (``16 - in_channels`` conv filters beside the max pool of every
plane), as flax infers it from the input: more than 3 with stacked
modalities (the Freiburg NIR plane). Such a model scores through the
plain encoder and the decoder score kernel; :meth:`ENet.fused_predict`
takes RGB only.

Training: ``forward(x, training=True, generator=g)`` normalises with the
batch's statistics, updates the running ones and applies spatial
dropout at the stage's rate of ``drop_rates`` (Bottleneck1_*: the first,
Bottleneck2_*: the second, Bottleneck3_*: the third, Bottleneck4_*: the
fourth, Bottleneck5_*: the fifth), drawing from ``g``. A model built
with ``multiscale_heads`` holds the multiscale loss heads
``MultiscaleHead_{0,1,2}`` (1x1 no-bias convs to the classes over
B5_1, B4_2 and B3_8), which ``forward(..., multiscale=True)`` returns
beside the logits.

MC dropout (the BALD measure): ``forward(x, generator=masks)`` with an
``ops.nn.MCDropout`` in eval applies each bottleneck's dropout from
``masks`` while batch norm stays on its running statistics.
``forward(x, return_embedding=True)`` returns the mean over H and W of
B3_8's output in float32, ``[N, 128]``, the pool embedding of core-set
selection.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple

import torch

from .blocks import (Bottleneck, BottleneckDownsample, BottleneckUpsample,
                     Conv, Final, Initial, PackedModel, add_blocks)

logger = logging.getLogger(__name__)

HEAD_PREFIX = "MultiscaleHead_"

# (dilation, asymmetric) of Bottleneck{2,3}_1..8
DILATED_SPEC = ((1, False), (2, False), (1, True), (4, False),
                (1, False), (8, False), (1, True), (16, False))


class ENet(PackedModel):
    # input H and W must divide this (three pool/unpool levels)
    input_divisor = 8
    # fused_score computes the acquisition score without full-resolution
    # logits (train/steps.make_score_step takes it)
    supports_fused_scoring = True
    # forward(return_pre_logits=True) gives the half-res features whose
    # classifier is Final.deconv: the MC-dropout score step streams the
    # T full-res probability maps in row chunks
    supports_pre_logits = True
    # the output layer that train/checkpoint.reinitialize_final_layer
    # draws anew (the -r flag)
    output_module = "Final"
    # dropout layers: the MC-dropout measures (BALD) apply
    uses_dropout = True

    def __init__(self, num_classes: int,
                 drop_rates: Sequence[float] = (0.01, 0.1, 0.1, 0.1, 0.1),
                 multiscale_heads: bool = False, in_channels: int = 3):
        super().__init__()
        if len(drop_rates) != 5:
            raise ValueError(
                "Illegal argument value drop_rates, length must be 5.")
        dr = tuple(float(r) for r in drop_rates)
        self.num_classes = num_classes
        self.drop_rates = dr
        self.multiscale_heads = multiscale_heads
        self.in_channels = in_channels
        self.Initial = Initial(in_channels, 16)
        self.Bottleneck1_0 = BottleneckDownsample(16, 64, drop_rate=dr[0])
        self.stage1 = add_blocks(self, (
            (f"Bottleneck1_{i}", Bottleneck(64, drop_rate=dr[0]))
            for i in range(1, 5)))
        self.Bottleneck2_0 = BottleneckDownsample(64, 128, drop_rate=dr[1])
        self.stage23 = add_blocks(self, (
            (f"Bottleneck{s}_{i}",
             Bottleneck(128, kernel_size=5 if asym else 3,
                        asymmetric=asym, dilation=d, drop_rate=dr[s - 1]))
            for s in (2, 3)
            for i, (d, asym) in enumerate(DILATED_SPEC, start=1)))
        self.Bottleneck4_0 = BottleneckUpsample(128, 64, drop_rate=dr[3])
        self.stage4 = add_blocks(self, (
            (f"Bottleneck4_{i}", Bottleneck(64, drop_rate=dr[3]))
            for i in (1, 2)))
        self.Bottleneck5_0 = BottleneckUpsample(64, 16, drop_rate=dr[4])
        self.Bottleneck5_1 = Bottleneck(16, drop_rate=dr[4])
        self.Final = Final(16, num_classes)
        if multiscale_heads:
            # over B5_1 (16 ch), B4_2 (64 ch) and B3_8 (128 ch)
            for i, ch in enumerate((16, 64, 128)):
                self.add_module(f"{HEAD_PREFIX}{i}", Conv(ch, num_classes))

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """As ``nn.Module.load_state_dict``, except for the multiscale
        loss heads, which follow the JAX package's partial restore: a
        model without heads drops them, a model with heads keeps its own
        where the state has none."""
        state = dict(state_dict)
        heads = [k for k in state if k.startswith(HEAD_PREFIX)]
        if not self.multiscale_heads:
            for k in heads:
                del state[k]
        elif not heads:
            logger.info("no multiscale heads in the weights; keeping "
                        "their initialisation")
            state.update({k: v for k, v in self.state_dict().items()
                          if k.startswith(HEAD_PREFIX)})
        return super().load_state_dict(state, strict=strict, assign=assign)

    def blocks(self, names: Tuple[str, ...]):
        return [getattr(self, n) for n in names]

    # -- forward and seams ---------------------------------------------

    def forward(self, x: torch.Tensor, training: bool = False,
                multiscale: bool = False,
                generator: Optional[torch.Generator] = None,
                return_stage1: bool = False, return_stage4: bool = False,
                return_pre_logits: bool = False,
                return_embedding: bool = False):
        """``x`` NHWC float -> float32 logits ``[N, H, W, classes]``;
        with ``multiscale`` ``(logits, (logits, head0(B5_1),
        head1(B4_2), head2(B3_8)))``, the multiscale loss's heads; with
        ``return_stage1`` the stage-1 features and switches, with
        ``return_stage4`` the stage-4 features and the B1_0 switches
        (the decoder score kernel's inputs), with ``return_pre_logits``
        the B5_1 output that the Final layer takes, with
        ``return_embedding`` B3_8's output averaged over H and W, float32
        ``[N, 128]``. ``training`` and ``generator``: see the module
        docstring."""
        if multiscale and not self.multiscale_heads:
            raise ValueError("multiscale needs a model built with "
                             "multiscale_heads=True")
        t, g = training, generator
        h, switches1 = self.Bottleneck1_0(self.Initial(x, t), t, g)
        for block in self.blocks(self.stage1):
            h = block(h, t, g)
        if return_stage1:
            return h, switches1
        y, switches2 = self.forward_stage23(h, t, g)
        if return_embedding:
            return y.float().mean(dim=(1, 2))
        f4 = self.forward_stage4(y, switches2, t, g)
        if return_stage4:
            return f4, switches1
        pre = self.decode_from_stage4(f4, switches1, t, g)
        if return_pre_logits:
            return pre
        logits = self.Final(pre)
        if not multiscale:
            return logits
        heads = tuple(getattr(self, f"{HEAD_PREFIX}{i}")(ep)
                      for i, ep in enumerate((pre, f4, y)))
        return logits, (logits, *heads)

    def forward_stage23(self, x1: torch.Tensor, training: bool = False,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stage-1 features -> (stage-3 features, B2_0 switches)."""
        h, switches2 = self.Bottleneck2_0(x1, training, generator)
        for block in self.blocks(self.stage23):
            h = block(h, training, generator)
        return h, switches2

    def forward_from_stage1(self, x1: torch.Tensor) -> torch.Tensor:
        """Stages 2 through 4: stage-1 features -> stage-4 features."""
        y, switches2 = self.forward_stage23(x1)
        return self.forward_stage4(y, switches2)

    def forward_stage4(self, y: torch.Tensor, switches2: torch.Tensor,
                       training: bool = False,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
        """Stage 4: stage-3 features and the B2_0 switches (int8,
        ``[N, h, w*64]``) -> stage-4 features ``[N, 2h, 2w, 64]``."""
        h = self.Bottleneck4_0(y, switches2, training, generator)
        for block in self.blocks(self.stage4):
            h = block(h, training, generator)
        return h

    def decode_from_stage4(self, f4: torch.Tensor, switches1: torch.Tensor,
                           training: bool = False,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
        """Stage 5: stage-4 features and the B1_0 switches (int8,
        ``[N, h, w*16]``) -> the pre-logits ``[N, 2h, 2w, 16]``."""
        h = self.Bottleneck5_0(f4, switches1, training, generator)
        return self.Bottleneck5_1(h, training, generator)

    def forward_tail(self, y: torch.Tensor, switches2: torch.Tensor,
                     switches1: torch.Tensor) -> torch.Tensor:
        """Stages 4 and 5 and Final: stage-3 features and both switch
        tensors (int8, ``[N, h, w*C]``) -> logits."""
        f4 = self.forward_stage4(y, switches2)
        return self.Final(self.decode_from_stage4(f4, switches1))

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

    @torch.no_grad()
    def fused_score(self, image: torch.Tensor, measure: str,
                    fuse_decoder: bool = True, fuse_front: bool = True,
                    fuse_mid: bool = True, fuse_tail: bool = True
                    ) -> torch.Tensor:
        """Per-image mean confidence float32 ``[N]`` without
        full-resolution logits in memory on the kernel routes: the AL
        pool-ranking hot loop (reference active_learning.py:229-263),
        routed as the JAX ``ENet.fused_score`` routes it. On a CUDA
        tensor each route runs the hand-written kernels, on a CPU tensor
        their plain versions.

        Entropy with ``fuse_decoder``: on 3-channel inputs at least 24
        rows tall the front kernel, then the mid kernel (or the plain
        stages 2-3 without ``fuse_mid``), then the tail score kernel
        where H/8 >= 6 and ``fuse_tail``, else plain stage 4 and the
        decoder score kernel on the front's mask. Other inputs take the
        plain encoder to stage 4 and the decoder score kernel on the
        switches. Entropy without ``fuse_decoder``: the plain forward to
        the pre-logits and the deconv score kernel (the tail's Final on
        the tensor cores, on the Final's GEMM record, packed once a
        model and device). Other measures:
        ``acquisition.chunked_deconv_mean_confidence``. H and W must be
        multiples of 8."""
        # imported here: ops/kernels/mid.py imports this module
        from ..ops import acquisition
        from ..ops.kernels import (deconv_score, decoder, front, mid,
                                   packing, tail)
        n, h, w, c = image.shape
        if h % 8 or w % 8:
            raise ValueError(f"fused_score needs H, W divisible by 8, got "
                             f"{tuple(image.shape)}")
        # the JAX kernels' halo windows set these limits; the port keeps
        # its routes
        fuse_tail = fuse_tail and h // 8 >= 6
        fuse_front = fuse_front and h >= 24 and c == 3
        if measure == "entropy" and fuse_decoder:
            if not fuse_front:
                f4, switches1 = self(image, return_stage4=True)
                return decoder.fused_decoder_entropy_score(f4, switches1,
                                                           self)
            x1, mask1 = front.fused_front_stage1(image, self, score=True)
            if fuse_mid:
                y, sw2 = mid.fused_mid_stage23(x1, self, score=True)
            else:
                y, sw2 = mid.mid_stage23_plain(x1, self)
            if fuse_tail:
                return tail.fused_tail_entropy_score(y, sw2, mask1, self)
            f4 = self.forward_stage4(y, sw2.reshape(n, h // 8, w // 8 * 64))
            return decoder.fused_decoder_entropy_score(f4, None, self,
                                                       mask=mask1)
        features = self(image, return_pre_logits=True)
        kernel = self.packed("final", image.device,
                             lambda m: packing.deconv_hwio(m.Final.deconv))
        if measure == "entropy":
            record = self.packed("final_record", image.device,
                                 lambda m: tail.pack_final(
                                     packing.deconv_hwio(m.Final.deconv),
                                     m.num_classes))
            return deconv_score.fused_deconv_entropy_score(
                features, kernel, self.num_classes, record=record)
        return acquisition.chunked_deconv_mean_confidence(
            features, kernel, measure, self.num_classes)
