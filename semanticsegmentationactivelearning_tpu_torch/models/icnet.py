"""ICNet (arXiv:1704.08545), the PyTorch port of
``semanticsegmentationactivelearning_tpu/models/icnet.py``.

- **Branch 1** (full resolution): three 3x3/s2 conv-BN-ReLU layers
  (32, 32, 64 channels) -> f1 at 1/8.
- **Branch 2** (half resolution, an antialiased bilinear downsample of
  the image): the PSPNet50-style ``SharedStem`` (conv1_1 s2, conv1_2,
  conv1_3, 3x3/s2 max pool, res2_1..3 at 128 channels, res3_1 s2 at
  256) -> f2 at 1/16.
- **Branch 3**: f2 downsampled 2x -> ``LowResTail`` (res3_2..4 at 256,
  res4_1..6 at 512 with dilation 2, res5_1..3 at 1024 with dilation 4,
  sum-fused pyramid pooling, 1x1 reduce to 256) -> f3 at 1/32.
- **CFF1** (f3, f2) and **CFF2** (fused16, f1): 2x bilinear upsample of
  the low input, dilation-2 3x3 conv-BN beside a 1x1 conv-BN of the
  high input, sum, ReLU; each also emits an auxiliary classifier on the
  upsampled low input.
- Head: fused8 -> 2x upsample -> 1x1 classifier (with bias) at 1/4 ->
  4x upsample to full-resolution logits.

``in_channels`` (default 3) sets the input planes of Branch1_1 and the
stem's conv1_1, as flax infers them: more than 3 with stacked
modalities. Such a model scores and serves through its plain forward
(the JAX ``ICNet.fused_score``'s route for them); the front kernels
take RGB only.

Submodules carry the flax names (``Branch1_1``, ``SharedStem``,
``res2_1``, ``LowResTail``, ``CFF1``, ``CFF2``, ``Classifier``, ...), so
``train/bridge.py`` maps the flax tree one to one. BN eps is 1e-3 and
momentum 0.9. ``forward(training=True)`` normalises with the batch's
statistics and moves the running ones (``blocks.BatchNorm``); ICNet has
no dropout, so a train step's generator is taken and ignored. Input H
and W must be multiples of 32. The seams the kernels plug into are
``fuse_from_front``, ``fuse_to_cff1``, ``fuse_from_stem1`` and
``head_pre_logits``;
:meth:`ICNet.fused_score` routes the acquisition score, and
:meth:`ICNet.fused_predict` the served labels, through the front
(+stem) and head kernels of ``ops/kernels``. Not ported: the
``conv_impl`` lowerings, the phase-domain logits, ``_resize_bilinear_up2``
and ``spatial_front_score`` (ROADMAP).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import acquisition
from ..ops import nn as xops
from ..ops.kernels import icnet_front, icnet_head
from .blocks import BatchNorm, Conv, PackedModel, add_blocks


class ConvBN(nn.Module):
    """No-bias SAME conv -> BN (eps 1e-3) -> optional ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int = 1, dilation: int = 1, relu: bool = True):
        super().__init__()
        self.conv = Conv(cin, cout, (kernel, kernel), stride=stride,
                         dilation=dilation)
        self.bn = BatchNorm(cout)
        self.relu = relu

    def forward(self, x: torch.Tensor, training: bool = False
                ) -> torch.Tensor:
        y = self.bn(self.conv(x), training)
        return F.relu(y) if self.relu else y


class Conv1x1Bias(nn.Module):
    """A 1x1 conv with bias (``nn.Conv(use_bias=True)``, the classifier
    heads); ``weight`` is ``[out, in, 1, 1]``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 1, 1))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.xavier_uniform_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight[:, :, 0, 0].t() + self.bias


class ResBottleneck(nn.Module):
    """1x1 reduce -> 3x3 (stride, dilation) -> 1x1 expand, with a 1x1
    projection shortcut when the shape changes; ReLU after the sum."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        width = features // 4
        self.reduce = ConvBN(cin, width, 1)
        self.conv = ConvBN(width, width, 3, stride=stride, dilation=dilation)
        self.expand = ConvBN(width, features, 1, relu=False)
        self.proj = (ConvBN(cin, features, 1, stride=stride, relu=False)
                     if cin != features or stride != 1 else None)

    def forward(self, x: torch.Tensor, training: bool = False
                ) -> torch.Tensor:
        h = self.expand(self.conv(self.reduce(x, training), training),
                        training)
        if self.proj is not None:
            x = self.proj(x, training)
        return F.relu(h + x)


class PyramidPooling(nn.Module):
    """Sum-fused pyramid pooling: ``avg_pool`` with window = stride =
    ``max(h // b, 1)`` per bin (the remainder is dropped; this is not
    adaptive pooling), bilinear upsample back to (h, w), add."""

    bins = (1, 2, 3, 6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        xc = x.permute(0, 3, 1, 2)
        out = x
        for b in self.bins:
            ph, pw = max(h // b, 1), max(w // b, 1)
            pooled = F.avg_pool2d(xc, (ph, pw), stride=(ph, pw))
            out = out + xops.resize_bilinear(pooled.permute(0, 2, 3, 1),
                                             (h, w))
        return out


class CascadeFeatureFusion(nn.Module):
    """CFF unit: ``(relu(low_f + high_f), aux_logits)``."""

    def __init__(self, low_ch: int, high_ch: int, features: int,
                 num_classes: int):
        super().__init__()
        self.aux_cls = Conv1x1Bias(low_ch, num_classes)
        self.low = ConvBN(low_ch, features, 3, dilation=2, relu=False)
        self.high = ConvBN(high_ch, features, 1, relu=False)

    def forward(self, low: torch.Tensor, high: torch.Tensor,
                training: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        low_up = xops.resize_bilinear(low, high.shape[1:3])
        aux_logits = self.aux_cls(low_up)
        return (F.relu(self.low(low_up, training)
                       + self.high(high, training)), aux_logits)


class SharedStem(nn.Module):
    """The PSPNet50 layers shared by branches 2 and 3 (1/8 of its
    input): conv1_1 (s2) -> conv1_2 -> conv1_3 -> 3x3/s2 max pool ->
    res2_1..3 -> res3_1 (s2)."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.conv1_1 = ConvBN(in_channels, 32, 3, stride=2)
        self.conv1_2 = ConvBN(32, 32, 3)
        self.conv1_3 = ConvBN(32, 64, 3)
        self.res2 = add_blocks(self, (
            (f"res2_{i + 1}", ResBottleneck(64 if i == 0 else 128, 128))
            for i in range(3)))
        self.res3_1 = ResBottleneck(128, 256, stride=2)

    def front(self, x: torch.Tensor, training: bool = False
              ) -> torch.Tensor:
        """conv1_1..conv1_3 and the SAME 3x3/s2 max pool (the part the
        front+stem kernels compute): half-res image -> stem1."""
        h = self.conv1_1(x, training)
        h = self.conv1_3(self.conv1_2(h, training), training)
        return xops.max_pool_3x3_same(h)

    def from_pool(self, h: torch.Tensor, training: bool = False
                  ) -> torch.Tensor:
        for name in self.res2:
            h = getattr(self, name)(h, training)
        return self.res3_1(h, training)

    def forward(self, x: torch.Tensor, training: bool = False
                ) -> torch.Tensor:
        return self.from_pool(self.front(x, training), training)


class LowResTail(nn.Module):
    """Branch 3 at 1/32: res3_2..4, dilated res4 and res5, pyramid
    pooling, 1x1 reduce to 256."""

    def __init__(self):
        super().__init__()
        self.blocks = add_blocks(self, [
            *((f"res3_{i + 2}", ResBottleneck(256, 256)) for i in range(3)),
            *((f"res4_{i + 1}", ResBottleneck(256 if i == 0 else 512, 512,
                                              dilation=2))
              for i in range(6)),
            *((f"res5_{i + 1}", ResBottleneck(512 if i == 0 else 1024, 1024,
                                              dilation=4))
              for i in range(3))])
        self.ppm = PyramidPooling()
        self.reduce = ConvBN(1024, 256, 1)

    def forward(self, x: torch.Tensor, training: bool = False
                ) -> torch.Tensor:
        for name in self.blocks:
            x = getattr(self, name)(x, training)
        return self.reduce(self.ppm(x), training)


class ICNet(PackedModel):
    # input H and W must divide this (the 1/32-resolution branch)
    input_divisor = 32
    # fused_score computes the acquisition score without full-resolution
    # logits (train/steps.make_score_step takes it)
    supports_fused_scoring = True
    # no dropout layers, so the MC-dropout measures do not apply
    uses_dropout = False
    # cascade label guidance weights: (1/4 main, 1/8 aux, 1/16 aux)
    ms_loss_weights = (1.0, 0.4, 0.4)
    # the output layer that train/checkpoint.reinitialize_final_layer
    # draws anew (the -r flag)
    output_module = "Classifier"

    def __init__(self, num_classes: int, drop_rates: Sequence[float] = (),
                 in_channels: int = 3):
        super().__init__()
        self.num_classes = num_classes
        self.in_channels = in_channels
        # taken as the JAX dataclass takes it (the CLIs build every model
        # with the conf's rates); ICNet has no dropout layer to use them
        self.drop_rates = tuple(float(r) for r in drop_rates)
        self.Branch1_1 = ConvBN(in_channels, 32, 3, stride=2)
        self.Branch1_2 = ConvBN(32, 32, 3, stride=2)
        self.Branch1_3 = ConvBN(32, 64, 3, stride=2)
        self.SharedStem = SharedStem(in_channels)
        self.LowResTail = LowResTail()
        self.CFF1 = CascadeFeatureFusion(256, 256, 128, num_classes)
        self.CFF2 = CascadeFeatureFusion(128, 64, 128, num_classes)
        self.Classifier = Conv1x1Bias(128, num_classes)

    # -- forward and seams ---------------------------------------------

    def branch1(self, x: torch.Tensor, training: bool = False
                ) -> torch.Tensor:
        """Full-res image -> f1 ``[N, H/8, W/8, 64]``."""
        x = self.Branch1_1(x, training)
        return self.Branch1_3(self.Branch1_2(x, training), training)

    def forward(self, x: torch.Tensor, training: bool = False,
                multiscale: bool = False,
                return_pre_logits: bool = False,
                return_features8: bool = False,
                return_embedding: bool = False,
                generator: Optional[torch.Generator] = None):
        """``x`` NHWC float -> float32 logits ``[N, H, W, classes]``;
        with ``training`` batch norm on the batch's statistics, moving
        the running ones (``generator`` is ignored: no dropout); with
        ``multiscale`` also ``(cls4, aux8, aux16)``; with
        ``return_features8`` the CFF2 output, with ``return_pre_logits``
        the 1/4-res classifier logits, with ``return_embedding`` the CFF2
        output averaged over H and W, float32 ``[N, 128]`` (the pool
        embedding of core-set selection)."""
        _, h, w, _ = x.shape
        if h % 32 or w % 32:
            raise ValueError(
                f"ICNet input dims must be divisible by 32, got {h}x{w}")
        f1 = self.branch1(x, training)
        x_half = xops.resize_bilinear(x, (h // 2, w // 2))
        f2 = self.SharedStem(x_half, training)
        fused16, aux16 = self._cff1(f2, training)
        fused8, aux8 = self.CFF2(fused16, f1, training)
        if return_embedding:
            return fused8.float().mean(dim=(1, 2))
        if return_features8:
            return fused8
        cls4 = self.head_pre_logits(fused8)
        if return_pre_logits:
            return cls4
        logits = xops.resize_bilinear(cls4, (h, w))
        if multiscale:
            return logits, (cls4, aux8, aux16)
        return logits

    def _cff1(self, f2: torch.Tensor, training: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """f2 -> 2x downsample -> LowResTail -> CFF1(f3, f2)."""
        f3 = xops.resize_bilinear(f2, (f2.shape[1] // 2, f2.shape[2] // 2))
        return self.CFF1(self.LowResTail(f3, training), f2, training)

    def fuse_from_front(self, f1: torch.Tensor, x_half: torch.Tensor
                        ) -> torch.Tensor:
        """Stem -> tail -> CFF1 -> CFF2 from Branch1's f1 and the
        half-res image (the front kernel's outputs) -> fused8."""
        fused16, _ = self._cff1(self.SharedStem(x_half))
        return self.CFF2(fused16, f1)[0]

    def fuse_to_cff1(self, stem1: torch.Tensor) -> torch.Tensor:
        """Stem res-blocks -> tail -> CFF1 from the pooled stem features
        -> fused16 (the CFF2 + head kernel's input)."""
        return self._cff1(self.SharedStem.from_pool(stem1))[0]

    def fuse_from_stem1(self, f1: torch.Tensor, stem1: torch.Tensor
                        ) -> torch.Tensor:
        """As :meth:`fuse_from_front`, from the front+stem kernels'
        outputs (f1 and the pooled stem features) -> fused8."""
        return self.CFF2(self.fuse_to_cff1(stem1), f1)[0]

    def head_pre_logits(self, fused8: torch.Tensor) -> torch.Tensor:
        """1/8-res fused features -> 2x upsample -> classifier -> 1/4-res
        logits (float32)."""
        cls = self.Classifier
        return icnet_head.head_pre_logits(fused8, cls.weight[:, :, 0, 0].t(),
                                          cls.bias)

    def _fused_to_head(self, image: torch.Tensor, fuse_stem: bool,
                       fuse_cff2: bool, score: bool):
        """The kernel chain up to the head, shared by :meth:`fused_score`
        (``score``: the front kernels at the score route's precision) and
        :meth:`fused_predict`: ``(fused16, f1)`` when the CFF2 + head
        kernel ends it, else ``(fused8, None)`` for the head kernel."""
        if fuse_stem:
            f1, stem1 = icnet_front.fused_icnet_front_stem(image, self, score)
            if fuse_cff2:
                return self.fuse_to_cff1(stem1), f1
            return self.fuse_from_stem1(f1, stem1), None
        f1, x_half = icnet_front.fused_icnet_front(image, self, score)
        return self.fuse_from_front(f1, x_half), None

    @torch.no_grad()
    def fused_predict(self, image: torch.Tensor, fuse_stem: bool = True,
                      fuse_cff2: bool = True) -> torch.Tensor:
        """Per-pixel argmax labels, int32 ``[N, H, W]``, without
        full-resolution logits in memory: the serving forward
        (reference inference.py:90-98), routed as the JAX
        ``ICNet.fused_predict`` routes it. On a CUDA tensor each route
        runs the hand-written kernels, on a CPU tensor their plain
        versions.

        The front+stem kernels (in 3xTF32), the plain stem res-blocks,
        tail and CFF1, then the CFF2 + head predict kernel; with ``fuse_cff2=False`` the
        plain CFF2 and the head predict kernel; with ``fuse_stem=False``
        the front kernel, the plain stem, tail and CFFs, then the head
        predict kernel. Needs a 3-channel image with H and W multiples
        of 32."""
        _, h, w, c = image.shape
        if c != 3 or h % 32 or w % 32:
            raise ValueError(
                f"ICNet fused_predict needs [N,H,W,3] with H, W divisible "
                f"by 32, got {tuple(image.shape)}")
        x, f1 = self._fused_to_head(image, fuse_stem, fuse_cff2, False)
        if f1 is not None:
            labels = icnet_head.fused_cff2_head8_predict(x, f1, self)
        else:
            wcls, bcls = self.packed("classifier", image.device,
                                     icnet_head.pack_classifier)
            labels = icnet_head.fused_head8_predict(x, wcls, bcls,
                                                    self.num_classes)
        return labels.to(torch.int32)

    @torch.no_grad()
    def fused_score(self, image: torch.Tensor, measure: str,
                    fuse_stem: bool = True, fuse_cff2: bool = True
                    ) -> torch.Tensor:
        """Per-image mean confidence float32 ``[N]`` without
        full-resolution logits in memory: the AL pool-ranking hot loop
        (reference active_learning.py:229-263), routed as the JAX
        ``ICNet.fused_score`` routes it. On a CUDA tensor each route runs
        the hand-written kernels, on a CPU tensor their plain versions.

        Entropy on a 3-channel image: the front+stem kernels (in one TF32
        pass), the plain stem res-blocks, tail and CFF1, then the CFF2 +
        head kernel; with
        ``fuse_cff2=False`` the plain CFF2 and the head kernel; with
        ``fuse_stem=False`` the front kernel (f1 and the half-res image),
        the plain stem, tail and CFFs, then the head kernel. Other
        measures and channel counts: the plain forward to the 1/4-res
        logits and ``acquisition.chunked_upsample_mean_confidence``. H
        and W must be multiples of 32."""
        _, h, w, c = image.shape
        if h % 32 or w % 32:
            raise ValueError(
                f"ICNet input dims must be divisible by 32, got {h}x{w}")
        if measure == "entropy" and c == 3:
            x, f1 = self._fused_to_head(image, fuse_stem, fuse_cff2, True)
            if f1 is not None:
                return icnet_head.fused_cff2_head8_entropy_score(x, f1, self)
            wcls, bcls = self.packed("classifier", image.device,
                                     icnet_head.pack_classifier)
            return icnet_head.fused_head8_entropy_score(
                x, wcls, bcls, self.num_classes)
        cls4 = self(image, return_pre_logits=True)
        return acquisition.chunked_upsample_mean_confidence(
            cls4, 4, measure, self.num_classes)
