"""ENet building blocks as ``nn.Module``s, the PyTorch port of
``semanticsegmentationactivelearning_tpu/models/blocks.py``.

Activations are NHWC, as in the JAX package; convolutions run on a
permuted NCHW view. Parameter names mirror the flax tree
(``proj_conv``, ``proj_bn``, ``proj_prelu``, ...) so that
``train/bridge.py`` maps one onto the other by name.

Every block takes ``training`` (default False). In eval, batch norm
uses its running statistics and no dropout is applied. In training,
batch norm normalises with the batch's statistics and updates its
running ones as flax does (momentum 0.9, the biased variance), and the
bottlenecks apply spatial dropout at their ``drop_rate`` with the
caller's ``torch.Generator``. Given an ``ops.nn.MCDropout`` as the
generator in eval, they apply its masks at their ``drop_rate`` and batch
norm keeps its running statistics (MC dropout). The TPU-only pieces of
the JAX blocks (the ``conv_impl`` shifted-matmul lowering, bf16 compute
and phase-domain logits) are not ported.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import nn as xops
from ..parallel import distributed

BN_EPS = 1e-3
# flax BatchNorm(momentum=0.90): running = 0.9 * running + 0.1 * batch
BN_MOMENTUM = 0.9


def add_blocks(module: nn.Module, named) -> Tuple[str, ...]:
    """Register ``(name, block)`` pairs on ``module`` under their flax
    names and return the names in order."""
    names = []
    for name, block in named:
        module.add_module(name, block)
        names.append(name)
    return tuple(names)


# each submodule of a PackedModel that has built a pack -> a weak
# reference to that model, so that an edit of the submodule alone
# (reset_parameters on the output layer) clears the packs built from it
_PACK_OWNERS: "weakref.WeakKeyDictionary[nn.Module, weakref.ref]" = \
    weakref.WeakKeyDictionary()


class PackedModel(nn.Module):
    """A model whose kernels take BN-folded weight packs: ``packed``
    builds each pack once per device and keeps it until the next
    ``load_state_dict`` or :meth:`clear_packs`. A pack does not follow
    an in-place edit of the weights or BN statistics: whoever edits them
    clears the packs (``train.steps.make_train_step`` does after every
    optimizer step, since the step also moves the running statistics;
    :func:`reset_parameters` does for the model that owns the module it
    is given)."""

    def __init__(self):
        super().__init__()
        self._packs: Dict[Tuple[str, torch.device], object] = {}

    def packed(self, name: str, device: torch.device,
               build: Callable[["PackedModel"], object]):
        """The weight pack ``build(self)`` (a tensor or a list of
        tensors) for one kernel on ``device``, built once and cached
        until the next ``load_state_dict``. Call :meth:`clear_packs`
        after editing weights in place."""
        key = (name, torch.device(device))
        if key not in self._packs:
            owner = weakref.ref(self)
            for m in self.modules():
                _PACK_OWNERS[m] = owner
            with torch.no_grad():
                pack = build(self)
            if isinstance(pack, list):
                pack = [p.to(key[1]).contiguous() for p in pack]
            else:
                pack = pack.to(key[1]).contiguous()
            self._packs[key] = pack
        return self._packs[key]

    def clear_packs(self) -> None:
        self._packs.clear()

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        self.clear_packs()
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)


class Conv(nn.Module):
    """No-bias SAME convolution on NHWC tensors; ``weight`` is
    ``[out, in, kh, kw]``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size=(1, 1),
                 stride: int = 1, dilation: int = 1):
        super().__init__()
        kh, kw = kernel_size
        self.stride = stride
        self.dilation = dilation
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kh, kw))
        nn.init.xavier_uniform_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        kh, kw = w.shape[2:]
        if (kh, kw) == (1, 1) and self.stride == 1:
            return x @ w[:, :, 0, 0].t()
        ph = xops.same_pads(x.shape[1], kh, self.stride, self.dilation)
        pw = xops.same_pads(x.shape[2], kw, self.stride, self.dilation)
        xc = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
        out = F.conv2d(xc, w, stride=self.stride, dilation=self.dilation)
        return out.permute(0, 2, 3, 1)


class ConvTranspose(nn.Module):
    """No-bias SAME 3x3/stride-2 transposed convolution on NHWC
    tensors. ``weight`` is ``[in, out, 3, 3]`` and already spatially
    flipped relative to the flax kernel, so this equals
    ``lax.conv_transpose(..., "SAME", transpose_kernel=False)``:
    ``conv_transpose2d(stride=2, padding=0)`` cropped to 2H x 2W."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, 3, 3))
        nn.init.xavier_uniform_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        out = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight,
                                 stride=2)
        return out[:, :, :2 * h, :2 * w].permute(0, 2, 3, 1)


class PReLU(nn.Module):
    """Per-channel parametrized ReLU, ``alpha`` initialised to 0.25."""

    def __init__(self, channels: int, init_alpha: float = 0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), init_alpha))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return xops.prelu(x, self.alpha)


class BatchNorm(nn.Module):
    """Batch norm over the last axis with flax's names mapped to torch's
    (scale/bias/mean/var -> weight/bias/running_mean/running_var) and eps
    1e-3. In train mode under several ranks (``parallel.distributed``)
    its statistics are the global batch's."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def scale_shift(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The affine ``x * s + t`` this layer applies (the kernels fold
        it into the preceding conv)."""
        s = self.weight * torch.rsqrt(self.running_var + BN_EPS)
        return s, self.bias - self.running_mean * s

    def forward(self, x: torch.Tensor, training: bool = False
                ) -> torch.Tensor:
        if not training:
            s, t = self.scale_shift()
            return x * s + t
        if distributed.active():
            return self._forward_global(x)
        # the batch's mean and biased variance over N, H, W; the NCHW
        # view of an NHWC tensor is channels_last, which the CUDA kernel
        # takes as it is. The CPU's channels_last backward sums each
        # channel in float32 one element after another: at 2x128x256 its
        # train step's gradients sit a median 4e-3 from float64 against
        # 4.5e-4 through the contiguous NCHW kernel.
        xc = x.permute(0, 3, 1, 2)
        if xc.device.type == "cpu":
            xc = xc.contiguous()
        out, mean, invstd = torch.native_batch_norm(
            xc, self.weight, self.bias, None, None, True, 0.0, BN_EPS)
        with torch.no_grad():
            var = invstd.pow(-2) - BN_EPS
            self.running_mean.mul_(BN_MOMENTUM).add_(
                mean, alpha=1.0 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(
                var, alpha=1.0 - BN_MOMENTUM)
        return out.permute(0, 2, 3, 1)

    def _forward_global(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the global batch of several ranks, as the JAX
        step's BN reduces over the sharded batch. The statistics: each
        rank's count, mean and M2 per channel (two passes, summed in
        float64 as the CPU's batch norm sums) in a slot of its own,
        summed over the ranks in one all-reduce and merged by Chan's rule
        (no cancellation of E[x^2] - E[x]^2); the running update takes
        the biased variance. The normalisation is
        :class:`_GlobalBatchNorm`, whose backward all-reduces BN's two
        per-channel gradient sums."""
        c = x.shape[-1]
        with torch.no_grad():
            flat = x.reshape(-1, c)
            n = flat.shape[0]
            mean = flat.sum(0, dtype=torch.float64) / n
            m2 = (flat - mean.to(x.dtype)).square().sum(0, dtype=torch.float64)
            m2 -= n * (mean - mean.to(x.dtype).double()).square()
            mine = torch.stack([torch.full_like(mean, n), mean, m2])
            rank = distributed.process_index()
            slots = distributed.all_reduce_sum(torch.stack([
                mine if r == rank else torch.zeros_like(mine)
                for r in range(distributed.process_count())]))
            counts, means, m2 = slots.unbind(1)
            total = counts.sum(0)
            mean = (counts * means).sum(0) / total
            var = (m2.sum(0) + (counts * (means - mean).square()).sum(0)) \
                / total
            mean, var = mean.to(x.dtype), var.to(x.dtype)
            self.running_mean.mul_(BN_MOMENTUM).add_(
                mean, alpha=1.0 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(
                var, alpha=1.0 - BN_MOMENTUM)
        return _GlobalBatchNorm.apply(x, self.weight, self.bias, mean,
                                      torch.rsqrt(var + BN_EPS),
                                      total.to(x.dtype))


class _GlobalBatchNorm(torch.autograd.Function):
    """``(x - mean) * invstd * weight + bias`` over the last axis with the
    global batch's ``mean`` and ``invstd`` (the ``count`` positions of
    every rank), differentiated as batch norm is (and as
    ``nn.SyncBatchNorm`` does): the backward sums ``dy`` and ``dy * (x -
    mean)`` per channel over the ranks in one all-reduce (summed in
    float64) and gives the input's gradient from the global sums, the
    weight's and the bias's from this rank's (the train step sums them
    over the ranks). Autograd through the merged statistics would keep
    the merge's intermediates and all-reduce the slots' gradients
    instead."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, invstd, count):
        ctx.save_for_backward(x, weight, mean, invstd, count)
        return (x - mean) * (invstd * weight) + bias

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd, count = ctx.saved_tensors
        c = x.shape[-1]
        xmu = x - mean
        # summed in float64, as the CPU's batch norm backward sums
        local = torch.stack([
            dy.reshape(-1, c).sum(0, dtype=torch.float64),
            (dy * xmu).reshape(-1, c).sum(0, dtype=torch.float64)])
        sum_dy, sum_dy_xmu = distributed.all_reduce_sum(local.clone()) \
            .to(x.dtype)
        local = local.to(x.dtype)
        dx = (dy - sum_dy / count
              - xmu * (invstd.square() * sum_dy_xmu / count)) \
            * (invstd * weight)
        return dx, local[1] * invstd, local[0], None, None, None


class Initial(nn.Module):
    """3x3/s2 conv (16 - in_ch filters) || 2x2/s2 max pool -> concat ->
    BN -> PReLU."""

    def __init__(self, in_ch: int = 3, out_ch: int = 16):
        super().__init__()
        self.conv = Conv(in_ch, out_ch - in_ch, (3, 3), stride=2)
        self.bn = BatchNorm(out_ch)
        self.prelu = PReLU(out_ch)

    def forward(self, x: torch.Tensor, training: bool = False
                ) -> torch.Tensor:
        out = torch.cat([self.conv(x), xops.max_pool_2x2(x)], dim=-1)
        return self.prelu(self.bn(out, training))


class Bottleneck(nn.Module):
    """Plain / dilated / asymmetric (k x 1 then 1 x k) bottleneck:
    1x1 project (cin/4) -> spatial conv -> 1x1 expand, BN (+PReLU)
    after each, residual add -> PReLU."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 asymmetric: bool = False, dilation: int = 1,
                 projection_rate: int = 4, drop_rate: float = 0.1):
        super().__init__()
        f = channels // projection_rate
        self.drop_rate = drop_rate
        k = kernel_size
        self.asymmetric = asymmetric
        self.dilation = dilation
        self.proj_conv = Conv(channels, f)
        self.proj_bn = BatchNorm(f)
        self.proj_prelu = PReLU(f)
        if asymmetric:
            self.conv_col = Conv(f, f, (k, 1))
            self.conv_row = Conv(f, f, (1, k))
        else:
            self.conv = Conv(f, f, (k, k), dilation=dilation)
        self.conv_bn = BatchNorm(f)
        self.conv_prelu = PReLU(f)
        self.exp_conv = Conv(f, channels)
        self.exp_bn = BatchNorm(channels)
        self.res_prelu = PReLU(channels)

    def spatial(self, h: torch.Tensor) -> torch.Tensor:
        if self.asymmetric:
            return self.conv_row(self.conv_col(h))
        return self.conv(h)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        h = self.proj_prelu(self.proj_bn(self.proj_conv(x), training))
        h = self.conv_prelu(self.conv_bn(self.spatial(h), training))
        h = self.exp_bn(self.exp_conv(h), training)
        h = xops.spatial_dropout(h, self.drop_rate, generator, training)
        return self.res_prelu(h + x)


class BottleneckDownsample(nn.Module):
    """2x2/s2 conv projection (2*cin/4) -> 3x3 conv -> 1x1 expand; the
    residual is a 2x2 max pool with switches, zero-padded in channels.
    Returns ``(out, switches)``."""

    def __init__(self, in_ch: int, out_ch: int, projection_rate: int = 4,
                 drop_rate: float = 0.1):
        super().__init__()
        f = 2 * (in_ch // projection_rate)
        self.out_ch = out_ch
        self.drop_rate = drop_rate
        self.proj_conv = Conv(in_ch, f, (2, 2), stride=2)
        self.proj_bn = BatchNorm(f)
        self.proj_prelu = PReLU(f)
        self.conv = Conv(f, f, (3, 3))
        self.conv_bn = BatchNorm(f)
        self.conv_prelu = PReLU(f)
        self.exp_conv = Conv(f, out_ch)
        self.exp_bn = BatchNorm(out_ch)
        self.res_prelu = PReLU(out_ch)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.proj_prelu(self.proj_bn(self.proj_conv(x), training))
        h = self.conv_prelu(self.conv_bn(self.conv(h), training))
        h = self.exp_bn(self.exp_conv(h), training)
        h = xops.spatial_dropout(h, self.drop_rate, generator, training)
        res, switches = xops.max_pool_with_switches(x)
        res = F.pad(res, (0, self.out_ch - x.shape[-1]))
        return self.res_prelu(h + res), switches


class BottleneckUpsample(nn.Module):
    """1x1 project (cin/4) -> 3x3/s2 transposed conv (cin/8) -> 1x1
    expand; the residual is a 1x1 conv to the output channels unpooled
    with the encoder's switches."""

    def __init__(self, in_ch: int, out_ch: int, projection_rate: int = 4,
                 drop_rate: float = 0.1):
        super().__init__()
        f = in_ch // projection_rate
        self.drop_rate = drop_rate
        self.proj_conv = Conv(in_ch, f)
        self.proj_bn = BatchNorm(f)
        self.proj_prelu = PReLU(f)
        self.deconv = ConvTranspose(f, f // 2)
        self.conv_bn = BatchNorm(f // 2)
        self.conv_prelu = PReLU(f // 2)
        self.exp_conv = Conv(f // 2, out_ch)
        self.exp_bn = BatchNorm(out_ch)
        self.res_conv = Conv(in_ch, out_ch)
        self.res_prelu = PReLU(out_ch)

    def forward(self, x: torch.Tensor, switches: torch.Tensor,
                training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        h = self.proj_prelu(self.proj_bn(self.proj_conv(x), training))
        h = self.conv_prelu(self.conv_bn(self.deconv(h), training))
        h = self.exp_bn(self.exp_conv(h), training)
        h = xops.spatial_dropout(h, self.drop_rate, generator, training)
        res = xops.unpool_with_switches(self.res_conv(x), switches)
        return self.res_prelu(h + res)


class Final(nn.Module):
    """3x3/s2 transposed conv to the class logits (fp32)."""

    def __init__(self, in_ch: int, classes: int):
        super().__init__()
        self.deconv = ConvTranspose(in_ch, classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.deconv(x)


def reset_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Fresh weights for ``model`` (a whole model or one of its modules)
    from the CPU ``generator``, in module order, equal on every device:
    glorot uniform conv and transposed-conv kernels (flax's
    ``glorot_uniform`` law) and zero conv biases, PReLU 0.25, BN scale 1
    and bias 0, running mean 0 and variance 1. Clears the weight packs
    of ``model`` and of the model that built packs from it."""
    with torch.no_grad():
        for m in model.modules():
            weight = getattr(m, "weight", None)
            if isinstance(weight, nn.Parameter) and weight.dim() == 4:
                w = torch.empty(weight.shape)
                nn.init.xavier_uniform_(w, generator=generator)
                weight.copy_(w)
                if isinstance(getattr(m, "bias", None), nn.Parameter):
                    m.bias.zero_()
            elif isinstance(m, PReLU):
                m.alpha.fill_(0.25)
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    owner = _PACK_OWNERS.get(model)
    for packed in (model, owner() if owner is not None else None):
        if isinstance(packed, PackedModel):
            packed.clear_packs()
