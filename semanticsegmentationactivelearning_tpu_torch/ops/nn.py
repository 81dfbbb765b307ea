"""Low-level neural-net ops, the PyTorch port of
``semanticsegmentationactivelearning_tpu/ops/nn.py``.

Tensors keep the JAX package's NHWC layout so both packages compare
like with like. Pooling returns the window position of each maximum
(0..3, row-major, first maximum wins like ``tf.argmax``/``jnp.argmax``)
instead of flat argmax indices; unpooling places each value back at
that position and zeros elsewhere.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Parametrized ReLU with a per-channel (last axis) ``alpha``."""
    return torch.where(x >= 0, x, alpha * x)


def _to_windows(x: torch.Tensor) -> torch.Tensor:
    """``[N,H,W,C] -> [N,H/2,W/2,4,C]`` row-major 2x2 windows."""
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"2x2 pooling needs even spatial dims, got {h}x{w}")
    win = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return win.reshape(n, h // 2, w // 2, 4, c)


def _from_windows(win: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_to_windows`."""
    n, h2, w2, _four, c = win.shape
    out = win.reshape(n, h2, w2, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(n, 2 * h2, 2 * w2, c)


def max_pool_with_switches(x: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """2x2/stride-2 max pool returning ``(pooled, switches)``.

    ``switches`` is int8 ``[N, H/2, (W/2)*C]`` (a free reshape of
    ``[N, H/2, W/2, C]``) holding each maximum's window position,
    first maximum on ties (``torch.argmax`` returns the first one).
    """
    win = _to_windows(x)
    pooled = win.amax(dim=3)
    idx = torch.argmax(win, dim=3).to(torch.int8)
    n, h2, w2, c = pooled.shape
    return pooled, idx.reshape(n, h2, w2 * c)


def switches_to_onehot(switches: torch.Tensor, channels: int,
                       dtype=torch.float32) -> torch.Tensor:
    """Expand int8 switches ``[N,h,w*C]`` to one-hot ``[N,h,w,4,C]``."""
    n, h2, flat = switches.shape
    idx = switches.reshape(n, h2, flat // channels, 1, channels).long()
    pos = torch.arange(4, device=switches.device).view(1, 1, 1, 4, 1)
    return (idx == pos).to(dtype)


def unpool_with_switches(y: torch.Tensor, switches: torch.Tensor
                         ) -> torch.Tensor:
    """Place each pooled value at its recorded window position, zeros
    elsewhere: ``[N,h,w,C] -> [N,2h,2w,C]``."""
    onehot = switches_to_onehot(switches, y.shape[-1], dtype=y.dtype)
    return _from_windows(y[:, :, :, None, :] * onehot)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """Plain 2x2/stride-2 max pool (the Initial block's pool branch)."""
    return _to_windows(x).amax(dim=3)


def resize_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, (N, *hw, C), "bilinear")`` on NHWC ``x``:
    half-pixel centers, edges clamped on the way up, and antialiased on
    the way down (a 2x downsample is the tent (1, 3, 3, 1)/8, its edge
    taps renormalized to (3, 3, 1)/7), which ``F.interpolate`` gives
    with ``antialias=True``. Upsampling is the same either way."""
    h, w = x.shape[1:3]
    down = hw[0] < h or hw[1] < w
    out = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw),
                        mode="bilinear", align_corners=False,
                        antialias=down)
    return out.permute(0, 2, 3, 1)


def max_pool_3x3_same(x: torch.Tensor) -> torch.Tensor:
    """``flax.linen.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")``
    on NHWC ``x``: XLA's SAME rule pads an even size (0, 1), with -inf."""
    ph = same_pads(x.shape[1], 3, 2)
    pw = same_pads(x.shape[2], 3, 2)
    xc = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]),
               value=float("-inf"))
    return F.max_pool2d(xc, 3, stride=2).permute(0, 2, 3, 1)


def same_pads(size: int, k: int, stride: int, dilation: int = 1
              ) -> Tuple[int, int]:
    """(low, high) padding of XLA's "SAME" rule. A stride-2 3x3 window
    on an even size pads (0, 1), not (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer hash of ``x`` in ``[0, 2**32)``, an int or an
    int64 tensor (xor-shift and multiply rounds whose products stay
    below 2**63), the same bits on every device."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x1B873593) & _M32
    return x ^ (x >> 16)


class MCDropout:
    """The spatial-dropout keep masks of MC-dropout passes: pass it as a
    model's ``generator`` in eval (``training=False``) and every
    bottleneck applies dropout at its rate while batch norm stays on
    its running statistics (the JAX blocks' dropout under a "dropout"
    rng with ``training=False``).

    The batch holds ``len(passes)`` copies of ``N`` images stacked pass
    first: row ``j * N + i`` is image ``i`` in pass ``passes[j]``. Each
    dropout call takes the next ``C`` channel slots, and a slot's
    uniform is a hash of ``(key, index[i], pass, slot)``: an image's
    masks depend on the key, the index the caller gives it and the
    pass, not on the rest of the batch or the device. One pass of it in
    train mode is the train step's dropout (``train.steps.
    dropout_masks``: the key a step's, the index a row's in the global
    batch). Each call draws its own slots: ENet's 27 draws a forward
    take over ten times the time of one draw of its 2720 slots, but the
    device stays busy 97% of the MC pass, so the launches overlap its
    work (PERF.md, §6)."""

    def __init__(self, key, index: torch.Tensor, passes):
        key = key if isinstance(key, (tuple, list)) else (key,)
        h = 0x9E3779B9
        for k in key:
            h = _mix32(h ^ (int(k) & _M32))
        index = index.to(torch.int64) & _M32
        passes = torch.as_tensor(list(passes), dtype=torch.int64,
                                 device=index.device)
        rows = _mix32(_mix32(h ^ index)[None, :] ^ (passes[:, None] + 1))
        self.rows = rows.reshape(-1, 1)
        self.offset = 0

    def uniform(self, start: int, count: int) -> torch.Tensor:
        """Float32 uniforms in [0, 1), ``[rows, count]``, of slots
        ``start..start+count``."""
        slots = torch.arange(start, start + count, dtype=torch.int64,
                             device=self.rows.device)
        h = _mix32(self.rows ^ _mix32(slots)[None, :])
        return (h >> 8).to(torch.float32) * 2.0 ** -24

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        c = x.shape[-1]
        u = self.uniform(self.offset, c)
        self.offset += c
        keep = 1.0 - rate
        mask = (u < keep).reshape(x.shape[0], 1, 1, c)
        return torch.where(mask, x / keep, torch.zeros_like(x))


def spatial_dropout(x: torch.Tensor, rate: float,
                    generator=None, training: bool = True) -> torch.Tensor:
    """Channel-wise spatial dropout with noise shape ``[N,1,1,C]``.
    Identity at rate 0 and in eval, unless ``generator`` is an
    :class:`MCDropout`, whose masks it then applies; serving never calls
    it with either."""
    if rate <= 0.0:
        return x
    if isinstance(generator, MCDropout):
        return generator(x, rate)
    if not training:
        return x
    keep = 1.0 - rate
    noise = torch.rand((x.shape[0], 1, 1, x.shape[-1]),
                       generator=generator, device=x.device)
    return torch.where(noise < keep, x / keep, torch.zeros_like(x))
