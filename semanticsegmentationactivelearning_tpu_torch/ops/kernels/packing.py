"""BN folding and weight packing for the kernels of ``csrc/``.

A pack is one flat float32 tensor that the C entries read at fixed
offsets: GEMM records (``csrc/tc.cuh`` ``Layer``: :func:`gemm_record`)
and the few tables beside them. Weights go to the JAX
package's HWIO layout ``[kh, kw, in, out]``; an eval BatchNorm
``x * s + t`` after a conv folds into ``w * s`` (per output channel)
and a shift ``t``.
"""

from __future__ import annotations

from typing import List

import torch


def hwio(conv) -> torch.Tensor:
    """A ``blocks.Conv`` weight ``[out, in, kh, kw]`` as HWIO."""
    return conv.weight.detach().permute(2, 3, 1, 0)


def deconv_hwio(deconv) -> torch.Tensor:
    """A ``blocks.ConvTranspose`` weight (flipped ``[in, out, kh, kw]``)
    as the JAX kernel ``[kh, kw, in, out]`` of the polyphase identity."""
    return deconv.weight.detach().flip(2, 3).permute(2, 3, 0, 1)


def affine(w_hwio: torch.Tensor, bn, prelu=None) -> List[torch.Tensor]:
    """``[w * s, t]`` (+ PReLU alpha) for a conv followed by ``bn``."""
    s, t = bn.scale_shift()
    parts = [w_hwio * s, t]
    if prelu is not None:
        parts.append(prelu.alpha)
    return parts


def bstride(n: int) -> int:
    """The weights' row stride in shared memory: the smallest s >= n
    with s % 32 in (8, 24), so that a B fragment's reads hit 32 banks."""
    s = n
    while s % 32 not in (8, 24):
        s += 8
    return s


def gemm_record(w: torch.Tensor, k: int, n: int,
                vecs=()) -> List[torch.Tensor]:
    """``w [taps, k0, n0]`` zero-padded to ``[taps, k, bstride(n)]``, then
    each vector zero-padded to ``n``, on ``w``'s device."""
    t, k0, n0 = w.shape
    out = torch.zeros(t, k, bstride(n), device=w.device)
    out[:, :k0, :n0] = w
    parts = [out]
    for v in vecs:
        pv = torch.zeros(n, device=w.device)
        pv[:v.numel()] = v.detach().reshape(-1)
        parts.append(pv)
    return parts


def vec4_order(k: int) -> torch.Tensor:
    """The order of a record's k rows where the kernel reads A 16 bytes a
    lane (``csrc/tc.cuh`` ``gemm`` VEC4): within each 16, row 8s + j
    holds k 4(j % 4) + j // 4 + 2s."""
    return torch.tensor([16 * g + 4 * (j % 4) + j // 4 + 2 * s
                         for g in range(k // 16) for s in (0, 1)
                         for j in range(8)])


def conv_taps(conv, bn, prelu=None):
    """(w * s [kh*kw, in, out], [t, alpha]) of a conv + BN (+ PReLU)."""
    w, *vecs = affine(hwio(conv), bn, prelu)
    kh, kw, i, o = w.shape
    return w.reshape(kh * kw, i, o), vecs


def flat(parts: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1).float() for p in parts]) \
        .contiguous()
