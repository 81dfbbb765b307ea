"""The rig kernels' wrappers, their plain PyTorch versions, inputs and
timing.

- :func:`probe_launch` (``csrc/probe_launch.cu``, the port of the Pallas
  rig of ``tools/probe_pallas_overhead.py:81``): ``y [N, H8, W8, 128]``,
  ``sw [N, H8, W8, 64]``, ``m1 [N, H8, W8, 256]`` float32 and a list of
  float32 constants -> ``(centre, reads)`` float32 ``[N, H8/te]``: the
  sum of each centre ``y`` row tile, and the sum of everything a grid
  cell reads (the ``y``, ``sw`` and ``m1`` row tiles at offsets -1, 0,
  +1 clipped to the grid, and every constant).
- :func:`probe_matmul` (``csrc/probe_matmul.cu``, the port of the Pallas
  rigs of ``tools/probe_mosaic_floor.py:103`` and
  ``tools/probe_front_packing.py:134``): ``a [T, rows, 128]`` and ``w
  [128, N]``, both bfloat16 or both float32 -> float32 ``[T]``, per tile
  the sum of ``m`` products ``a @ w`` (``indep``) or of the end of the
  chain ``cur <- round(f(cur @ w))`` (``chain``: f the identity,
  ``prelu``: PReLU 0.25, ``nside``: the 16 output columns tiled back to
  128), rounding to the input's dtype, accumulating in float32.

Each wrapper launches its kernel on CUDA tensors, runs the plain version
on CPU tensors, raises for anything else, and counts its launches in a
``launches`` attribute.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Sequence

import numpy as np
import torch

from ..ops.kernels import build

MODES = {"indep": 0, "chain": 1, "prelu": 2, "nside": 3}
# the launch rig's constants, in turn (tools/probe_pallas_overhead.py)
CONST_SHAPES = ((1, 256), (256, 256), (4, 128, 256))
STREAM_CHANNELS = (128, 64, 256)  # y, sw, m1


def require_cuda() -> torch.device:
    """The first CUDA device; a rig measures nothing on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("the rigs measure a CUDA device and none is "
                           "available")
    return torch.device("cuda")


def cuda_ms(fn: Callable[[], object], iters: int) -> float:
    """Median CUDA-event time of one ``fn()`` over ``iters`` calls after
    one warm-up call."""
    fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# -- the launch rig --------------------------------------------------------

def launch_inputs(batch: int, h8: int, w8: int, nconst: int, seed: int,
                  device) -> tuple:
    """Normal ``(y, sw, m1, consts)`` made on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    streams = [randn(batch, h8, w8, c) for c in STREAM_CHANNELS]
    consts = [randn(*CONST_SHAPES[i % 3]) for i in range(nconst)]
    return (*streams, consts)


def _launch_tiles(h8: int, te: int) -> int:
    if te < 1 or h8 % te:
        raise ValueError(f"H8 = {h8} must be a multiple of te = {te}")
    return h8 // te


def launch_read_bytes(y, sw, m1, consts, te: int) -> int:
    """The bytes the rig reads a call: three row tiles of each stream
    and every constant, for every grid cell."""
    n, h8 = y.shape[:2]
    tiles = _launch_tiles(h8, te)
    tile_bytes = sum(x[:, :te].numel() // n * x.element_size()
                     for x in (y, sw, m1))
    const_bytes = sum(c.numel() * c.element_size() for c in consts)
    return n * tiles * (3 * tile_bytes + const_bytes)


def probe_launch_plain(y: torch.Tensor, sw: torch.Tensor, m1: torch.Tensor,
                       consts: Sequence[torch.Tensor], te: int) -> tuple:
    """The plain PyTorch version: per-tile sums of the streams, gathered
    at the clipped offsets."""
    n, h8 = y.shape[:2]
    tiles = _launch_tiles(h8, te)
    idx = torch.arange(tiles, device=y.device)
    reads = torch.zeros((n, tiles), device=y.device)
    for x in (y, sw, m1):
        per_tile = x.reshape(n, tiles, -1).sum(dim=-1)
        for off in (-1, 0, 1):
            reads = reads + per_tile[:, (idx + off).clamp(0, tiles - 1)]
    for c in consts:
        reads = reads + c.sum()
    return y.reshape(n, tiles, -1).sum(dim=-1), reads


def probe_launch(y: torch.Tensor, sw: torch.Tensor, m1: torch.Tensor,
                 consts: Sequence[torch.Tensor], te: int) -> tuple:
    """``(centre, reads)`` float32 ``[N, H8/te]``: the CUDA kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if y.device.type == "cpu":
        return probe_launch_plain(y, sw, m1, consts, te)
    build.require(y, "y", torch.float32, (None, None, None, 128))
    n, h8, w8, _ = y.shape
    build.require(sw, "sw", torch.float32, (n, h8, w8, 64))
    build.require(m1, "m1", torch.float32, (n, h8, w8, 256))
    tiles = _launch_tiles(h8, te)
    lib = build.library()
    if len(consts) > lib.ssal_probe_launch_max_consts():
        raise ValueError(f"at most {lib.ssal_probe_launch_max_consts()} "
                         f"constants, got {len(consts)}")
    for i, c in enumerate(consts):
        build.require(c, f"constant {i}", torch.float32, tuple(c.shape))
    for name, t in (("y", y), ("sw", sw), ("m1", m1),
                    *((f"constant {i}", c) for i, c in enumerate(consts))):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    k = max(len(consts), 1)
    ptrs = (ctypes.c_void_p * k)(*[c.data_ptr() for c in consts])
    sizes = (ctypes.c_int * k)(*[c.numel() for c in consts])
    centre = torch.empty((n, tiles), device=y.device)
    reads = torch.empty((n, tiles), device=y.device)
    with torch.cuda.device(y.device):
        build.check(lib.ssal_probe_launch(
            build.ptr(y), build.ptr(sw), build.ptr(m1),
            ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(sizes, ctypes.c_void_p), len(consts),
            build.ptr(centre), build.ptr(reads), n, h8, w8, te,
            build.stream_of(y)), "launch rig kernel")
    probe_launch.launches += 1
    return centre, reads


probe_launch.launches = 0


# -- the matmul-stream rig ---------------------------------------------------

def matmul_inputs(tiles: int, rows: int, n_cols: int, dtype: torch.dtype,
                  seed: int, device) -> tuple:
    """``(a [tiles, rows, 128], w [128, n_cols])`` of ``dtype``: normal
    values / 16, as the TPU rigs made them (a product keeps the scale
    within a factor of about 0.7)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((tiles, rows, 128), generator=gen, device=device) / 16
    w = torch.randn((128, n_cols), generator=gen, device=device) / 16
    return a.to(dtype), w.to(dtype)


def matmul_flops(a: torch.Tensor, w: torch.Tensor, m: int) -> float:
    """The multiply-adds a call issues, as FLOPs."""
    tiles, rows, k = a.shape
    return 2.0 * tiles * rows * k * w.shape[1] * m


def _check_matmul(a, w, m: int, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode}")
    want = 16 if mode == "nside" else 128
    if a.dim() != 3 or a.shape[2] != 128 or tuple(w.shape) != (128, want):
        raise ValueError(f"mode {mode} takes a [T, rows, 128] and w [128, "
                         f"{want}], got {tuple(a.shape)} and "
                         f"{tuple(w.shape)}")
    if a.dtype not in (torch.bfloat16, torch.float32) or w.dtype != a.dtype:
        raise TypeError(f"a and w must both be bfloat16 or both float32, "
                        f"got {a.dtype} and {w.dtype}")
    if m < 1:
        raise ValueError(f"m must be at least 1, got {m}")


def matmul_final_plain(a: torch.Tensor, w: torch.Tensor, m: int,
                       mode: str) -> torch.Tensor:
    """The values the rig sums, float32 ``[T, rows * width]``: the
    float32 sum of the products (indep) or the end of the chain, one
    ``[T*rows, 128] x [128, N]`` float32 product a step over every tile
    at once."""
    _check_matmul(a, w, m, mode)
    tiles, rows, k = a.shape
    x, wf = a.reshape(tiles * rows, k), w.float()
    if mode == "indep":
        acc = torch.zeros((tiles * rows, w.shape[1]), device=a.device)
        for _ in range(m):
            acc += x.float() @ wf
        return acc.reshape(tiles, -1)
    cur = x
    for _ in range(m):
        t = cur.float() @ wf
        if mode == "prelu":
            t = t.clamp(min=0) + 0.25 * t.clamp(max=0)
        elif mode == "nside":
            t = t.repeat(1, k // t.shape[1])
        cur = t.to(a.dtype)
    return cur.float().reshape(tiles, -1)


def probe_matmul_plain(a: torch.Tensor, w: torch.Tensor, m: int,
                       mode: str) -> torch.Tensor:
    """The plain PyTorch version: the sums of :func:`matmul_final_plain`
    per tile."""
    return matmul_final_plain(a, w, m, mode).sum(dim=1)


def probe_matmul(a: torch.Tensor, w: torch.Tensor, m: int,
                 mode: str) -> torch.Tensor:
    """float32 ``[T]``: the CUDA kernel on CUDA tensors (bf16 on the
    tensor cores, fp32 on the CUDA cores), the plain version on CPU
    tensors."""
    if a.device.type == "cpu":
        return probe_matmul_plain(a, w, m, mode)
    _check_matmul(a, w, m, mode)
    build.require(a, "a", a.dtype, (None, None, 128))
    build.require(w, "w", a.dtype, tuple(w.shape))
    tiles, rows, _ = a.shape
    n_cols, bf16 = w.shape[1], int(a.dtype == torch.bfloat16)
    lib = build.library()
    block_rows = lib.ssal_probe_matmul_block_rows(n_cols, bf16)
    if rows % block_rows:
        raise ValueError(f"rows = {rows} must be a multiple of {block_rows} "
                         f"({a.dtype}, N = {n_cols})")
    partials = torch.empty((tiles, rows // block_rows), device=a.device)
    with torch.cuda.device(a.device):
        build.check(lib.ssal_probe_matmul(
            build.ptr(a), build.ptr(w), build.ptr(partials), tiles, rows,
            n_cols, m, MODES[mode], bf16, build.stream_of(a)),
            f"matmul rig kernel ({mode}, {a.dtype})")
    probe_matmul.launches += 1
    return partials.sum(dim=1)


probe_matmul.launches = 0


def dtype_named(name: str) -> torch.dtype:
    return {"bf16": torch.bfloat16, "fp32": torch.float32}[name]


def split(arg: str) -> List[str]:
    return [s for s in arg.split(",") if s]
