"""Build and bind the hand-written CUDA kernels of ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one process per
source, all started together, and links the objects into one shared
library with a plain C interface, ``build/kernels/<hash>/
libssal_torch_kernels.so`` beside the package, keyed by a hash of the
sources and flags; ``ctypes`` loads it. The first call of
:func:`library` in a process builds it if it is missing (a few
seconds). Each C entry launches on the stream it is given and returns
the ``cudaError_t`` of the launch, which :func:`check` turns into an
exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD_ROOT = PACKAGE.parent / "build" / "kernels"
LIB_NAME = "libssal_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry -> (argtypes, restype); every launch takes the stream last
SIGNATURES = {
    "ssal_front_pack_size": ([], _I),
    "ssal_front_b10": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "ssal_front_block": ([_P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    "ssal_mid_pack_size": ([_I], _I),
    "ssal_mid_b20": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "ssal_mid_proj": ([_P, _P, _P, _I, _I, _P], _I),
    "ssal_mid_block": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P], _I),
    "ssal_tail_pack_size": ([_I], _I),
    "ssal_tail_partials": ([_I, _I], _I),
    "ssal_tail_stage4": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "ssal_tail_decode_predict": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "ssal_tail_decode_score": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "ssal_deconv_partials": ([_I, _I], _I),
    "ssal_deconv_score": ([_P, _P, _P, _I, _I, _I, _I, _P], _I),
    "ssal_icnet_front_pack_size": ([], _I),
    "ssal_icnet_front_part": ([_I, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "ssal_head8_partials": ([_I, _I], _I),
    "ssal_head8_score": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "ssal_head8_predict": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "ssal_cff2_head_pack_size": ([_I], _I),
    "ssal_cff2_head_partials": ([_I, _I], _I),
    "ssal_cff2_head_score": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "ssal_cff2_head_predict": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "ssal_cff2_fused8": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    "ssal_probe_launch_max_consts": ([], _I),
    "ssal_probe_launch": ([_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I,
                           _P], _I),
    "ssal_probe_matmul_block_rows": ([_I, _I], _I),
    "ssal_probe_matmul": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P], _I),
}


@dataclass(frozen=True)
class Build:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str        # nvcc's output (ptxas registers and spills), kept
                    # beside the library


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH): the CUDA kernels "
                       "cannot be built")


def build() -> Build:
    """Compile the library unless this exact source set is built."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    log_file = out_dir / "nvcc.log"
    if lib.exists():
        return Build(lib, 0.0,
                     log_file.read_text() if log_file.exists() else "")
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        cus = [s for s in sources() if s.suffix == ".cu"]
        objs = [Path(tmp) / (s.stem + ".o") for s in cus]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(cus, objs)]
        log = [p.communicate()[0] for p in procs]  # wait for every one
        for src, p, out in zip(cus, procs, log):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        part = Path(tmp) / LIB_NAME
        res = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                              str(part), *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stdout
                               + res.stderr)
        log_file.write_text("".join(log))
        os.replace(part, lib)
    return Build(lib, time.perf_counter() - t0, "".join(log))


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build().path))
    for name, (args, res) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    return lib


def check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` whose
    shape matches ``shape`` (``None`` entries match any size)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_pack(pack: torch.Tensor, size: int, name: str) -> None:
    if pack.numel() != size:
        raise ValueError(f"{name} weight pack has {pack.numel()} floats, "
                         f"the kernel expects {size}")
