"""ctypes bindings for the native IO library (csrc/ssal_io.cc).

The C++ side does the whole per-example hot path — TFRecord framing,
Example wire scan, libpng/libjpeg decode — writing straight into the
batch stack with an internal thread pool (the tf.data-C++-runtime role
in the reference). Falls back gracefully: ``available()`` is False when
the library is absent and can't be built, and pure-Python paths in
``loader.py``/``tfrecord.py`` take over.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "csrc")
_LIB_PATH = os.path.join(_CSRC_DIR, "libssal_io.so")

_lib = None
_load_attempted = False


def _try_build() -> bool:
    makefile = os.path.join(_CSRC_DIR, "Makefile")
    if not os.path.exists(makefile):
        return False
    try:
        subprocess.run(["make", "-C", _CSRC_DIR], check=True,
                       capture_output=True, timeout=120)
        return os.path.exists(_LIB_PATH)
    except (subprocess.SubprocessError, OSError) as exc:
        logger.debug("native IO build failed: %s", exc)
        return False


def _load():
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    if not os.path.exists(_LIB_PATH) and not _try_build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as exc:
        logger.warning("could not load native IO library: %s", exc)
        return None
    lib.ssal_crc32c.restype = ctypes.c_uint32
    lib.ssal_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.ssal_masked_crc32c.restype = ctypes.c_uint32
    lib.ssal_masked_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.ssal_load_batch.restype = ctypes.c_int
    lib.ssal_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t]
    if hasattr(lib, "ssal_write_png_batch"):
        lib.ssal_write_png_batch.restype = ctypes.c_int
        lib.ssal_write_png_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def crc32c(data: bytes) -> int:
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    return int(lib.ssal_crc32c(data, len(data)))


def masked_crc32c(data: bytes) -> int:
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    return int(lib.ssal_masked_crc32c(data, len(data)))


def load_batch(paths: Sequence[str], storage_hw: Tuple[int, int],
               channels: int = 3, fill_label: int = 255,
               num_threads: Optional[int] = None):
    """Decode ``paths`` into a fresh uint8 stack
    ``[n, H, W, channels+1]``; returns (stack, heights, widths,
    has_label). Raises ValueError naming the failing file on error."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    n = len(paths)
    sh, sw = storage_hw
    stack = np.empty((n, sh, sw, channels + 1), dtype=np.uint8)
    heights = np.zeros(n, dtype=np.int32)
    widths = np.zeros(n, dtype=np.int32)
    has_label = np.zeros(n, dtype=np.int32)
    c_paths = (ctypes.c_char_p * n)(
        *[p.encode() for p in paths])
    err = ctypes.create_string_buffer(512)
    if num_threads is None:
        num_threads = min(max(os.cpu_count() - 1, 1), 16)
    rc = lib.ssal_load_batch(
        c_paths, n, stack.ctypes.data_as(ctypes.c_void_p), sh, sw,
        channels, fill_label,
        heights.ctypes.data_as(ctypes.c_void_p),
        widths.ctypes.data_as(ctypes.c_void_p),
        has_label.ctypes.data_as(ctypes.c_void_p),
        num_threads, err, 512)
    if rc != 0:
        raise ValueError(
            f"native decode failed for {paths[rc - 1]}: "
            f"{err.value.decode()}")
    return stack, heights, widths, has_label.astype(bool)


def encode_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "ssal_write_png_batch")


def write_png_batch(paths: Sequence[Optional[str]], stack: np.ndarray,
                    num_threads: Optional[int] = None) -> None:
    """Encode a uint8 stack ``[n,H,W]`` (gray) or ``[n,H,W,3]`` (RGB) to
    PNG files with a native thread pool; ``paths[i] is None`` skips slot
    ``i`` (padded tail entries). Raises ValueError naming the failing
    file on error."""
    lib = _load()
    if lib is None or not hasattr(lib, "ssal_write_png_batch"):
        raise RuntimeError("native PNG encoder unavailable")
    stack = np.ascontiguousarray(stack)
    if stack.dtype != np.uint8:
        raise ValueError("stack must be uint8")
    if stack.ndim == 3:
        n, h, w = stack.shape
        channels = 1
    elif stack.ndim == 4 and stack.shape[-1] in (1, 3):
        n, h, w, channels = stack.shape
    else:
        raise ValueError(f"bad stack shape {stack.shape}")
    if len(paths) != n:
        raise ValueError("len(paths) != stack batch dim")
    c_paths = (ctypes.c_char_p * n)(
        *[None if p is None else p.encode() for p in paths])
    err = ctypes.create_string_buffer(512)
    if num_threads is None:
        num_threads = min(max((os.cpu_count() or 2) - 1, 1), 16)
    rc = lib.ssal_write_png_batch(
        c_paths, stack.ctypes.data_as(ctypes.c_void_p), n, h, w,
        channels, num_threads, err, 512)
    if rc != 0:
        raise ValueError(
            f"native png encode failed for {paths[rc - 1]}: "
            f"{err.value.decode()}")
