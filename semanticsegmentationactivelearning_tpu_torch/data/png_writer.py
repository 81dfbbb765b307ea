"""Asynchronous PNG prediction-map writer for the serving loop.

The reference encoded prediction PNGs *in-graph* and wrote them with
``tf.io.write_file`` as part of the same ``sess.run`` that ran the
forward pass (reference inference.py:111-119) — encode and device
compute overlapped inside the TF runtime. The rebuild's equivalent:
the inference CLI hands each predicted batch to this writer, which
encodes + writes on a background thread (native libpng thread pool via
``csrc/ssal_io.cc`` when built, PIL thread pool otherwise) while the
next batch's forward runs on the device. Without this, host PNG encode
(~10-40 ms/image at 1024x2048) serializes behind every predict dispatch
and caps end-to-end serving throughput.

Backpressure: at most ``depth`` batches may be in flight; ``submit``
blocks on the oldest once the pipe is full, bounding host memory to
``depth`` decoded batches. Errors surface on the next ``submit`` or on
``close()``.
"""

from __future__ import annotations

import concurrent.futures
import os
from collections import deque
from typing import Optional, Sequence

import numpy as np

from . import native


def _write_batch_pil(paths: Sequence[Optional[str]],
                     stack: np.ndarray) -> None:
    from . import etl
    for i, path in enumerate(paths):
        if path is None:
            continue
        with open(path, "wb") as fp:
            fp.write(etl.encode_png(np.ascontiguousarray(stack[i])))


class AsyncPngWriter:
    """Double-buffered background PNG writer.

    ``submit(paths, stack)`` schedules one batch (``paths[i] is None``
    skips slot ``i``); ``close()`` drains the queue and re-raises the
    first encode/write error. The caller must not mutate ``stack``
    after submitting (the serving loop's ``np.asarray(predict(...))``
    is a fresh array per batch, so this holds for free).
    """

    def __init__(self, depth: int = 2,
                 use_native: Optional[bool] = None):
        if use_native is None:
            use_native = native.encode_available()
        self._use_native = use_native
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="png-writer")
        self._pending: deque = deque()
        self._depth = max(1, depth)
        self.written = 0

    def _write(self, paths, stack):
        if self._use_native:
            native.write_png_batch(paths, stack)
        else:
            _write_batch_pil(paths, stack)
        return sum(1 for p in paths if p is not None)

    def submit(self, paths: Sequence[Optional[str]],
               stack: np.ndarray) -> None:
        while len(self._pending) >= self._depth:
            self.written += self._pending.popleft().result()
        self._pending.append(
            self._pool.submit(self._write, list(paths), stack))

    def close(self) -> int:
        """Drain and shut down; returns the total files written."""
        try:
            while self._pending:
                self.written += self._pending.popleft().result()
        finally:
            self._pool.shutdown(wait=True)
        return self.written

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:  # don't mask the original error; still stop the thread
            self._pool.shutdown(wait=False, cancel_futures=True)
        return False


__all__ = ["AsyncPngWriter"]
