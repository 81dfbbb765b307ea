"""Host -> device transfer overlap for the serving loop, the PyTorch
port of ``semanticsegmentationactivelearning_tpu/data/device_prefetch.py``.

``device_prefetch`` wraps a host batch iterator and starts copying the
next ``depth`` batches' large arrays to the device while the current
batch computes. On a CUDA device each array is copied from pinned host
memory with ``non_blocking=True`` on a side stream, and the consumer's
stream waits on an event recorded after the copy before the batch is
handed out. On the CPU the arrays are wrapped without a copy.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator, Sequence

import torch


def device_prefetch(batches: Iterable[dict], device,
                    keys: Sequence[str] = ("stack",),
                    depth: int = 2) -> Iterator[dict]:
    """Yield batches with ``keys`` as tensors on ``device``, ``depth``
    transfers ahead of the batch being consumed.

    :param batches: iterator of dict batches (host numpy arrays)
    :param device:  target ``torch.device`` (or its name)
    :param keys:    dict entries to transfer; the rest stays on the host
    :param depth:   transfers in flight ahead of the consumer
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    device = torch.device(device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None

    def _put(b: dict):
        out = dict(b)
        for k in keys:
            if k not in out:
                continue
            host = torch.from_numpy(out[k])
            if cuda:
                with torch.cuda.stream(side):
                    out[k] = host.pin_memory().to(device, non_blocking=True)
            else:
                out[k] = host
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(side)
        return out, event

    it = iter(batches)
    queue: collections.deque = collections.deque()
    try:
        try:
            for _ in range(depth):
                queue.append(_put(next(it)))
        except StopIteration:
            pass
        while queue:
            batch, event = queue.popleft()
            if event is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(event)
                for k in keys:
                    if k in batch:
                        # the caching allocator must not hand this
                        # memory back to the side stream while the
                        # consumer still reads it
                        batch[k].record_stream(consumer)
            try:
                queue.append(_put(next(it)))
            except StopIteration:
                pass
            yield batch
    finally:
        # stop a wrapped generator (e.g. RecordLoader.batches, whose
        # close() stops its producer thread) when the consumer abandons
        # this iterator early
        close = getattr(it, "close", None)
        if close is not None:
            close()
