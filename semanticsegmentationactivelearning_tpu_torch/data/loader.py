"""Host-side record loader feeding device-resident batches.

Replaces the reference's tf.data ``InputStage`` (tensortools/input.py:39-233)
with an explicit host loader: TFRecord files are decoded by a thread pool
(PIL's zlib/libjpeg release the GIL), assembled into statically-shaped
uint8 stacks ``[B, Hs, Ws, C+1]`` (image channels + label plane, missing
labels filled with 255 like input.py:249-260), and double-buffered through
a queue while the previous batch computes on the device. All per-pixel work
(crop/flip/scale/normalize/mask) happens on device in
``pipeline.augment_batch`` / ``pipeline.eval_batch``.

Static shapes: every batch has identical shape; the final partial batch
is padded and flagged via ``valid`` so jit never recompiles.
"""

from __future__ import annotations

import concurrent.futures
import logging
import queue
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from . import etl, example

logger = logging.getLogger(__name__)


def load_stack(path: str, storage_hw: Tuple[int, int], channels: int = 3,
               fill_label: int = 255,
               modalities: Sequence[str] = (),
               with_label: bool = True):
    """Decode one record into a padded uint8 stack.

    Extra ``modalities`` (e.g. Freiburg ``nir``) are decoded from the
    record's ``<modality>/*`` features and stacked after the image
    channels, matching the reference decoder's channel stacking
    (tensortools/input.py:265-269); ``channels`` is the TOTAL image +
    modality channel count.

    With ``with_label=False`` the stack is image-only
    ``[Hs,Ws,channels]`` and any label feature is neither decoded nor
    stored (the acquisition-scoring path never reads labels).

    :returns: (stack ``[Hs,Ws,channels+with_label]``, valid_h, valid_w,
              has_label)
    """
    ex = example.read_example(path)
    sh, sw = storage_hw
    stack = np.zeros((sh, sw, channels + (1 if with_label else 0)),
                     dtype=np.uint8)
    if with_label:
        stack[..., channels] = fill_label

    img_bytes = ex.image
    if img_bytes is None:
        raise ValueError(f"Record {path} has no image modality")
    img = etl.decode_image(img_bytes)
    if img.ndim == 2:
        img = img[:, :, None]
    img_ch = channels - sum(
        (ex.modalities or {}).get(m, (None, None, 1))[2]
        for m in modalities)
    if img.shape[2] < img_ch:
        img = np.repeat(img[:, :, :1], img_ch, axis=2)
    h = min(img.shape[0], sh)
    w = min(img.shape[1], sw)
    if img.shape[0] > sh or img.shape[1] > sw:
        logger.warning("Example %s (%dx%d) exceeds storage %dx%d; cropping",
                       ex.file_id, img.shape[0], img.shape[1], sh, sw)
    stack[:h, :w, :img_ch] = img[:h, :w, :img_ch]

    c0 = img_ch
    for mod in modalities:
        if not ex.modalities or mod not in ex.modalities:
            raise ValueError(
                f"Record {path} has no '{mod}' modality")
        marr = etl.decode_image(ex.modalities[mod][0])
        if marr.ndim == 2:
            marr = marr[:, :, None]
        mc = marr.shape[2]
        if c0 + mc > channels:
            raise ValueError(
                f"Record {path}: modality channels exceed total "
                f"{channels}")
        if marr.shape[:2] != img.shape[:2]:
            # mirror the ETL's cross-modality shape check (reference
            # generate_dataset.py:189-195) instead of a raw numpy
            # broadcast error from deep inside the worker pool
            raise ValueError(
                f"Record {path}: modality '{mod}' is "
                f"{marr.shape[0]}x{marr.shape[1]} but the image plane "
                f"is {img.shape[0]}x{img.shape[1]}")
        stack[:h, :w, c0:c0 + mc] = marr[:h, :w]
        c0 += mc
    if modalities and c0 != channels:
        raise ValueError(
            f"Record {path}: decoded {c0} channels, expected {channels}")

    has_label = ex.label is not None
    if has_label and with_label:
        lbl = etl.decode_image(ex.label)
        if lbl.ndim == 3:
            lbl = lbl[..., 0]
        if lbl.shape[:2] != img.shape[:2]:
            # same cross-plane shape contract as the modalities above
            # (the ETL guarantees it; a hand-built record that violates
            # it would otherwise broadcast-error or silently misalign)
            raise ValueError(
                f"Record {path}: label is {lbl.shape[0]}x{lbl.shape[1]} "
                f"but the image plane is {img.shape[0]}x{img.shape[1]}")
        stack[:h, :w, channels] = lbl[:h, :w]
    return stack, h, w, has_label


def probe_channels(path: str, modalities: Sequence[str] = ()) -> int:
    """Total input channels (image + requested modalities) from one
    record's header — filtered parse, no image decode or payload copy."""
    feats = example.peek_header(
        path, ("image/channels",)
        + tuple(f"{m}/channels" for m in modalities))
    total = example.channels_or_rgb(
        (feats.get("image/channels") or [3])[0])
    for m in modalities:
        ch = feats.get(f"{m}/channels")
        if not ch:
            raise ValueError(f"Record {path} has no '{m}' modality")
        total += ch[0]
    return total


def size_buckets(record_dims: np.ndarray, num_buckets: int,
                 min_hw: Optional[Tuple[int, int]] = None,
                 min_saving: float = 0.15):
    """Partition records into size buckets, one static storage window
    per bucket, for mixed-size pools (Vistas ships native per-record
    resolutions; the reference's tf.data handled arbitrary H x W
    dynamically, tensortools/input.py:246-287, while XLA needs static
    shapes).

    A single global window sized by ``RecordLoader._scan_max_dims``
    makes ONE oversized record inflate every decode, stack and H2D
    transfer in the pool; bucketing pads only within each bucket.

    Candidate windows come from equal-count quantile groups over the
    records sorted by padded area (each window = the group's max (H, W),
    clamped up to ``min_hw``, the network crop window); every record is
    then assigned to the smallest candidate window it fits, and each
    bucket's window is re-tightened to the max over its members.
    Returns ``(plan, saving)`` where ``plan`` is a list of
    ``(indices, storage_hw)`` in ascending window order and ``saving``
    the fraction of global-window stack bytes avoided; when
    ``saving < min_saving`` the plan degenerates to one global bucket
    (one compiled shape costs nothing extra — don't multiply compiled
    pipeline shapes for a few percent).
    """
    dims = np.asarray(record_dims, dtype=np.int64)
    n = len(dims)
    hw = dims.copy()
    if min_hw is not None:
        hw[:, 0] = np.maximum(hw[:, 0], min_hw[0])
        hw[:, 1] = np.maximum(hw[:, 1], min_hw[1])
    global_hw = (int(hw[:, 0].max()), int(hw[:, 1].max()))
    order = np.argsort(hw[:, 0] * hw[:, 1], kind="stable")
    num_buckets = max(1, min(int(num_buckets), n))
    bounds = [(len(order) * k) // num_buckets
              for k in range(num_buckets + 1)]
    windows = []
    for k in range(num_buckets):
        idx = order[bounds[k]:bounds[k + 1]]
        if len(idx) == 0:
            continue
        window = (int(hw[idx, 0].max()), int(hw[idx, 1].max()))
        if window not in windows:
            windows.append(window)
    windows.sort(key=lambda w: (w[0] * w[1], w))
    # each record -> smallest candidate window that fits both dims
    # (the last window is the global max, so everything fits somewhere)
    members = {w: [] for w in windows}
    for i in range(n):
        for w in windows:
            if hw[i, 0] <= w[0] and hw[i, 1] <= w[1]:
                members[w].append(i)
                break
        else:
            members[windows[-1]].append(i)
    plan = []
    for w in windows:
        idx = np.asarray(members[w], dtype=np.int64)
        if len(idx) == 0:
            continue
        tight = (int(hw[idx, 0].max()), int(hw[idx, 1].max()))
        if plan and plan[-1][1] == tight:
            plan[-1] = (np.concatenate([plan[-1][0], idx]), tight)
        else:
            plan.append((idx, tight))
    total = sum(len(idx) * w[0] * w[1] for idx, w in plan)
    saving = 1.0 - total / float(n * global_hw[0] * global_hw[1])
    if len(plan) <= 1 or saving < min_saving:
        return [(np.arange(n), global_hw)], 0.0
    return [(np.sort(idx), w) for idx, w in plan], saving


class RecordLoader:
    """Batched, prefetching loader over a list of ``.tfrecord`` paths.

    :param filenames:  sequence of record paths
    :param batch_size: static batch size (final batch padded + flagged)
    :param storage_hw: static storage (H, W); peeked from the first
                       record when omitted
    :param channels:   image channels stacked before the label plane
    :param with_label: when False, batches carry image channels only
                       (``[B,Hs,Ws,channels]``, no label plane) — the
                       acquisition-scoring path never reads labels
                       (reference pool pass,
                       active_learning.py:687-700), so skipping the
                       plane cuts stack assembly and H2D by 1/(C+1)
    """

    def __init__(self, filenames: Sequence[str], batch_size: int,
                 storage_hw: Optional[Tuple[int, int]] = None,
                 channels: Optional[int] = None, num_workers: int = 8,
                 prefetch: int = 2, use_native: str = "auto",
                 min_hw: Optional[Tuple[int, int]] = None,
                 modalities: Sequence[str] = (),
                 with_label: bool = True):
        self.filenames = np.asarray(filenames)
        self.batch_size = int(batch_size)
        self.modalities = tuple(modalities)
        self.with_label = bool(with_label)
        if channels is None:
            channels = (probe_channels(str(self.filenames[0]),
                                       self.modalities)
                        if len(self.filenames) else 3)
        self.channels = channels
        self.num_workers = num_workers
        if prefetch < 1:
            # Queue(maxsize=0) would mean UNBOUNDED, i.e. the producer
            # decodes the whole epoch ahead of the consumer
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        self.prefetch = prefetch
        if use_native == "auto":
            from . import native
            self._native = native if native.available() else None
        elif use_native:
            from . import native
            if not native.available():
                # fail at construction, not from the producer thread at
                # the first batch
                raise ValueError(
                    "use_native=True but the native IO library is "
                    "unavailable (build it with `make -C csrc`)")
            self._native = native
        else:
            self._native = None
        if self.modalities and self._native is not None:
            # the C++ fast path decodes image+label only; modality
            # stacking takes the (equivalent) Python route
            self._native = None
        self.record_dims: Optional[np.ndarray] = None
        if storage_hw is None:
            if len(self.filenames) == 0:
                raise ValueError("Empty dataset and no storage_hw given")
            storage_hw = self._scan_max_dims()
        if min_hw is not None:
            # storage must cover the network crop window; smaller
            # records get zero/ignore padding that the crop may include
            # (padding pixels are masked out downstream)
            storage_hw = (max(storage_hw[0], min_hw[0]),
                          max(storage_hw[1], min_hw[1]))
        self.storage_hw = tuple(storage_hw)

    def _scan_max_dims(self) -> Tuple[int, int]:
        """Max (H, W) over every record's header dims.

        Per-example record files may differ in size (Vistas keeps
        native resolutions; the reference's tf.data pipeline handled
        arbitrary per-record H x W dynamically, input.py:246-287). XLA
        needs one static storage window, so size it to cover the
        largest record — smaller ones are zero/ignore-padded and
        masked, and no valid pixels are ever cropped. Header-only
        proto scan, parallelized; no image decode."""
        with concurrent.futures.ThreadPoolExecutor(
                self.num_workers) as pool:
            dims = list(pool.map(
                lambda p: example.peek_dims(str(p))[:2], self.filenames))
        # cache per-record dims for size-bucket planning (size_buckets)
        self.record_dims = np.asarray(dims, dtype=np.int64)
        return (max(d[0] for d in dims), max(d[1] for d in dims))

    @property
    def count(self) -> int:
        return len(self.filenames)

    def _assemble(self, order: np.ndarray, pool) -> Dict[str, np.ndarray]:
        """Decode one batch worth of examples (padded to batch_size)."""
        n = len(order)
        bs = self.batch_size
        sh, sw = self.storage_hw
        planes = self.channels + (1 if self.with_label else 0)
        stack = np.zeros((bs, sh, sw, planes), dtype=np.uint8)
        if self.with_label:
            stack[..., self.channels] = 255
        heights = np.zeros(bs, dtype=np.int32)
        widths = np.zeros(bs, dtype=np.int32)
        has_label = np.zeros(bs, dtype=bool)
        valid = np.zeros(bs, dtype=bool)
        paths = [str(self.filenames[i]) for i in order]
        if n == 0:
            # all-padding batch (a host's empty slice of a partial tail
            # chunk in global_batches); valid stays all False. Dims are
            # the storage window so the jit crop math stays benign.
            heights[:], widths[:] = sh, sw
            return {"stack": stack, "heights": heights, "widths": widths,
                    "index": np.zeros(bs, dtype=np.int32),
                    "has_label": has_label, "valid": valid}
        if self._native is not None:
            nstack, nh, nw, nhl = self._native.load_batch(
                paths, self.storage_hw, self.channels,
                num_threads=self.num_workers)
            # the native path always decodes channels+1 planes; the
            # slice below is a ~0.6ms/img host memcpy, negligible next
            # to decode and H2D
            stack[:n] = nstack if self.with_label \
                else nstack[..., :self.channels]
            heights[:n], widths[:n] = nh, nw
            has_label[:n] = nhl
            valid[:n] = True
        else:
            results = list(pool.map(
                lambda p: load_stack(p, self.storage_hw, self.channels,
                                     modalities=self.modalities,
                                     with_label=self.with_label),
                paths))
            for j, (s, h, w, hl) in enumerate(results):
                stack[j] = s
                heights[j], widths[j] = h, w
                has_label[j] = hl
                valid[j] = True
        if n < bs:
            # Pad by repeating the last decoded example; padding rows are
            # masked out downstream via `valid`.
            for j in range(n, bs):
                stack[j] = stack[n - 1]
                heights[j], widths[j] = heights[n - 1], widths[n - 1]
        index = np.zeros(bs, dtype=np.int32)
        index[:n] = order
        index[n:] = order[-1]  # n >= 1 here (n == 0 returned above)
        return {"stack": stack, "heights": heights, "widths": widths,
                "index": index, "has_label": has_label, "valid": valid}

    def batches(self, order: Optional[np.ndarray] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield prefetched batches following ``order`` (default: all
        examples in file order)."""
        if order is None:
            order = np.arange(len(self.filenames))
        order = np.asarray(order)
        chunks = [order[b:b + self.batch_size]
                  for b in range(0, len(order), self.batch_size)]
        yield from self._batches_from_chunks(chunks)

    def global_batches(self, order: np.ndarray, global_batch_size: int,
                       process_id: int, num_processes: int
                       ) -> Iterator[Dict[str, np.ndarray]]:
        """Per-host view of a globally-consistent batch stream
        (multi-host DP over DCN; the reference had no multi-host story,
        SURVEY.md §5).

        Every host iterates the SAME global ``order`` chunked by
        ``global_batch_size``, assembling only its contiguous slice of
        each chunk — ``parallel.make_global_batch`` then stitches the
        local rows into one globally-sharded array. All hosts always
        see the same number of batches (a host's slice of a partial
        tail chunk may even be empty: it still yields an all-padding
        batch with ``valid`` all False, keeping collectives in step).
        This loader's ``batch_size`` must be the per-host local size,
        ``global_batch_size / num_processes``.
        """
        order = np.asarray(order)
        local_bs = self.batch_size
        if local_bs * num_processes != global_batch_size:
            raise ValueError(
                f"Loader batch_size {local_bs} x {num_processes} "
                f"processes != global batch {global_batch_size}")
        per = local_bs
        chunks = []
        for b in range(0, len(order), global_batch_size):
            chunk = order[b:b + global_batch_size]
            lo = min(len(chunk), process_id * per)
            hi = min(len(chunk), (process_id + 1) * per)
            chunks.append(chunk[lo:hi])
        yield from self._batches_from_chunks(chunks)

    @staticmethod
    def global_batch_layout(order: np.ndarray, global_batch_size: int,
                            num_processes: int
                            ) -> Iterator[tuple]:
        """Host-side mirror of ``global_batches``' global row layout:
        for each global batch yields ``(index [G], valid [G])`` where
        row ``p*local + j`` is the j-th row of process p's slice of the
        chunk (padding rows carry index -1, valid False). Lets a host
        scatter values fetched from a replicated global array back to
        example indices without shipping index arrays cross-host."""
        order = np.asarray(order)
        local = global_batch_size // num_processes
        for b in range(0, len(order), global_batch_size):
            chunk = order[b:b + global_batch_size]
            gidx = np.full(global_batch_size, -1, dtype=np.int64)
            gval = np.zeros(global_batch_size, dtype=bool)
            for p in range(num_processes):
                lo = min(len(chunk), p * local)
                hi = min(len(chunk), (p + 1) * local)
                m = hi - lo
                gidx[p * local:p * local + m] = chunk[lo:hi]
                gval[p * local:p * local + m] = True
            yield gidx, gval

    def _batches_from_chunks(self, chunks
                             ) -> Iterator[Dict[str, np.ndarray]]:
        if not chunks:
            return
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error_holder = []
        # Set when the consumer abandons the generator mid-iteration
        # (break / exception between yields): without it the producer
        # would block forever on the full queue, pinning its thread,
        # the worker pool, and ~prefetch decoded stacks.
        stop = threading.Event()

        def bounded_put(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with concurrent.futures.ThreadPoolExecutor(
                        self.num_workers) as pool:
                    for chunk in chunks:
                        if stop.is_set() or \
                                not bounded_put(self._assemble(chunk,
                                                               pool)):
                            return
            except BaseException as exc:  # propagate to consumer
                error_holder.append(exc)
            finally:
                bounded_put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            stop.set()
            thread.join()
        if error_holder:
            raise error_holder[0]

    def num_batches(self, count: Optional[int] = None) -> int:
        if count is None:
            count = len(self.filenames)
        return (count - 1) // self.batch_size + 1 if count else 0
