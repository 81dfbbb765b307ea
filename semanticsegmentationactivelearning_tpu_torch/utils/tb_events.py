"""Dependency-free TensorBoard event-file writer/reader.
The port's copy of ``semanticsegmentationactivelearning_tpu/utils/tb_events.py``,
on the port's ``data/proto`` and ``data/tfrecord``, except that a
DT_STRING tensor that is not valid UTF-8 decodes with replacement
characters instead of raising.

The reference's observability is TensorBoard summaries written by a
``tf.summary.FileWriter`` (reference: train.py:154-206 scalar/image
summaries, active_learning.py:425-427 confidence histograms, consumed
offline by tools/dump_summaries.py:16-34's raw event-record walk). The
rebuild's native log is ``metrics.jsonl`` (utils/cli.MetricsWriter);
this module closes the loop for users coming from the reference: it
writes **real** ``events.out.tfevents.*`` files TensorBoard can load,
and reads event files produced by TF/TensorBoard tooling — all on top
of the repo's own protobuf-subset codec (``data/proto.py``) and
TFRecord framing (``data/tfrecord.py``), no TF import.

Wire formats implemented (stable since TF 1.x):

    Event   { double wall_time = 1; int64 step = 2;
              oneof { string file_version = 3; Summary summary = 5; } }
    Summary { repeated Value value = 1; }
    Value   { string tag = 1;
              oneof { float simple_value = 2; Image image = 4;
                      HistogramProto histo = 5; } }
    Image   { int32 height = 1; int32 width = 2; int32 colorspace = 3;
              bytes encoded_image_string = 4; }
    HistogramProto { double min = 1; double max = 2; double num = 3;
                     double sum = 4; double sum_squares = 5;
                     repeated double bucket_limit = 6 [packed];
                     repeated double bucket = 7 [packed]; }

An event file is TFRecord-framed Events whose first record is
``Event{wall_time, file_version: "brain.Event:2"}``.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterator, List, Optional, Sequence

from ..data.proto import (_WIRE_FIXED32, _WIRE_FIXED64, _WIRE_LEN,
                          _WIRE_VARINT, _iter_fields, _signed64,
                          _write_len_delimited, _write_tag, _write_varint)
from ..data.tfrecord import write_record

_FILE_VERSION = "brain.Event:2"


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

def _write_double(out: bytearray, field: int, value: float) -> None:
    _write_tag(out, field, _WIRE_FIXED64)
    out += struct.pack("<d", float(value))


def _write_float(out: bytearray, field: int, value: float) -> None:
    _write_tag(out, field, _WIRE_FIXED32)
    out += struct.pack("<f", float(value))


def _write_int(out: bytearray, field: int, value: int) -> None:
    _write_tag(out, field, _WIRE_VARINT)
    _write_varint(out, int(value))


def _write_packed_doubles(out: bytearray, field: int,
                          values: Sequence[float]) -> None:
    _write_len_delimited(
        out, field, struct.pack("<%dd" % len(values), *map(float, values)))


def scalar_value(tag: str, value: float) -> bytes:
    """Encode one ``Summary.Value`` carrying ``simple_value``."""
    v = bytearray()
    _write_len_delimited(v, 1, tag.encode())
    _write_float(v, 2, value)
    return bytes(v)


def image_value(tag: str, encoded: bytes, height: int, width: int,
                colorspace: int = 3) -> bytes:
    """Encode one ``Summary.Value`` carrying an encoded (PNG) image.

    ``colorspace`` follows ``Summary.Image``: 1=gray, 3=RGB, 4=RGBA.
    """
    img = bytearray()
    _write_int(img, 1, height)
    _write_int(img, 2, width)
    _write_int(img, 3, colorspace)
    _write_len_delimited(img, 4, bytes(encoded))
    v = bytearray()
    _write_len_delimited(v, 1, tag.encode())
    _write_len_delimited(v, 4, bytes(img))
    return bytes(v)


def histogram_value(tag: str, counts: Sequence[float],
                    bin_edges: Sequence[float]) -> bytes:
    """Encode one ``Summary.Value`` carrying a pre-bucketed histogram.

    ``counts[i]`` falls in ``[bin_edges[i], bin_edges[i+1])`` — the
    layout ``numpy.histogram`` returns and the AL CLI logs per round
    (the reference's confidence histogram, active_learning.py:781-784).
    Sum/sum-of-squares are approximated from bin centers; TensorBoard
    only renders the buckets.
    """
    if len(bin_edges) != len(counts) + 1:
        raise ValueError("bin_edges must have len(counts)+1 entries")
    centers = [(bin_edges[i] + bin_edges[i + 1]) / 2.0
               for i in range(len(counts))]
    num = float(sum(counts))
    total = sum(c * x for c, x in zip(counts, centers))
    total_sq = sum(c * x * x for c, x in zip(counts, centers))
    h = bytearray()
    _write_double(h, 1, bin_edges[0])
    _write_double(h, 2, bin_edges[-1])
    _write_double(h, 3, num)
    _write_double(h, 4, total)
    _write_double(h, 5, total_sq)
    _write_packed_doubles(h, 6, bin_edges[1:])
    _write_packed_doubles(h, 7, counts)
    v = bytearray()
    _write_len_delimited(v, 1, tag.encode())
    _write_len_delimited(v, 5, bytes(h))
    return bytes(v)


def text_value(tag: str, strings: Sequence[str],
               shape: Optional[Sequence[int]] = None) -> bytes:
    """Encode one ``Summary.Value`` carrying a string tensor routed to
    TensorBoard's text plugin.

    The reference wrote its per-epoch confusion matrix this way:
    ``tf.summary.text("ConfusionMatrix", tf.as_string(confusion_mat))``
    (reference tensortools/metrics.py:147-148) — a rank-2 string tensor
    the text plugin renders as a table. ``strings`` is the row-major
    flat cell list; ``shape`` its dims (default: rank-1).

        TensorProto { DataType dtype = 1;  // DT_STRING = 7
                      TensorShapeProto tensor_shape = 2;
                      repeated bytes string_val = 8; }
        TensorShapeProto { repeated Dim dim = 2; }  Dim { int64 size = 1; }
        SummaryMetadata { PluginData plugin_data = 1; }
        PluginData      { string plugin_name = 1; }
    """
    if shape is None:
        shape = (len(strings),)
    shp = bytearray()
    for size in shape:
        dim = bytearray()
        _write_int(dim, 1, size)
        _write_len_delimited(shp, 2, bytes(dim))
    tensor = bytearray()
    _write_int(tensor, 1, 7)                      # DT_STRING
    _write_len_delimited(tensor, 2, bytes(shp))
    for s in strings:
        _write_len_delimited(tensor, 8, s.encode())
    plugin = bytearray()
    _write_len_delimited(plugin, 1, b"text")
    meta = bytearray()
    _write_len_delimited(meta, 1, bytes(plugin))
    v = bytearray()
    _write_len_delimited(v, 1, tag.encode())
    _write_len_delimited(v, 8, bytes(tensor))
    _write_len_delimited(v, 9, bytes(meta))
    return bytes(v)


def encode_event(wall_time: float, step: Optional[int] = None,
                 values: Optional[Sequence[bytes]] = None,
                 file_version: Optional[str] = None) -> bytes:
    """Serialize one ``Event`` (with either a summary or a version tag)."""
    ev = bytearray()
    _write_double(ev, 1, wall_time)
    if step is not None:
        _write_int(ev, 2, step)
    if file_version is not None:
        _write_len_delimited(ev, 3, file_version.encode())
    if values:
        summary = bytearray()
        for v in values:
            _write_len_delimited(summary, 1, v)
        _write_len_delimited(ev, 5, bytes(summary))
    return bytes(ev)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class EventWriter:
    """Append TensorBoard events under ``log_dir``.

    File naming follows the TF convention TensorBoard globs for:
    ``events.out.tfevents.<unix time>.<hostname>.<pid>.<seq>[suffix]``
    (pid + per-process sequence uniquify writers created within the
    same second, as TF's writer does).
    """

    _seq = 0

    def __init__(self, log_dir: str, filename_suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        EventWriter._seq += 1
        name = "events.out.tfevents.%010d.%s.%d.%d%s" % (
            int(time.time()), socket.gethostname(), os.getpid(),
            EventWriter._seq, filename_suffix)
        self.path = os.path.join(log_dir, name)
        self._fp = open(self.path, "ab")
        self.add_event(encode_event(time.time(),
                                    file_version=_FILE_VERSION))

    def add_event(self, event_bytes: bytes) -> None:
        write_record(self._fp, event_bytes)
        # Summary cadence is per-epoch/round — flush so TensorBoard
        # (and crash post-mortems) always see complete records.
        self._fp.flush()

    def scalars(self, mapping: Dict[str, float], step: int,
                wall_time: Optional[float] = None) -> None:
        """One Event carrying every (tag → float) in ``mapping``."""
        values = [scalar_value(t, v) for t, v in sorted(mapping.items())]
        if values:
            if wall_time is None:
                wall_time = time.time()
            self.add_event(encode_event(wall_time, step, values))

    def scalar(self, tag: str, value: float, step: int,
               wall_time: Optional[float] = None) -> None:
        self.scalars({tag: value}, step, wall_time)

    def image(self, tag: str, encoded: bytes, height: int, width: int,
              step: int, colorspace: int = 3,
              wall_time: Optional[float] = None) -> None:
        if wall_time is None:
            wall_time = time.time()
        self.add_event(encode_event(
            wall_time, step,
            [image_value(tag, encoded, height, width, colorspace)]))

    def histogram(self, tag: str, counts: Sequence[float],
                  bin_edges: Sequence[float], step: int,
                  wall_time: Optional[float] = None) -> None:
        if wall_time is None:
            wall_time = time.time()
        self.add_event(encode_event(
            wall_time, step,
            [histogram_value(tag, counts, bin_edges)]))

    def text(self, tag: str, strings: Sequence[str], step: int,
             shape: Optional[Sequence[int]] = None,
             wall_time: Optional[float] = None) -> None:
        if wall_time is None:
            wall_time = time.time()
        self.add_event(encode_event(
            wall_time, step, [text_value(tag, strings, shape)]))

    def flush(self) -> None:
        self._fp.flush()

    def close(self) -> None:
        if not self._fp.closed:
            self._fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

def _read_double(payload) -> float:
    return struct.unpack("<d", bytes(payload))[0]


def _decode_histo(buf) -> dict:
    out = {"min": 0.0, "max": 0.0, "num": 0.0, "sum": 0.0,
           "sum_squares": 0.0, "bucket_limit": [], "bucket": []}
    names = {1: "min", 2: "max", 3: "num", 4: "sum", 5: "sum_squares"}
    for field, wt, payload in _iter_fields(buf):
        if field in names and wt == _WIRE_FIXED64:
            out[names[field]] = _read_double(payload)
        elif field in (6, 7):
            key = "bucket_limit" if field == 6 else "bucket"
            if wt == _WIRE_FIXED64:  # unpacked repeated double
                out[key].append(_read_double(payload))
            else:
                n = len(payload) // 8
                out[key].extend(
                    struct.unpack("<%dd" % n, bytes(payload)))
    return out


def _decode_image(buf) -> dict:
    out = {"height": 0, "width": 0, "colorspace": 0,
           "encoded_image_string": b""}
    for field, wt, payload in _iter_fields(buf):
        if field == 1:
            out["height"] = payload
        elif field == 2:
            out["width"] = payload
        elif field == 3:
            out["colorspace"] = payload
        elif field == 4:
            out["encoded_image_string"] = bytes(payload)
    return out


def _decode_float_tensor(buf):
    """Minimal TensorProto reader for TF2-style scalar summaries
    (``tf.summary.scalar`` writes DT_FLOAT tensors, not simple_value):
    returns the scalar float or None if it is not one.

        TensorProto { DataType dtype = 1; ... ;
                      bytes tensor_content = 4;
                      repeated float float_val = 5 [packed];
                      repeated double double_val = 6 [packed]; }
    """
    dtype = None
    content = None
    float_vals: list = []
    for field, wt, payload in _iter_fields(buf):
        if field == 1 and wt == _WIRE_VARINT:
            dtype = payload
        elif field == 4 and wt == _WIRE_LEN:
            content = bytes(payload)
        elif field == 5:
            if wt == _WIRE_FIXED32:
                float_vals.append(
                    struct.unpack("<f", bytes(payload))[0])
            elif wt == _WIRE_LEN:
                n = len(payload) // 4
                float_vals.extend(
                    struct.unpack("<%df" % n, bytes(payload)))
        elif field == 6:
            if wt == _WIRE_FIXED64:
                float_vals.append(_read_double(payload))
            elif wt == _WIRE_LEN:
                n = len(payload) // 8
                float_vals.extend(
                    struct.unpack("<%dd" % n, bytes(payload)))
    if dtype == 1 and content is not None and len(content) == 4:
        return struct.unpack("<f", content)[0]
    if dtype == 2 and content is not None and len(content) == 8:
        return struct.unpack("<d", content)[0]
    if len(float_vals) == 1:
        return float_vals[0]
    return None


def _decode_string_tensor(buf):
    """DT_STRING TensorProto reader (text summaries): returns
    ``(strings, shape)`` or None when the tensor is not a string one."""
    dtype = None
    strings: list = []
    shape: list = []
    for field, wt, payload in _iter_fields(buf):
        if field == 1 and wt == _WIRE_VARINT:
            dtype = payload
        elif field == 2 and wt == _WIRE_LEN:
            for f2, _wt2, dim in _iter_fields(payload):
                if f2 == 2:
                    for f3, _wt3, size in _iter_fields(dim):
                        if f3 == 1:
                            shape.append(int(size))
        elif field == 8 and wt == _WIRE_LEN:
            strings.append(bytes(payload).decode("utf-8",
                                                 errors="replace"))
    if dtype == 7 and strings:
        return strings, (shape or [len(strings)])
    return None


def _decode_value(buf) -> dict:
    out: dict = {}
    for field, wt, payload in _iter_fields(buf):
        if field == 1:
            out["tag"] = bytes(payload).decode()
        elif field == 2 and wt == _WIRE_FIXED32:
            out["simple_value"] = struct.unpack("<f", bytes(payload))[0]
        elif field == 4 and wt == _WIRE_LEN:
            out["image"] = _decode_image(payload)
        elif field == 5 and wt == _WIRE_LEN:
            out["histo"] = _decode_histo(payload)
        elif field == 8 and wt == _WIRE_LEN:
            scalar = _decode_float_tensor(payload)
            if scalar is not None:
                out.setdefault("simple_value", scalar)
            else:
                text = _decode_string_tensor(payload)
                if text is not None:
                    out["tensor_strings"], out["tensor_shape"] = text
    return out


def decode_event(data: bytes) -> dict:
    """Parse one Event record into a plain dict:
    ``{"wall_time", "step", "file_version"?, "values": [...]}``."""
    out: dict = {"wall_time": 0.0, "step": 0, "values": []}
    for field, wt, payload in _iter_fields(memoryview(data)):
        if field == 1 and wt == _WIRE_FIXED64:
            out["wall_time"] = _read_double(payload)
        elif field == 2 and wt == _WIRE_VARINT:
            out["step"] = _signed64(payload)
        elif field == 3 and wt == _WIRE_LEN:
            out["file_version"] = bytes(payload).decode()
        elif field == 5 and wt == _WIRE_LEN:
            for f2, _wt2, vbuf in _iter_fields(payload):
                if f2 == 1:
                    out["values"].append(_decode_value(vbuf))
    return out


def iter_events(path: str, verify_crc: bool = False) -> Iterator[dict]:
    """Yield decoded events from a ``tfevents`` file (the rebuild's
    equivalent of the reference's raw event-record walk,
    tools/dump_summaries.py:16-34)."""
    from ..data.tfrecord import read_records
    for rec in read_records(path, verify_crc=verify_crc):
        yield decode_event(rec)


def find_event_files(path: str) -> List[str]:
    """Event files under ``path`` (or ``[path]`` if it is one), in
    mtime order like TensorBoard's directory loader."""
    if os.path.isfile(path):
        return [path]
    hits = []
    for root, _dirs, files in os.walk(path):
        for f in files:
            if "tfevents" in f:
                hits.append(os.path.join(root, f))
    hits.sort(key=lambda p: (os.path.getmtime(p), p))
    return hits


# ---------------------------------------------------------------------------
# metrics.jsonl bridge
# ---------------------------------------------------------------------------

_META_KEYS = ("split", "step", "epoch", "round", "wall_time")


def record_to_values(record: dict) -> List[bytes]:
    """Map one MetricsWriter JSONL record to Summary.Value protos.

    Tag layout matches tools/dump_summaries.py: ``<split>/<key>``.
    Scalars become simple_values; the AL confidence-histogram pair
    (``histogram`` + ``bin_edges``) becomes a HistogramProto; the
    per-epoch ``confusion`` counts become the reference's
    ConfusionMatrix TEXT summary (a [C,C] string tensor of the counts,
    ``tf.as_string(confusion_mat)`` — tensortools/metrics.py:147-148);
    other flat numeric lists (e.g. per-class IoU) become per-index
    scalars ``<tag>/<i>`` like the reference's per-class summaries
    (reference: tensortools/metrics.py:92-153).
    """
    split = record.get("split", "default")
    values: List[bytes] = []
    hist = record.get("histogram")
    edges = record.get("bin_edges")
    has_histo = (isinstance(hist, list) and isinstance(edges, list)
                 and len(edges) == len(hist) + 1)
    for key in sorted(record):
        value = record[key]
        if key in _META_KEYS or value is None:
            continue
        tag = f"{split}/{key}"
        if key in ("histogram", "bin_edges") and has_histo:
            if key == "histogram":
                values.append(histogram_value(tag, hist, edges))
            continue
        if (key == "confusion" and isinstance(value, list) and value
                and all(isinstance(row, list)
                        and len(row) == len(value) for row in value)):
            cells = [str(int(x)) for row in value for x in row]
            values.append(text_value(f"{split}/ConfusionMatrix", cells,
                                     shape=(len(value), len(value))))
            continue
        if isinstance(value, bool):
            continue
        if isinstance(value, (int, float)):
            values.append(scalar_value(tag, float(value)))
        elif (isinstance(value, list) and 0 < len(value) <= 64
              and all(isinstance(x, (int, float))
                      and not isinstance(x, bool) for x in value)):
            for i, x in enumerate(value):
                values.append(scalar_value(f"{tag}/{i}", float(x)))
    return values


def record_step(record: dict) -> int:
    return int(record.get("step",
                          record.get("epoch", record.get("round", 0))))


def jsonl_to_events(jsonl_path: str, out_dir: str,
                    filename_suffix: str = ".converted") -> str:
    """Convert a ``metrics.jsonl`` log into one TB event file; returns
    its path. Offline path for runs logged without ``--tensorboard``."""
    import json
    writer = EventWriter(out_dir, filename_suffix=filename_suffix)
    with writer, open(jsonl_path) as fp:
        for line in fp:
            rec = json.loads(line)
            values = record_to_values(rec)
            if values:
                writer.add_event(encode_event(
                    rec.get("wall_time", time.time()),
                    record_step(rec), values))
    return writer.path


__all__ = ["EventWriter", "encode_event", "scalar_value", "image_value",
           "histogram_value", "text_value", "decode_event", "iter_events",
           "find_event_files", "record_to_values", "record_step",
           "jsonl_to_events"]
