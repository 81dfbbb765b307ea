"""The segmentation example schema over TFRecord.

Identical on-disk schema to the reference so record directories are
drop-in interchangeable (reference: README.md:19-43,
generate_dataset.py:197-214):

    "height"          int64
    "width"           int64
    "id"              bytes (file id)
    "label"           bytes (PNG-encoded uint8 trainId map)  [optional]
    "<mod>/data"      bytes (PNG/JPG-encoded image), mod usually "image"
    "<mod>/encoding"  bytes ("png"/"jpg")
    "<mod>/channels"  int64
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from . import proto, tfrecord


@dataclasses.dataclass
class SegExample:
    """Decoded (but still image-encoded) example."""

    file_id: str
    height: int
    width: int
    label: Optional[bytes] = None               # encoded PNG or None
    modalities: Dict[str, Tuple[bytes, str, int]] = None
    # modality name -> (encoded bytes, encoding ext, channels)

    @property
    def image(self) -> Optional[bytes]:
        return (self.modalities or {}).get("image", (None,))[0]


def make_example(ex: SegExample) -> bytes:
    """Serialize a SegExample to Example wire bytes."""
    features: proto.ExampleDict = {
        "height": [int(ex.height)],
        "width": [int(ex.width)],
        "id": [ex.file_id.encode()],
    }
    if ex.label is not None:
        features["label"] = [ex.label]
    for mod, (data, encoding, channels) in (ex.modalities or {}).items():
        features[f"{mod}/data"] = [data]
        features[f"{mod}/encoding"] = [encoding.encode()]
        features[f"{mod}/channels"] = [int(channels)]
    return proto.encode_example(features)


def parse_example(data: bytes) -> SegExample:
    """Parse Example wire bytes into a SegExample."""
    feats = proto.decode_example(data)

    def _scalar(key, default=None):
        vals = feats.get(key)
        return vals[0] if vals else default

    modalities = {}
    for key in feats:
        if key.endswith("/data"):
            mod = key[:-len("/data")]
            modalities[mod] = (
                _scalar(f"{mod}/data", b""),
                (_scalar(f"{mod}/encoding", b"") or b"").decode(),
                int(_scalar(f"{mod}/channels", -1)),
            )
    file_id = _scalar("id", b"")
    return SegExample(
        file_id=file_id.decode() if isinstance(file_id, bytes) else file_id,
        height=int(_scalar("height", -1)),
        width=int(_scalar("width", -1)),
        label=_scalar("label"),
        modalities=modalities,
    )


def read_example(path: str) -> SegExample:
    """Read + parse the single example of a ``.tfrecord`` file."""
    data = tfrecord.read_record(path)
    if data is None:
        raise ValueError(f"Empty record file: {path}")
    return parse_example(data)


def channels_or_rgb(ch: int) -> int:
    """The ``image/channels`` header convention: legacy records missing
    the field (``parse_example`` defaults it to -1, and filtered peeks
    omit it entirely) count as RGB. Single home for the convention —
    shared by ``image_channels``, ``peek_dims``, and the loader's
    ``probe_channels``."""
    return ch if ch > 0 else 3


def image_channels(ex: SegExample) -> int:
    """Channel count of the base ``image`` plane from a parsed
    example's header (legacy records without an ``image/channels``
    field default to RGB)."""
    return channels_or_rgb(
        ex.modalities.get("image", (b"", "", 3))[2]
        if ex.modalities else 3)


def peek_header(path: str, keys) -> "proto.ExampleDict":
    """Filtered parse of the single example in ``path``: walks the wire
    format but only materializes the requested ``keys``, so the
    multi-MB encoded-image payloads are never copied (the loader's
    startup scans call this for every record of a dataset)."""
    data = tfrecord.read_record(path)
    if data is None:
        raise ValueError(f"Empty record file: {path}")
    return proto.decode_example(data, keys=keys)


def peek_dims(path: str) -> Tuple[int, int, int]:
    """Peek (height, width, channels) of the first record without
    decoding — or copying — image payloads (reference:
    inference.py:75-83)."""
    feats = peek_header(path, ("height", "width", "image/channels"))
    return ((feats.get("height") or [-1])[0],
            (feats.get("width") or [-1])[0],
            channels_or_rgb((feats.get("image/channels") or [3])[0]))
