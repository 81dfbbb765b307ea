"""Minimal, dependency-free wire codec for ``tf.train.Example``.

The reference stores one Example per ``.tfrecord`` file with the schema
documented in its README (reference: README.md:19-43) and peeks records
by parsing the raw wire format (reference: tensortools/tfrecord.py:7-78).
We implement the tiny protobuf subset the Example message needs —
varints + length-delimited fields — so the framework does not depend on
TensorFlow or protobuf at runtime, while staying byte-compatible with
records produced/consumed by TF tooling.

Message layout (proto wire format):

    Example  { Features features = 1; }
    Features { map<string, Feature> feature = 1; }   # repeated MapEntry
    MapEntry { string key = 1; Feature value = 2; }
    Feature  { oneof { BytesList bytes_list = 1;
                       FloatList float_list = 2;
                       Int64List int64_list = 3; } }
    BytesList { repeated bytes value = 1; }
    FloatList { repeated float value = 1 [packed]; }
    Int64List { repeated int64 value = 1 [packed]; }

The Python-facing representation is a plain dict mapping feature name to
a ``bytes`` / ``float`` / ``int`` list, e.g.::

    {"height": [512], "image/data": [b"...png..."], "id": [b"frankfurt_0_0"]}
"""

from __future__ import annotations

import struct
from typing import Dict, List, Union

FeatureValue = Union[List[bytes], List[int], List[float]]
ExampleDict = Dict[str, FeatureValue]

_WIRE_VARINT = 0
_WIRE_FIXED64 = 1
_WIRE_LEN = 2
_WIRE_FIXED32 = 5


# ---------------------------------------------------------------------------
# varint primitives
# ---------------------------------------------------------------------------

def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        # int64 negatives are encoded as 10-byte two's complement varints
        value &= (1 << 64) - 1
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return


def _read_varint(buf: memoryview, pos: int):
    result = 0
    shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("Malformed varint")


def _signed64(value: int) -> int:
    if value >= 1 << 63:
        value -= 1 << 64
    return value


def _write_tag(out: bytearray, field: int, wire_type: int) -> None:
    _write_varint(out, (field << 3) | wire_type)


def _write_len_delimited(out: bytearray, field: int, payload: bytes) -> None:
    _write_tag(out, field, _WIRE_LEN)
    _write_varint(out, len(payload))
    out += payload


# ---------------------------------------------------------------------------
# Feature encode / decode
# ---------------------------------------------------------------------------

def _encode_feature(values: FeatureValue) -> bytes:
    inner = bytearray()
    if len(values) and isinstance(values[0], (bytes, bytearray, str)):
        # BytesList (field 1 of Feature)
        blist = bytearray()
        for v in values:
            if isinstance(v, str):
                v = v.encode()
            _write_len_delimited(blist, 1, bytes(v))
        _write_len_delimited(inner, 1, bytes(blist))
    elif len(values) and isinstance(values[0], float):
        # FloatList (field 2), packed fixed32 floats
        packed = struct.pack("<%df" % len(values), *values)
        flist = bytearray()
        _write_len_delimited(flist, 1, packed)
        _write_len_delimited(inner, 2, bytes(flist))
    else:
        # Int64List (field 3), packed varints. Empty lists default here.
        packed = bytearray()
        for v in values:
            _write_varint(packed, int(v))
        ilist = bytearray()
        _write_len_delimited(ilist, 1, bytes(packed))
        _write_len_delimited(inner, 3, bytes(ilist))
    return bytes(inner)


def _skip_field(buf: memoryview, pos: int, wire_type: int) -> int:
    if wire_type == _WIRE_VARINT:
        _, pos = _read_varint(buf, pos)
    elif wire_type == _WIRE_FIXED64:
        pos += 8
    elif wire_type == _WIRE_LEN:
        size, pos = _read_varint(buf, pos)
        pos += size
    elif wire_type == _WIRE_FIXED32:
        pos += 4
    else:
        raise ValueError(f"Unsupported wire type {wire_type}")
    return pos


def _iter_fields(buf: memoryview):
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire_type = tag >> 3, tag & 0x7
        if wire_type == _WIRE_LEN:
            size, pos = _read_varint(buf, pos)
            yield field, wire_type, buf[pos:pos + size]
            pos += size
        elif wire_type == _WIRE_VARINT:
            value, pos = _read_varint(buf, pos)
            yield field, wire_type, value
        else:
            new_pos = _skip_field(buf, pos, wire_type)
            yield field, wire_type, buf[pos:new_pos]
            pos = new_pos


def _decode_scalar_list(buf: memoryview, decode_packed, decode_one):
    """Decode a BytesList/FloatList/Int64List body (repeated field 1)."""
    values = []
    for field, wire_type, payload in _iter_fields(buf):
        if field != 1:
            continue
        if wire_type == _WIRE_LEN and decode_packed is not None:
            values.extend(decode_packed(payload))
        else:
            values.append(decode_one(payload))
    return values


def _decode_feature(buf: memoryview) -> FeatureValue:
    for field, wire_type, payload in _iter_fields(buf):
        if field == 1:      # BytesList
            return _decode_scalar_list(payload, None,
                                       lambda p: bytes(p))
        if field == 2:      # FloatList (packed or not)
            return _decode_scalar_list(
                payload,
                lambda p: struct.unpack("<%df" % (len(p) // 4), p),
                lambda p: struct.unpack("<f", p)[0])
        if field == 3:      # Int64List (packed varints or single varints)
            def unpack_varints(p):
                out, pos = [], 0
                while pos < len(p):
                    v, pos = _read_varint(p, pos)
                    out.append(_signed64(v))
                return out
            return _decode_scalar_list(payload, unpack_varints,
                                       lambda v: _signed64(v))
    return []


# ---------------------------------------------------------------------------
# Example encode / decode
# ---------------------------------------------------------------------------

def encode_example(features: ExampleDict) -> bytes:
    """Serialize a feature dict to ``tf.train.Example`` wire bytes.

    Features are written in sorted key order for determinism.
    """
    features_msg = bytearray()
    for key in sorted(features):
        entry = bytearray()
        _write_len_delimited(entry, 1, key.encode())
        _write_len_delimited(entry, 2, _encode_feature(features[key]))
        _write_len_delimited(features_msg, 1, bytes(entry))
    example = bytearray()
    _write_len_delimited(example, 1, bytes(features_msg))
    return bytes(example)


def decode_example(data: bytes, keys=None) -> ExampleDict:
    """Parse ``tf.train.Example`` wire bytes into a feature dict.

    With ``keys`` (a collection of feature names), only those features'
    values are decoded — other features' payloads are walked but never
    copied, so header peeks over whole record directories skip the
    multi-MB encoded-image memcpys.
    """
    out: ExampleDict = {}
    buf = memoryview(data)
    for field, _wt, features_buf in _iter_fields(buf):
        if field != 1:
            continue
        for f2, _wt2, entry in _iter_fields(features_buf):
            if f2 != 1:
                continue
            key = None
            vpayload = None
            for f3, _wt3, payload in _iter_fields(entry):
                if f3 == 1:
                    key = bytes(payload).decode()
                elif f3 == 2:
                    vpayload = payload
            if key is not None and (keys is None or key in keys):
                out[key] = (_decode_feature(vpayload)
                            if vpayload is not None else [])
    return out
