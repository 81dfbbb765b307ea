"""TFRecord container framing: read/write with masked CRC32C.

Record layout (reference: tensortools/tfrecord.py:8-19):

    uint64  length          (little-endian)
    uint32  masked crc32c of the length bytes
    bytes   data[length]
    uint32  masked crc32c of data

The reference *reads* records skipping CRC validation
(tfrecord.py:29-31); we do the same by default but *write* correct
masked CRCs so our records are accepted by strict readers (e.g.
``tf.data.TFRecordDataset``). CRC32C (Castagnoli) comes from
``google_crc32c`` when available, else a table-driven fallback.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Optional

import numpy as np

try:
    import google_crc32c

    def _crc32c(data: bytes) -> int:
        return google_crc32c.value(bytes(data))
except ImportError:  # pragma: no cover - exercised only without the wheel
    _CRC_TABLE = None

    def _crc32c(data: bytes) -> int:
        # Table-driven CRC32C (Castagnoli poly 0x82F63B78, reflected).
        global _CRC_TABLE
        if _CRC_TABLE is None:
            table = np.zeros(256, dtype=np.uint32)
            for i in range(256):
                crc = i
                for _ in range(8):
                    crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
                table[i] = crc
            _CRC_TABLE = table
        crc = 0xFFFFFFFF
        table = _CRC_TABLE
        for b in data:
            crc = (crc >> 8) ^ int(table[(crc ^ b) & 0xFF])
        return crc ^ 0xFFFFFFFF


_MASK_DELTA = 0xA282EAD8


def masked_crc32c(data: bytes) -> int:
    """TFRecord's rotated+offset CRC masking."""
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def write_record(fp, data: bytes) -> None:
    """Append one framed record to an open binary file."""
    length_bytes = struct.pack("<Q", len(data))
    fp.write(length_bytes)
    fp.write(struct.pack("<I", masked_crc32c(length_bytes)))
    fp.write(data)
    fp.write(struct.pack("<I", masked_crc32c(data)))


def write_record_file(path: str, data: bytes) -> None:
    """Write a single-record ``.tfrecord`` file (the reference's layout:
    one example per file, generate_dataset.py:217-220)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fp:
        write_record(fp, data)
    os.replace(tmp, path)


def read_records(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Iterate serialized records in a TFRecord file.

    CRCs are skipped by default like the reference reader
    (tensortools/tfrecord.py:40-52).
    """
    with open(path, "rb") as fp:
        while True:
            header = fp.read(12)
            if len(header) == 0:
                return
            if len(header) < 12:
                raise ValueError(f"Truncated record header in {path}")
            (length,) = struct.unpack("<Q", header[:8])
            data = fp.read(length)
            footer = fp.read(4)
            if len(data) < length or len(footer) < 4:
                raise ValueError(f"Truncated record body in {path}")
            if verify_crc:
                (length_crc,) = struct.unpack("<I", header[8:])
                (data_crc,) = struct.unpack("<I", footer)
                if masked_crc32c(header[:8]) != length_crc:
                    raise ValueError(f"Length CRC mismatch in {path}")
                if masked_crc32c(data) != data_crc:
                    raise ValueError(f"Data CRC mismatch in {path}")
            yield data


def read_record(path: str, verify_crc: bool = False) -> Optional[bytes]:
    """Read the first record of a file (reference: tfrecord.py:67-75)."""
    for data in read_records(path, verify_crc=verify_crc):
        return data
    return None
