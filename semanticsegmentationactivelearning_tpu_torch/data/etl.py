"""Offline ETL: images + labels -> one ``.tfrecord`` per example.

Re-implements the reference's in-graph ETL (generate_dataset.py:48-230)
as host-side numpy/PIL with bit-matched *label* processing:

- optional center crop to a maximum aspect ratio (reference: 57-81)
- width-preserving resize: bilinear for images (141-162), nearest for
  labels (101-113), both with TF1 ``align_corners=False`` index
  mapping ``src = floor(dst * in/out)`` so label maps match the
  reference byte-for-byte
- raw-label -> trainId LUT embedding *after* the resize (114-118)
- labels re-encoded as PNG; images pass through untouched unless
  cropped/resized (then re-encoded in their original format)

The per-example record schema is ``example.SegExample``.
"""

from __future__ import annotations

import io
import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np
from PIL import Image

from ..datasets.base import embed_label_image
from . import tfrecord
from .example import SegExample, make_example

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Decode / encode
# ---------------------------------------------------------------------------

def decode_image(data_or_path, mode: Optional[str] = None) -> np.ndarray:
    """Decode an image file/bytes to a uint8 array.

    Paletted PNGs are expanded to RGB (matching ``tf.image.decode_image``);
    grayscale stays single-channel ``[H,W]``.
    """
    if isinstance(data_or_path, (bytes, bytearray)):
        img = Image.open(io.BytesIO(data_or_path))
    else:
        img = Image.open(data_or_path)
    if mode is not None:
        img = img.convert(mode)
    elif img.mode == "P":
        img = img.convert("RGB")
    elif img.mode not in ("L", "RGB", "RGBA", "I;16", "I"):
        img = img.convert("RGB")
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = arr.astype(np.uint8)
    return arr


def encode_png(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def encode_image(arr: np.ndarray, ext: str) -> bytes:
    buf = io.BytesIO()
    if ext.lower() in ("jpg", "jpeg"):
        Image.fromarray(arr).save(buf, format="JPEG", quality=95)
    else:
        Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


# ---------------------------------------------------------------------------
# TF1-compatible resizes (align_corners=False, no half-pixel centers)
# ---------------------------------------------------------------------------

def resize_nearest(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbor resize with ``src = floor(dst * in/out)``
    (the TF1 legacy kernel the reference relies on for labels)."""
    in_h, in_w = img.shape[:2]
    out_h, out_w = out_hw
    rows = np.minimum((np.arange(out_h) * (in_h / out_h)).astype(np.int64),
                      in_h - 1)
    cols = np.minimum((np.arange(out_w) * (in_w / out_w)).astype(np.int64),
                      in_w - 1)
    return img[rows][:, cols]


def resize_bilinear(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize with TF1 legacy index mapping, output float32."""
    in_h, in_w = img.shape[:2]
    out_h, out_w = out_hw
    arr = img.astype(np.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
        squeeze = True
    else:
        squeeze = False

    src_y = np.arange(out_h) * (in_h / out_h)
    src_x = np.arange(out_w) * (in_w / out_w)
    y0 = np.minimum(np.floor(src_y).astype(np.int64), in_h - 1)
    x0 = np.minimum(np.floor(src_x).astype(np.int64), in_w - 1)
    y1 = np.minimum(y0 + 1, in_h - 1)
    x1 = np.minimum(x0 + 1, in_w - 1)
    wy = (src_y - y0).astype(np.float32)[:, None, None]
    wx = (src_x - x0).astype(np.float32)[None, :, None]

    top = arr[y0][:, x0] * (1 - wx) + arr[y0][:, x1] * wx
    bot = arr[y1][:, x0] * (1 - wx) + arr[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    return out[..., 0] if squeeze else out


def center_crop_aspect(img: np.ndarray, max_aspect: float) -> np.ndarray:
    """Center-crop width so ``width/height <= max_aspect``
    (reference: generate_dataset.py:57-81)."""
    h, w = img.shape[:2]
    if max_aspect <= 0.0 or w / h <= max_aspect:
        return img
    new_w = int(np.floor(max_aspect * h))
    left = (w - new_w) // 2
    return img[:, left:left + new_w]


# ---------------------------------------------------------------------------
# Per-example processing
# ---------------------------------------------------------------------------

def process_label(path: str, embedding: np.ndarray, width: int,
                  max_aspect: float) -> Tuple[bytes, Tuple[int, int, int]]:
    """Decode raw label -> crop -> nearest resize -> trainId LUT -> PNG."""
    label = decode_image(path)
    label = center_crop_aspect(label, max_aspect)
    if width and width > 0:
        h = label.shape[0]
        scale = width / label.shape[1]
        out_h = int(np.round(h * scale))
        label = resize_nearest(label, (out_h, width))
    train_ids = embed_label_image(label, embedding).astype(np.uint8)
    return encode_png(train_ids), (train_ids.shape[0], train_ids.shape[1], 1)


def process_image(path: str, width: int, max_aspect: float
                  ) -> Tuple[bytes, Tuple[int, int, int], str]:
    """Decode -> crop -> bilinear resize -> re-encode (or pass through)."""
    with open(path, "rb") as fp:
        raw = fp.read()
    img = decode_image(raw)
    ext = path.split(".")[-1].lower()
    cropped = center_crop_aspect(img, max_aspect)
    modified = cropped.shape != img.shape
    img = cropped
    if width and width > 0 and img.shape[1] != width:
        scale = width / img.shape[1]
        out_h = int(np.round(img.shape[0] * scale))
        img = resize_bilinear(img, (out_h, width)).astype(np.uint8)
        modified = True
    channels = 1 if img.ndim == 2 else img.shape[2]
    shape = (img.shape[0], img.shape[1], channels)
    encoded = encode_image(img, ext) if modified else raw
    return encoded, shape, ("jpg" if ext in ("jpg", "jpeg") else ext)


def write_example(file_id: str, entry: Dict[str, str], embedding: np.ndarray,
                  output_dir: str, width: int = -1,
                  max_aspect: float = -1.0) -> str:
    """Process one file-association entry and write ``{id}.tfrecord``.

    Enforces shape consistency across label and all modalities
    (reference: generate_dataset.py:189-195) and logs examples whose
    aspect ratio still exceeds 2.0 (202-207).
    """
    label_bytes = None
    modalities = {}
    shapes = {}
    for kind, path in entry.items():
        if kind == "label":
            label_bytes, shape = process_label(path, embedding, width,
                                               max_aspect)
            shapes["label"] = shape
            if shape[1] / shape[0] > 2.0:
                logger.error("%s: example aspect ratio: %1.02f",
                             file_id, shape[1] / shape[0])
        else:
            encoded, shape, ext = process_image(path, width, max_aspect)
            modalities[kind] = (encoded, ext, shape[2])
            shapes[kind] = shape

    first_kind = next(iter(shapes))
    h, w = shapes[first_kind][:2]
    for kind, shape in shapes.items():
        if shape[:2] != (h, w):
            raise ValueError(
                "Incompatible shapes (%s and %s): (%s, %s)"
                % (first_kind, kind, shapes[first_kind], shape))

    blob = make_example(SegExample(file_id=file_id, height=h, width=w,
                                   label=label_bytes, modalities=modalities))
    out_path = os.path.join(output_dir, file_id + ".tfrecord")
    tfrecord.write_record_file(out_path, blob)
    return out_path


def _write_example_star(args):
    return write_example(*args)


def generate_split(file_associations: Dict[str, Dict[str, str]],
                   embedding: np.ndarray, output_dir: str,
                   width: int = -1, max_aspect: float = -1.0,
                   num_workers: Optional[int] = None,
                   progress: bool = False):
    """ETL one split with a process pool (reference parallelized via
    tf.data ``num_parallel_calls``, generate_dataset.py:276-280)."""
    os.makedirs(output_dir, exist_ok=True)
    jobs = [(fid, entry, embedding, output_dir, width, max_aspect)
            for fid, entry in file_associations.items()]
    it = None
    if num_workers is None:
        num_workers = max(os.cpu_count() - 1, 1)
    if num_workers <= 1 or len(jobs) <= 1:
        it = map(_write_example_star, jobs)
    else:
        import multiprocessing
        pool = multiprocessing.Pool(num_workers)
        it = pool.imap_unordered(_write_example_star, jobs)
    if progress:
        try:
            import tqdm
            it = tqdm.tqdm(it, total=len(jobs), ascii=" #",
                           dynamic_ncols=True)
        except ImportError:
            pass
    results = list(it)
    if num_workers > 1 and len(jobs) > 1:
        pool.close()
        pool.join()
    return results
