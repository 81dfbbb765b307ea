"""Shared dataset-metadata machinery.

Each dataset exposes the duck-typed interface consumed by the ETL and the
CLIs (reference: datasets/cityscapes.py:108-171, freiburg.py:39-88,
vistas.py:85-145):

- ``num_classes``          number of training classes
- ``embedding``            LUT mapping raw label values -> trainId.
                           1-D ``[256]`` for id-coded labels, 3-D
                           ``[256,256,256]`` for RGB-coded labels.
- ``embedding_reversed``   LUT mapping trainId -> dataset id (or color).
- ``colormap``             ``[256,3]`` uint8 trainId -> display color.
- ``file_associations(root)`` -> ``{split: {file_id: {kind: path}}}``
- ``get_{train,validation,test}_paths(root)``

All tables are plain numpy so they can be closed over by jitted functions
(a LUT gather is a single XLA ``gather``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Label:
    """One row of a dataset's label table."""

    name: str
    id: int
    trainId: int
    color: Optional[Tuple[int, int, int]] = None


def colormap_from_labels(labels, reverse_priority: bool = True) -> np.ndarray:
    """Build the ``[256,3]`` trainId->color LUT.

    With ``reverse_priority`` the *first* label listed for a trainId wins,
    matching the reference's reversed iteration (cityscapes.py:127-130).
    Unmapped entries are 255 (white), so ignore-pixels render white.
    """
    cmap = np.full((256, 3), 255, dtype=np.uint8)
    rows = reversed(labels) if reverse_priority else labels
    for label in rows:
        if label.color is not None:
            cmap[label.trainId] = label.color
    return cmap


def id_embedding(labels, size: int = 256) -> np.ndarray:
    """1-D LUT: dataset id -> trainId, 255 where unmapped.

    First listed label for an id wins (cityscapes.py:135-138).
    """
    lut = np.full(size, 255, dtype=np.uint8)
    for label in reversed(labels):
        if label.id >= 0:
            lut[label.id] = label.trainId
    return lut


def color_embedding(labels) -> np.ndarray:
    """3-D LUT: RGB color -> trainId, 255 where unmapped.

    16 MiB; callers should build lazily (freiburg.py:50-55, vistas.py:107-114).
    """
    lut = np.full((256, 256, 256), 255, dtype=np.uint8)
    for label in labels:
        if label.color is not None:
            lut[label.color] = label.trainId
    return lut


def reversed_id_embedding(labels, size: int = 256) -> np.ndarray:
    """1-D LUT: trainId -> dataset id (cityscapes.py:150-155)."""
    lut = np.zeros(size, dtype=np.uint8)
    for label in reversed(labels):
        lut[label.trainId] = max(label.id, 0)
    return lut


def embed_label_image(label_img: np.ndarray, embedding: np.ndarray) -> np.ndarray:
    """Map a raw decoded label image to trainIds via the dataset LUT.

    Mirrors the in-graph ``gather_nd(embedding, label)`` of the reference
    ETL (generate_dataset.py:114-118): a 1-D LUT consumes the (single)
    channel value, a 3-D LUT consumes the RGB triple.

    :param label_img: ``[H,W]`` or ``[H,W,C]`` uint8 label image
    :param embedding: 1-D ``[256]`` or 3-D ``[256,256,256]`` LUT
    :returns: ``[H,W]`` uint8 trainId map
    """
    img = np.asarray(label_img)
    if embedding.ndim == 1:
        if img.ndim == 3:
            img = img[..., 0]
        return embedding[img]
    if embedding.ndim == 3:
        if img.ndim != 3 or img.shape[-1] < 3:
            raise ValueError(
                "RGB-coded dataset requires a 3-channel label image, got "
                f"shape {img.shape}")
        return embedding[img[..., 0], img[..., 1], img[..., 2]]
    raise ValueError(f"Unsupported embedding ndim: {embedding.ndim}")
