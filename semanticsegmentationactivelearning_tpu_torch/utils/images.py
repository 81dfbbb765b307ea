"""Image observability: colorized input/label/prediction PNG dumps.
The port's copy of ``semanticsegmentationactivelearning_tpu/utils/images.py``.

The reference wrote per-epoch TensorBoard image summaries — the input
crop, the colormap-gathered label, and the colormap-gathered prediction
(train.py:178-206) — plus pseudo-label snapshots every 100 epochs in
the AL loop (active_learning.py:367-388). The rebuild's observability
is file-native: PNGs under ``{log_dir}/images/`` named
``{tag}-{epoch:05d}-{i}-{kind}.png``, viewable directly or via any
image browser; tools/ handles the scalar/array exports.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def colorize(label_map: np.ndarray, colormap: np.ndarray) -> np.ndarray:
    """uint8 ``[H,W]`` trainId map -> ``[H,W,3]`` via the dataset's
    ``[256,3]`` colormap LUT (255/ignore maps to the LUT's fill row)."""
    return np.asarray(colormap)[np.asarray(label_map).astype(np.uint8)]


def _save(path: str, arr: np.ndarray) -> bytes:
    from ..data import etl
    png = etl.encode_png(np.ascontiguousarray(arr))
    with open(path, "wb") as fp:
        fp.write(png)
    return png


def dump_summaries(log_dir: str, tag: str, epoch: int,
                   images: Optional[np.ndarray] = None,
                   labels: Optional[np.ndarray] = None,
                   preds: Optional[np.ndarray] = None,
                   masks: Optional[np.ndarray] = None,
                   colormap: Optional[np.ndarray] = None,
                   count: int = 2, event_writer=None) -> list:
    """Write up to ``count`` examples' input/label/prediction PNGs.

    :param images: float ``[B,H,W,3]`` in [0,1] (the network input)
    :param labels: int ``[B,H,W]`` trainIds (255 = ignore)
    :param preds:  int ``[B,H,W]`` predicted trainIds
    :param masks:  optional float/bool ``[B,H,W]``; zeroed pixels are
                   blacked out in the prediction dump (the reference
                   multiplied pseudo-labels by their confidence mask,
                   active_learning.py:374-380)
    :param event_writer: optional ``tb_events.EventWriter``; every PNG
                   is mirrored as a TB image summary at step=epoch
                   (the reference's image summaries, train.py:178-206)
    :returns: list of written paths
    """
    out_dir = os.path.join(log_dir, "images")
    os.makedirs(out_dir, exist_ok=True)
    written = []

    def _name(i, kind):
        return os.path.join(out_dir, f"{tag}-{epoch:05d}-{i}-{kind}.png")

    n = 0
    for arr in (images, labels, preds):
        if arr is not None:
            n = min(count, len(arr)) if n == 0 else n
    def _emit(i, kind, arr):
        png = _save(_name(i, kind), arr)
        written.append(_name(i, kind))
        if event_writer is not None:
            event_writer.image(f"{tag}/{i}/{kind}", png,
                               arr.shape[0], arr.shape[1], step=epoch)

    for i in range(n):
        if images is not None:
            img = np.clip(np.asarray(images[i]) * 255.0, 0, 255)
            _emit(i, "input", img.astype(np.uint8))
        if labels is not None and colormap is not None:
            _emit(i, "label", colorize(labels[i], colormap))
        if preds is not None and colormap is not None:
            rgb = colorize(preds[i], colormap)
            if masks is not None:
                rgb = rgb * (np.asarray(masks[i]) > 0)[..., None]
            _emit(i, "pred", rgb.astype(np.uint8))
    return written
