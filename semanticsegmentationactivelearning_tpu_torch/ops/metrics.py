"""Streaming confusion-matrix metrics, the PyTorch port of
``semanticsegmentationactivelearning_tpu/ops/metrics.py`` (reference:
tensortools/metrics.py).

The device computes one batch confusion matrix a step with the
reference's bincount trick (``num_classes * label + pred`` weighted by
the ignore mask) as an int64 scatter-add, which needs no host sync
(``torch.bincount`` on a CUDA tensor reads the largest index back to
size its output). The JAX package's chunked one-hot matmul is a TPU
device and is not ported. Steps accumulate in int64; the derived
metrics follow metrics.py:155-224, ``max(denominator, 1)`` guards
included. ``derive_metrics`` is the port's own copy.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def confusion_matrix(labels: torch.Tensor, predictions: torch.Tensor,
                     num_classes: int, mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Batch confusion matrix ``[C, C]`` (rows labels, columns
    predictions), int64 counts on the inputs' device. The mask weighs
    each pixel after a cast to an integer, as in the JAX package; a
    pair outside the matrix counts nowhere."""
    c = num_classes
    idx = c * labels.reshape(-1).long() + predictions.reshape(-1).long()
    w = (mask.reshape(-1).long() if mask is not None
         else torch.ones_like(idx))
    inside = (idx >= 0) & (idx < c * c)
    w = torch.where(inside, w, torch.zeros_like(w))
    idx = torch.where(inside, idx, torch.zeros_like(idx))
    flat = torch.zeros(c * c, dtype=torch.int64, device=idx.device)
    return flat.index_add_(0, idx, w).reshape(c, c)


def derive_metrics(confusion: np.ndarray) -> Dict[str, np.ndarray]:
    """Host-side derived metrics from an accumulated int64 confusion
    matrix (metrics.py:155-224)."""
    conf = np.asarray(confusion, dtype=np.int64)
    samples = conf.sum()
    tp = np.diag(conf).copy()
    off = conf - np.diag(tp)
    fp = off.sum(axis=0)
    fn = off.sum(axis=1)
    tp_fp = tp + fp
    tp_fp_fn = tp_fp + fn
    tn = samples - tp_fp_fn

    class_accuracy = (tp + tn) / max(samples, 1)
    class_precision = tp / np.maximum(tp_fp, 1)
    class_recall = tp / np.maximum(tp + fn, 1)
    class_iou = tp / np.maximum(tp_fp_fn, 1)
    pixel_accuracy = tp.sum() / max(samples, 1)
    mean_iou = class_iou.mean()

    return {
        "TruePositive": tp, "TrueNegative": tn,
        "FalsePositive": fp, "FalseNegative": fn,
        "ClassAccuracy": class_accuracy,
        "ClassPrecision": class_precision,
        "ClassRecall": class_recall,
        "ClassMeanIoU": class_iou,
        "PixelAccuracy": pixel_accuracy,
        "MeanIoU": mean_iou,
        "ConfusionMat": conf,
    }


class ConfusionAccumulator:
    """Streaming int64 accumulator over steps (the reference's
    assign_add variable and reset, metrics.py:12-77).

    ``update`` only keeps the step's matrix (all on one device), which
    may still be in flight there; reading ``matrix`` sums what is
    pending in one launch and copies the sum to the host once, so the
    train loop never waits on the device for its metrics."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.reset()

    def reset(self) -> None:
        self._matrix = np.zeros((self.num_classes, self.num_classes),
                                dtype=np.int64)
        self._pending = []

    def update(self, batch_confusion: torch.Tensor) -> None:
        self._pending.append(batch_confusion)

    def _drain(self) -> None:
        if self._pending:
            pending, self._pending = self._pending, []
            self._matrix += torch.stack(pending).long().sum(dim=0) \
                .cpu().numpy()

    @property
    def matrix(self) -> np.ndarray:
        self._drain()
        return self._matrix

    def metrics(self) -> Dict[str, np.ndarray]:
        return derive_metrics(self.matrix)

    @property
    def mean_iou(self) -> float:
        return float(self.metrics()["MeanIoU"])
