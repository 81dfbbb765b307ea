"""Steps of the PyTorch port, the counterpart of
``semanticsegmentationactivelearning_tpu/train/steps.py``.

So far the scoring step only: :func:`make_score_step` is the AL loop's
pool-scoring hot path (reference active_learning.py:697-698). The
train, eval and predict steps belong to the training slice (ROADMAP.md
Queue 1 item 4), the embed step to item 8. PyTorch runs eagerly, so the
step is a plain closure; the JAX package's grouped dispatch
(``lax.map`` over micro-batches) and its mesh paths are not ported
(ROADMAP.md "Not to port", Queue 1 items 9 and 10).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..ops import acquisition


def make_score_step(model, num_classes: int, measure: str,
                    fused: bool = True
                    ) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """Pool-scoring step: ``score_step(batch) -> [N]`` float32 per-image
    mean confidence for ``batch = {"image": float NHWC}`` on the model's
    device.

    With ``fused`` and a model that supports it (ENet, ICNet), the score
    runs through ``model.fused_score``: on a CUDA device ENet's front,
    mid and tail score kernels or ICNet's front+stem and CFF2 + head
    kernels, and full-resolution logits never reach memory. Otherwise
    the plain forward and ``acquisition.mean_confidence``."""
    use_fused = fused and getattr(model, "supports_fused_scoring", False)
    model.eval()

    @torch.inference_mode()
    def score_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        image = batch["image"]
        if use_fused:
            return model.fused_score(image, measure)
        logits = model(image)
        return acquisition.mean_confidence(logits, measure, num_classes)

    return score_step
