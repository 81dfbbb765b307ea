"""Steps of the PyTorch port, the counterpart of
``semanticsegmentationactivelearning_tpu/train/steps.py``.

- ``train_step`` (:func:`make_train_step`): the forward in train mode
  (batch statistics, spatial dropout, the multiscale heads when the
  conf asks for them) -> masked CE or multiscale CE, plus the L1/L2
  regularization -> backward -> optimizer and scheduler step. The
  running BN statistics move in the forward, as flax's mutable
  ``batch_stats`` do. With ``pseudo_cfg`` (the AL loop's rounds after
  the first) the unlabelled rows' targets are first pseudo-annotated
  (:func:`pseudo_targets`).
- ``eval_step`` (:func:`make_eval_step`): the eval forward -> argmax ->
  batch confusion matrix.
- ``predict_step`` (:func:`make_predict_step`): the eval forward ->
  argmax labels (the image summaries).
- ``score_step`` (:func:`make_score_step`): the AL loop's pool-scoring
  hot path (reference active_learning.py:697-698).
- ``mc_score_step`` (:func:`make_mc_score_step`): the BALD measure's
  pool score from MC-dropout passes.
- ``embed_step`` (:func:`make_embed_step`): the pool embeddings of
  core-set selection.

Every step consumes the batch's ``valid`` flags, so a padded tail batch
adds nothing to the loss or the metrics. PyTorch runs eagerly, so each
step is a plain closure over the model. The JAX steps take phase logits
(``Final(phase=True)``); their docstrings hold that the confusion counts
equal those of the plain logits for ENet, so these take the plain ones.

Under several ranks (``parallel.distributed``) each rank steps on its
rows of the global batch and the steps equal the one-process step on
the whole batch, as the JAX steps under a ``("data",)`` mesh do: batch
norm and the CE's divisor are global, the train step sums the gradients
over the ranks and adds the regularization on rank 0 alone, and the
metrics (loss, cost, confusion) are the global batch's on every rank.
Not ported: grouped dispatch, remat and spatial sharding (ROADMAP.md
"Not to port").
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..ops import acquisition, losses, metrics
from ..ops import nn as xops
from ..ops.kernels import packing
from ..parallel import distributed


@dataclasses.dataclass
class TrainState:
    """What a training run carries from step to step: the model (its
    parameters and BN statistics), the optimizer and its scheduler, the
    update count ``step`` (the reference's local_step) and the finished
    ``epoch`` count (its epoch_step)."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Any
    step: int = 0
    epoch: int = 0


def create_train_state(model, optimizer, scheduler,
                       seed: Optional[int] = None) -> TrainState:
    """A fresh ``TrainState``; with ``seed``, the model's weights are
    first drawn anew from ``torch.Generator().manual_seed(seed)``
    (``models.blocks.reset_parameters``: glorot uniform kernels, flax's
    law), the same on every device."""
    if seed is not None:
        from ..models.blocks import reset_parameters
        reset_parameters(model, torch.Generator().manual_seed(int(seed)))
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler)


def dropout_masks(key, rows, device) -> xops.MCDropout:
    """The train step's dropout masks for a batch whose rows have the
    global indices ``rows`` in the step's global batch: one pass of
    ``ops.nn.MCDropout`` keyed on ``key`` (the CLIs': the seed and the
    update count), so that a row's masks do not depend on how the batch
    is split over ranks."""
    return xops.MCDropout(key, torch.as_tensor(np.asarray(rows),
                                               device=device), (0,))


def pseudo_targets(model, batch: Dict[str, torch.Tensor],
                   pseudo_cfg: Dict[str, Any], num_classes: int):
    """The pseudo-labelling step's targets (active_learning.py:231-269,
    the JAX ``make_train_step``'s ``pseudo_cfg`` path): a no-dropout
    eval forward of ``batch["image_raw"]`` on the current weights and
    running BN statistics, ``acquisition.pseudo_annotate`` at the
    conf's measure and threshold, the pseudo mask times ``valid``; then
    a row keeps its own label and mask where ``batch["labelled"]`` and
    takes the pseudo ones elsewhere. Returns (int64 label, mask)."""
    valid = batch["valid"].float()[:, None, None]
    mask = batch["mask"] * valid
    with torch.no_grad():
        logits = model(batch["image_raw"], training=False)
        p_label, p_mask, _ = acquisition.pseudo_annotate(
            logits, pseudo_cfg["measure"], num_classes,
            pseudo_cfg["threshold"])
        labelled = batch["labelled"].bool()[:, None, None]
        label = torch.where(labelled, batch["label"], p_label.long())
        mask = torch.where(labelled, mask, (p_mask * valid).to(mask.dtype))
    return label, mask


def make_train_step(model, num_classes: int, hyperparams: Dict[str, Any],
                    pseudo_cfg: Optional[Dict[str, Any]] = None):
    """The supervised train step:
    ``train_step(state, batch, generator) -> metrics`` for ``batch =
    {"image", "label", "mask", "valid"}`` on the model's device and a
    generator of the dropout draws there (a ``torch.Generator``, or
    :func:`dropout_masks`, whose draws do not depend on the batching,
    as the CLIs pass). It updates
    ``state`` in place (weights, BN statistics, optimizer, scheduler,
    ``step += 1``) and returns ``{"loss", "cost", "learning_rate",
    "confusion"}``: the CE and CE + regularization as device scalars,
    the rate this update applied (the schedule at the pre-increment
    step) and the batch's int64 confusion matrix; under several ranks
    the global batch's, the same on every rank. The optimizer and its
    schedule are the state's (``optim.make_optimizer``).

    :param model:       the model ``state`` trains (its
                        ``ms_loss_weights``, where it has them, weigh the
                        multiscale heads)
    :param hyperparams: the conf's ``hyperparams`` block (C22 schema)
    :param pseudo_cfg:  ``{"measure", "threshold"}`` enables the AL
                        pseudo-labelling path (:func:`pseudo_targets`);
                        ``batch`` then also holds ``image_raw``, the
                        undistorted crop, and the rows' bool
                        ``labelled`` flags
    """
    if pseudo_cfg is not None \
            and pseudo_cfg["measure"] not in acquisition.MEASURES:
        # a per-pixel MI is no confidence in the predicted label: the AL
        # CLI pseudo-labels by "entropy" under an MC measure
        raise ValueError(
            f"pseudo-labelling needs one of {acquisition.MEASURES}, got "
            f"{pseudo_cfg['measure']!r}")
    softmax_cfg = hyperparams.get("softmax", {})
    reg_cfg = hyperparams.get("weight_reg", {})
    multiscale = bool(softmax_cfg.get("multiscale", False))
    weight = float(softmax_cfg.get("loginverse_scaling", 0.0))
    label_smoothing = float(softmax_cfg.get("label_smoothing", 0.0))
    l1 = float(reg_cfg.get("L1", 0.0))
    l2 = float(reg_cfg.get("L2", 0.0))
    glorot_scaling = bool(reg_cfg.get("glorot_scaling", False))
    scale_weights = getattr(model, "ms_loss_weights", None)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Any]:
        m = state.model
        if pseudo_cfg is not None:
            label, mask = pseudo_targets(m, batch, pseudo_cfg, num_classes)
        else:
            label = batch["label"]
            mask = batch["mask"] * batch["valid"].float()[:, None, None]
        outputs = m(batch["image"], training=True, multiscale=multiscale,
                    generator=generator)
        if multiscale:
            logits, heads = outputs
            loss = losses.multiscale_masked_softmax_cross_entropy(
                label, heads, mask, num_classes, weight, label_smoothing,
                scale_weights=scale_weights)
        else:
            logits = outputs
            loss = losses.masked_softmax_cross_entropy(
                label, logits, mask, num_classes, weight, label_smoothing)
        reg = losses.regularization_loss(m, l1, l2, glorot_scaling)
        # the shares of the ranks' losses sum to the global loss; the
        # regularization enters once, on rank 0
        cost = loss + (reg if distributed.is_main() else reg.detach())
        state.optimizer.zero_grad(set_to_none=True)
        cost.backward()
        distributed.all_reduce_grads(m.parameters())
        lr = state.scheduler.get_last_lr()[0]
        state.optimizer.step()
        state.scheduler.step()
        # the kernels' BN-folded packs hold the old weights and statistics
        if hasattr(m, "clear_packs"):
            m.clear_packs()
        state.step += 1
        with torch.no_grad():
            conf = distributed.all_reduce_sum(metrics.confusion_matrix(
                label, logits.argmax(dim=-1), num_classes, mask))
            loss = distributed.all_reduce_sum(loss.detach())
        return {"loss": loss, "cost": loss + reg.detach(),
                "learning_rate": lr, "confusion": conf}

    return train_step


def make_eval_step(model, num_classes: int):
    """``eval_step(batch) -> [C, C]`` int64 confusion of the eval
    forward's argmax over ``batch = {"image", "label", "mask",
    "valid"}``; under several ranks the global batch's on every rank."""

    @torch.inference_mode()
    def eval_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        pred = model(batch["image"]).argmax(dim=-1)
        mask = batch["mask"] * batch["valid"].float()[:, None, None]
        return distributed.all_reduce_sum(metrics.confusion_matrix(
            batch["label"], pred, num_classes, mask))

    return eval_step


def make_predict_step(model):
    """``predict_step(image) -> [N, H, W]`` int32 argmax labels of the
    eval forward (the image summaries; the reference colorized
    predictions in-graph, train.py:178-206)."""

    @torch.inference_mode()
    def predict_step(image: torch.Tensor) -> torch.Tensor:
        return model(image).argmax(dim=-1).to(torch.int32)

    return predict_step


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


def make_embed_step(model
                    ) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """Pool-embedding step of core-set selection: ``embed_step(batch)
    -> [N, D]`` float32, the eval forward to the model's deepest shared
    features averaged over H and W (``return_embedding=True``: ENet's
    B3_8, ICNet's CFF2 output), for ``batch = {"image": float NHWC}``
    on the model's device. The embeddings feed
    ``ops.selection.k_center_greedy``."""
    model.eval()

    @torch.inference_mode()
    def embed_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return model(batch["image"], return_embedding=True)

    return embed_step


def make_mc_score_step(model, num_classes: int, passes: int):
    """MC-dropout BALD pool scorer (the measure ``"bald"``):
    ``mc_score_step(batch, key, index) -> [N]`` float32 per-image mean
    ``1 - I(y; w | x) / log C`` for ``batch = {"image": float NHWC}`` on
    the model's device, a key (an int or a tuple of ints) and the
    images' ``[N]`` integer indices.

    It runs ``passes`` eval forwards with dropout on and batch norm on
    its running statistics (``ops.nn.MCDropout``: each image's masks
    depend only on the key, its index and the pass, so a score does not
    depend on the rest of the batch), stacked as one batch of ``passes
    * N`` images (eval keeps no activations), then, for a model with
    pre-logits (ENet), the chunked BALD tail on the Final's kernel
    (``acquisition.chunked_deconv_bald_confidence``), else
    ``acquisition.mean_bald_confidence`` on the logits."""
    use_features = getattr(model, "supports_pre_logits", False)
    model.eval()

    @torch.inference_mode()
    def mc_score_step(batch: Dict[str, torch.Tensor], key,
                      index) -> torch.Tensor:
        image = batch["image"]
        n = image.shape[0]
        masks = xops.MCDropout(key, torch.as_tensor(index,
                                                    device=image.device),
                               range(passes))
        x = image.repeat(passes, 1, 1, 1)
        if use_features:
            out = model(x, generator=masks, return_pre_logits=True)
        else:
            out = model(x, generator=masks)
        out = out.reshape(passes, n, *out.shape[1:])
        if use_features:
            kernel = model.packed(
                "final", image.device,
                lambda m: packing.deconv_hwio(m.Final.deconv))
            return acquisition.chunked_deconv_bald_confidence(
                out, kernel, num_classes)
        return acquisition.mean_bald_confidence(out, num_classes)

    return mc_score_step
