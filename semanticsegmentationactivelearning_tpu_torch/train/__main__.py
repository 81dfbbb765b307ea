"""Supervised training CLI of the PyTorch port, the counterpart of the
JAX package's root ``train.py`` (reference: train.py).

    python -m semanticsegmentationactivelearning_tpu_torch.train \\
        {cityscapes,freiburg,vistas} -d DATA_DIR -l LOG_DIR -p CONF \\
        [-c CKPT] [--seed N] [--trace DIR] [--tensorboard] \\
        [--device {cuda,cpu}]

The subcommands, flags and conf files are the JAX CLI's. It trains on
a CUDA device (``--device cuda``, the default, raises without one) or,
with ``--device cpu``, on the CPU. Each batch goes ``RecordLoader`` ->
``device_prefetch`` (uint8 stacks) -> ``pipeline.augment_batch`` ->
``train_step``; the example order comes from
``np.random.default_rng(seed + 1)``, each step's augmentation from a
``torch.Generator`` seeded from ``np.random.default_rng(seed)`` and its
dropout masks from ``(seed, step)`` and each row's index in the global
batch (``steps.dropout_masks``). Each epoch writes its ``train_iter``
and ``train`` records to ``{log_dir}/metrics.jsonl``, runs a
validation epoch (``val``), dumps image summaries at their cadence and
saves ``{log_dir}/model-N.ckpt``; the run ends with ``final_val``. It
resumes from ``-c`` or from the log directory's latest checkpoint (a
port training checkpoint whole; a JAX one's weights, step and epoch).

It trains ENet and ICNet (ICNet's conf, ``conf/icnet_cityscapes.json``,
takes the cascade loss over its three heads). ``freiburg -m MOD ...``
stacks each record's extra modalities after its RGB planes (``rgb`` and
``image`` name the RGB planes themselves) and builds the model with that
many input planes. bf16 models (ROADMAP.md Queue 1 item 2) raise.
``train_group`` is read and ignored (grouped dispatch is not ported).

Data-parallel over several processes: ``torchrun --nproc_per_node N -m
semanticsegmentationactivelearning_tpu_torch.train ...`` (a card a
rank; ``parallel.distributed`` for the backend rule). The conf's
``batch_size`` is the global batch and must divide by the world size;
each rank decodes its rows of every global batch, and a step equals the
one-process step on the global batch (global batch norm, CE divisor and
dropout keys, the gradients summed). Rank 0 alone writes
``metrics.jsonl``, the checkpoints, ``checkpoint.json``,
``config.json`` and ``images/``; every rank restores on a resume.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import sys

import numpy as np
import torch

from ..data import loader, pipeline
from ..data.device_prefetch import device_prefetch
from ..models import conf_model_kwargs, get_model
from ..ops import metrics as xmetrics
from ..parallel import distributed
from ..utils import cli, images
from . import checkpoint as ckpt
from . import config as conf
from . import optim
from .steps import (create_train_state, dropout_masks, make_eval_step,
                    make_predict_step, make_train_step)

logger = logging.getLogger(__name__)

def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md "
                               f"Queue 1 item {item}")


def _on_device(b, device):
    """The loader batch's per-row arrays as tensors on ``device``."""
    return (torch.as_tensor(b["heights"], device=device),
            torch.as_tensor(b["widths"], device=device),
            torch.as_tensor(b["valid"], dtype=torch.float32,
                            device=device))


def run_eval_epoch(eval_step, val_loader, crop_hw, num_classes, device,
                   desc="val", channels=3):
    """The eval epoch's confusion over ``val_loader``'s records (under
    several ranks each decodes its rows of every global batch, and the
    eval step sums the confusion over the ranks)."""
    acc = xmetrics.ConfusionAccumulator(num_classes)
    global_bs = val_loader.batch_size * distributed.process_count()
    batches = cli.progress(
        device_prefetch(distributed.batches(
            val_loader, np.arange(val_loader.count), global_bs), device),
        desc, total=-(-val_loader.count // global_bs))
    for b in batches:
        heights, widths, valid = _on_device(b, device)
        image, label, mask = pipeline.eval_batch(
            b["stack"], heights, widths, crop_hw=crop_hw, channels=channels)
        acc.update(eval_step({"image": image, "label": label,
                              "mask": mask, "valid": valid}))
    return acc


def main(args) -> int:
    params = args.params
    hparams = params["hyperparams"]
    model_name = params["network"]["model"]
    if params["network"].get("dtype") in ("bfloat16", "bf16"):
        raise _not_ported("A bf16 model (network.dtype)", "2")
    device = cli.device_from_args(args.device)
    batch_size = params["batch_size"]
    world = distributed.env_world_size()
    distributed.check_batch_divisible(batch_size, world)
    if distributed.launched():
        distributed.initialize_distributed(device)
    is_main = distributed.is_main()
    # this rank's rows of each global batch, from row `first` on
    local_bs = batch_size // world
    first = distributed.process_index() * local_bs
    dataset = cli.make_dataset(args)
    in_hw = (params["network"]["input"]["height"],
             params["network"]["input"]["width"])

    # coarse Cityscapes also sweeps train_extra/ (train.py:53-60)
    train_files = sorted(
        f for d in dataset.get_train_paths(args.data_dir)
        for f in glob.glob(os.path.join(d, "*.tfrecord")))
    val_files = sorted(
        f for d in (dataset.get_validation_paths(args.data_dir) or ())
        for f in glob.glob(os.path.join(d, "*.tfrecord")))
    if not train_files:
        logger.error("No training records under %s", args.data_dir)
        return 1
    # extra modalities stack after the RGB planes (train.py:100-133)
    modalities = cli.extra_modalities(args)
    train_loader = loader.RecordLoader(train_files, local_bs, min_hw=in_hw,
                                       modalities=modalities)
    in_channels = train_loader.channels
    val_loader = loader.RecordLoader(val_files, local_bs, min_hw=in_hw,
                                     modalities=modalities) \
        if val_files else None
    if modalities:
        logger.info("Stacking modalities %s -> %d input channels",
                    list(modalities), in_channels)
    train_batches = -(-len(train_files) // batch_size)
    logger.info("%d train / %d val examples", len(train_files),
                len(val_files))
    if device.type == "cuda":
        logger.info("Training on %s", torch.cuda.get_device_name(device))
    else:
        logger.info("Training on the CPU, as --device cpu asks")
    if world > 1:
        logger.info("Data-parallel over %d ranks: %d of each global batch "
                    "of %d a rank", world, local_bs, batch_size)
    elif distributed.launched():
        logger.info("A world of one rank: the collectives run on it")
    if int(params.get("train_group", 1)) > 1:
        logger.info("train_group %d read and ignored: one dispatch a step "
                    "(grouped dispatch is not ported)",
                    int(params["train_group"]))

    model = get_model(model_name, dataset.num_classes,
                      in_channels=in_channels,
                      **conf_model_kwargs(model_name, hparams)).to(device)
    optimizer, scheduler = optim.make_optimizer(model.parameters(), hparams,
                                                train_batches)
    state = create_train_state(model, optimizer, scheduler, seed=args.seed)

    # train.py:232-257: an explicit -c wins, else the log dir's latest
    restore_from = None
    if args.checkpoint is not None:
        restore_from = args.checkpoint
        if os.path.isdir(restore_from):
            restore_from = ckpt.latest_checkpoint(restore_from)
        if restore_from is None or not (
                os.path.exists(restore_from)
                or os.path.exists(restore_from + ckpt.CKPT_EXT)):
            logger.error("Checkpoint path \"%s\" is invalid.",
                         args.checkpoint)
            return 1
    elif os.path.isdir(args.log_dir) \
            and ckpt.latest_checkpoint(args.log_dir) is not None:
        restore_from = ckpt.latest_checkpoint(args.log_dir)
    if restore_from:
        logger.info("Resuming from checkpoint \"%s\"", restore_from)
        ckpt.restore_training_state(restore_from, state)

    if is_main and not os.path.exists(os.path.join(args.log_dir,
                                                    "config.json")):
        conf.dump_params(params, args.log_dir)

    manager = ckpt.CheckpointManager(args.log_dir, async_io=True)
    writer = cli.MetricsWriter(args.log_dir,
                               tensorboard=getattr(args, "tensorboard",
                                                   False), enabled=is_main)
    train_step = make_train_step(model, dataset.num_classes, hparams)
    eval_step = make_eval_step(model, dataset.num_classes)
    img_cfg = params.get("image_summaries") or {}
    img_cadence = int(img_cfg.get("cadence", 1))
    img_count = int(img_cfg.get("count", 2))
    # the summaries' eval forward runs on rank 0 alone
    predict_step = make_predict_step(model) \
        if img_cadence > 0 and is_main else None

    def dump_image_summaries(epoch):
        src, tag = (val_loader, "val") if val_loader is not None \
            else (train_loader, "train")
        b = next(iter(device_prefetch(src.batches(), device)))
        heights, widths, _ = _on_device(b, device)
        image, label, _mask = pipeline.eval_batch(
            b["stack"], heights, widths, crop_hw=in_hw,
            channels=in_channels)
        preds = predict_step(image).cpu().numpy()
        images.dump_summaries(
            args.log_dir, tag, epoch, image[..., :3].cpu().numpy(),
            label.cpu().numpy(), preds, colormap=dataset.colormap,
            count=img_count, event_writer=writer.tb)

    aug_rng = np.random.default_rng(args.seed)
    order_rng = np.random.default_rng(args.seed + 1)
    # step-resolution scalar cadence (train.py:167-176); 0 disables
    summary_interval = int(params.get("summary_interval", 1))
    start_epoch = int(state.epoch)
    logger.info("Starting training loop at epoch %d...", start_epoch + 1)

    with cli.maybe_trace(getattr(args, "trace", None)):
        for epoch in range(start_epoch + 1, params["epochs"] + 1):
            acc = xmetrics.ConfusionAccumulator(dataset.num_classes)
            iter_buf = cli.StepScalarBuffer(("loss", "cost",
                                             "learning_rate"))
            step0 = int(state.step)
            order = order_rng.permutation(len(train_files))
            batches = cli.progress(
                device_prefetch(distributed.batches(train_loader, order,
                                                    batch_size), device),
                "train[%3d/%3d]" % (epoch, params["epochs"]),
                total=train_batches)
            for b in batches:
                step_seed = int(aug_rng.integers(0, 2 ** 31 - 1))
                gen = torch.Generator(device).manual_seed(step_seed)
                heights, widths, valid = _on_device(b, device)
                _raw, image, label, mask = pipeline.augment_batch(
                    b["stack"], heights, widths, gen, crop_hw=in_hw,
                    channels=in_channels, span=(first, batch_size))
                masks = dropout_masks((args.seed, int(state.step)),
                                      first + np.arange(local_bs), device)
                m = train_step(state, {"image": image, "label": label,
                                       "mask": mask, "valid": valid}, masks)
                iter_buf.append(m)
                acc.update(m["confusion"])
            scalars = iter_buf.flush()
            train_metrics = acc.metrics()
            state.epoch += 1
            if summary_interval > 0:
                for i in range(0, scalars.shape[0], summary_interval):
                    # the i-th batch took the step to step0 + i + 1
                    writer.write({
                        "split": "train_iter", "step": step0 + i + 1,
                        "epoch": epoch,
                        "loss": float(scalars[i, 0]),
                        "cost": float(scalars[i, 1]),
                        "learning_rate": float(scalars[i, 2])})
            nan = float("nan")
            writer.write({
                "split": "train", "epoch": epoch, "step": int(state.step),
                "loss": float(scalars[:, 0].mean()) if len(scalars) else nan,
                "cost": float(scalars[:, 1].mean()) if len(scalars) else nan,
                "learning_rate": float(scalars[-1, 2]) if len(scalars)
                else nan,
                "mean_iou": float(train_metrics["MeanIoU"]),
                "pixel_accuracy": float(train_metrics["PixelAccuracy"]),
                "confusion": train_metrics["ConfusionMat"].tolist(),
            })

            if val_loader is not None:
                vm = run_eval_epoch(eval_step, val_loader, in_hw,
                                    dataset.num_classes, device,
                                    desc="val[%3d]" % epoch,
                                    channels=in_channels).metrics()
                writer.write({
                    "split": "val", "epoch": epoch, "step": int(state.step),
                    "mean_iou": float(vm["MeanIoU"]),
                    "pixel_accuracy": float(vm["PixelAccuracy"]),
                    "class_iou": vm["ClassMeanIoU"].tolist(),
                    "confusion": vm["ConfusionMat"].tolist(),
                })
                logger.info("epoch %d: val mIoU %.4f pixel-acc %.4f", epoch,
                            vm["MeanIoU"], vm["PixelAccuracy"])

            if predict_step is not None and epoch % img_cadence == 0:
                dump_image_summaries(epoch)
            if is_main:
                manager.save("model", state)

    # train.py:354-374: the final standalone validation
    if val_loader is not None:
        vm = run_eval_epoch(eval_step, val_loader, in_hw,
                            dataset.num_classes, device, desc="final-val",
                            channels=in_channels).metrics()
        writer.write({
            "split": "final_val", "epoch": params["epochs"],
            "step": int(state.step),
            "mean_iou": float(vm["MeanIoU"]),
            "pixel_accuracy": float(vm["PixelAccuracy"]),
            "class_iou": vm["ClassMeanIoU"].tolist(),
            "confusion": vm["ConfusionMat"].tolist(),
        })
        logger.info("final val mIoU %.4f", vm["MeanIoU"])
    logger.info("Training successfully finished %d epochs", params["epochs"])
    manager.close()
    writer.close()
    distributed.shutdown()
    return 0


def parse_args(argv=None):
    args = cli.parse_dataset_args(
        "python -m semanticsegmentationactivelearning_tpu_torch.train", argv)
    args.params = conf.load_params(args.params)
    return args


if __name__ == "__main__":
    cli.setup_logging()
    _args = parse_args()
    logger.info("Running with following parameters:\n%s",
                json.dumps(_args.params, sort_keys=True, indent=4))
    sys.exit(main(_args))
