"""Inference CLI of the PyTorch port: checkpoint -> per-example
prediction PNGs (the counterpart of the JAX package's root
``inference.py``).

    python -m semanticsegmentationactivelearning_tpu_torch.inference \\
        -c CKPT -d DATA_DIR -o OUT -t cityscapes [-m {ENet,ICNet}] \\
        [-b BATCH] [-s H W] [--color] [--modalities MOD ...] \\
        [--device {cuda,cpu}]

Reads every ``.tfrecord`` under the data directory (or its test/
subdirectory), serves each batch through :func:`make_predict_fn` on
every visible CUDA device (the hand-written kernel chain of ENet or
ICNet; without a CUDA device it raises) or, with ``--device cpu``, on
the CPU (the plain PyTorch chain), and writes
``{output}/{id}.png`` with the dataset-id reverse embedding (default)
or the colormap (``--color``). ``-c`` takes a port checkpoint or one
written by the JAX package. ``--output-size H W`` serves through the
plain forward instead: the class probabilities are resized to H x W
(antialiased on the way down, as ``jax.image.resize``) before the
argmax. ``--modalities MOD ...`` stacks each record's extra modalities
after its RGB planes and builds the model with that many input planes
(a checkpoint trained on other planes fails to load with a shape
error); the kernel chains take RGB only, so such a model serves through
the plain forward, as the JAX CLI's does.

One process serves over every visible card, as the JAX CLI shards each
batch over its local devices (root inference.py:204-216): where the
batch size divides by the card count, each batch is split by rows, each
card runs its own replica's kernel chain on its rows, and the label
maps are gathered in order; otherwise it serves on the first card.

Not ported yet (it raises and names its ROADMAP.md item): ``--view``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import logging
import os
import sys

import numpy as np
import torch

from .data.device_prefetch import device_prefetch
from .models import get_model, model_class
from .ops import nn as xops
from .train import checkpoint as ckpt
from .utils import cli

logger = logging.getLogger(__name__)

_NOT_PORTED = {
    "view": "--view (the live matplotlib viewer) is not ported yet: "
            "ROADMAP.md Queue 1 item 7",
}


def kernel_route(in_channels: int, out_hw=None) -> bool:
    """Whether :func:`make_predict_fn` serves through
    ``model.fused_predict`` (the JAX CLI's ``applicable``, root
    inference.py:63-64): no resize and an RGB input."""
    return out_hw is None and in_channels == 3


def make_predict_fn(model, lut: torch.Tensor, height: int, width: int,
                    in_channels: int, devices, out_hw=None):
    """The serving hot path: a uint8 record stack ``[B, H, W, >=C]`` ->
    uint8 label (or colormap) maps cropped to ``height x width``, on the
    first of ``devices`` (a device or a list of them). Where
    :func:`kernel_route` holds, the forward is ``model.fused_predict``
    (ENet's or ICNet's): the kernel chain on CUDA, its plain version on
    the CPU. argmax(logits) equals the reference's argmax after softmax.

    Otherwise the plain forward, as the JAX ``make_predict_fn``
    computes it: the logits cropped to ``height x width``, softmax, with
    ``out_hw`` a bilinear resize of the probabilities to ``out_hw``
    (antialiased on the way down), argmax.

    With several devices each holds a replica of ``model`` and a batch
    whose size divides by their count is split by rows: each device
    serves its rows (a CUDA device's kernels launch on its own stream,
    so the cards work at once) and the maps are gathered in row order
    on the first device. Another batch size serves on the first."""
    devices = [torch.device(d) for d in (
        devices if isinstance(devices, (list, tuple)) else [devices])]
    model = model.to(devices[0]).eval()
    replicas = [model] + [copy.deepcopy(model).to(d) for d in devices[1:]]
    luts = [lut.to(d) for d in devices]
    fused = kernel_route(in_channels, out_hw)

    def serve(i: int, stack: torch.Tensor) -> torch.Tensor:
        image = stack[..., :in_channels].float().div_(255.0).contiguous()
        if fused:
            pred = replicas[i].fused_predict(image)
            return luts[i][pred[:, :height, :width].long()]
        prob = torch.softmax(replicas[i](image)[:, :height, :width],
                             dim=-1)
        if out_hw is not None:
            prob = xops.resize_bilinear(prob, out_hw)
        return luts[i][prob.argmax(dim=-1)]

    def on(d: torch.device):
        return torch.cuda.device(d) if d.type == "cuda" \
            else contextlib.nullcontext()

    @torch.inference_mode()
    def predict(stack: torch.Tensor) -> torch.Tensor:
        if len(devices) == 1 or stack.shape[0] % len(devices):
            return serve(0, stack.to(devices[0]))
        outs = []
        for i, rows in enumerate(stack.chunk(len(devices))):
            with on(devices[i]):
                outs.append(serve(i, rows.to(devices[i], non_blocking=True)))
        return torch.cat([o.to(devices[0]) for o in outs])

    return predict


def _record_files(data_dir: str, dataset) -> list:
    def tfrecords(d):
        return sorted(os.path.join(d, f) for f in os.listdir(d)
                      if f.endswith(".tfrecord"))

    files = tfrecords(data_dir)
    if not files:
        test_dir = dataset.get_test_paths(data_dir)[0]
        if os.path.isdir(test_dir):
            files = tfrecords(test_dir)
    return files


def _resolve_model_name(args) -> str:
    """``--model``, else ``network.model`` from the training run's
    ``config.json`` next to (or one level above) the checkpoint, else
    ENet."""
    if args.model:
        return args.model
    start = args.ckpt
    if not os.path.isdir(start):
        start = os.path.dirname(os.path.abspath(start))
    for d in (start, os.path.dirname(start)):
        cfg = os.path.join(d, "config.json")
        if os.path.exists(cfg):
            try:
                with open(cfg) as fp:
                    name = json.load(fp).get("network", {}).get("model")
            except (ValueError, OSError):
                continue
            if name:
                return name
    logger.info("No config.json found near checkpoint; assuming ENet")
    return "ENet"


def main(args) -> int:
    for flag, message in _NOT_PORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(message)
    model_name = _resolve_model_name(args)
    device = cli.device_from_args(args.device)
    # the record reader, dataset tables and PNG writer (the loader and
    # the writer pull in PIL); imported here so that make_predict_fn's
    # import path holds none of them
    from . import datasets
    from .data import example, loader, png_writer
    datasets_by_name = {"cityscapes": datasets.Cityscapes,
                        "freiburg": datasets.Freiburg,
                        "vistas": datasets.Vistas}
    if args.dataset not in datasets_by_name:
        raise NotImplementedError(
            f'Dataset "{args.dataset}" not yet supported.')
    dataset = datasets_by_name[args.dataset]()

    if not os.path.isdir(args.data_dir):
        logger.error("Data dir %s does not exist", args.data_dir)
        return 1
    files = _record_files(args.data_dir, dataset)
    if not files:
        logger.error("No .tfrecord files under %s", args.data_dir)
        return 1
    os.makedirs(args.output, exist_ok=True)

    height, width, channels = example.peek_dims(files[0])
    logger.info("Input records: %dx%dx%d, %d examples", height, width,
                channels, len(files))
    logger.info("Model: %s", model_name)
    div = model_class(model_name).input_divisor
    store_hw = (-(-height // div) * div, -(-width // div) * div)
    # extra modalities stack after the RGB planes, and the model takes
    # as many input planes as the records give (inference.py:169-190)
    modalities = cli.extra_modalities(args)
    rec_loader = loader.RecordLoader(files, args.batch_size,
                                     storage_hw=store_hw,
                                     modalities=modalities, with_label=False)
    in_channels = rec_loader.channels
    if modalities:
        logger.info("Stacking modalities %s -> %d input channels",
                    list(modalities), in_channels)
    model = get_model(model_name, dataset.num_classes,
                      in_channels=in_channels)

    logger.info("Loading checkpoint %s", args.ckpt)
    ckpt.restore_checkpoint(args.ckpt, model)

    lut = dataset.colormap if args.color else dataset.embedding_reversed
    if np.ndim(lut) != 1 and not args.color:
        lut = dataset.colormap  # color-coded datasets reverse-embed to it
    out_hw = tuple(args.size) if args.size else None
    if out_hw is not None:
        logger.info("Serving on %s through the plain forward, as "
                    "--output-size %dx%d asks", device, *out_hw)
    elif not kernel_route(in_channels):
        logger.info("Serving on %s through the plain forward: the kernel "
                    "chain takes RGB, the model %d input planes", device,
                    in_channels)
    elif device.type == "cuda":
        logger.info("Serving on %s (kernel chain)",
                    torch.cuda.get_device_name(device))
    else:
        logger.info("Serving on the CPU (plain chain), as --device cpu asks")
    devices = [device]
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        cards = torch.cuda.device_count()
        if args.batch_size % cards == 0:
            devices = [torch.device("cuda", i) for i in range(cards)]
            logger.info("Serving over %d cards: %d rows of each batch a "
                        "card", cards, args.batch_size // cards)
        else:
            logger.info("Serving on %s alone: the batch size %d does not "
                        "divide by the %d cards", device, args.batch_size,
                        cards)
    predict = make_predict_fn(model, torch.as_tensor(np.asarray(lut)),
                              height, width, in_channels, devices, out_hw)

    written = 0
    with png_writer.AsyncPngWriter() as writer:
        for b in device_prefetch(rec_loader.batches(), device):
            out = predict(b["stack"]).cpu().numpy()
            paths = []
            for j in range(len(out)):
                if not b["valid"][j]:
                    paths.append(None)
                    continue
                file_id = os.path.basename(
                    str(rec_loader.filenames[b["index"][j]]))
                paths.append(os.path.join(
                    args.output, file_id.replace(".tfrecord", "") + ".png"))
                written += 1
            writer.submit(paths, out)
    logger.info("Inference successfully finished (%d files).", written)
    return 0


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--checkpoint", type=str, dest="ckpt",
                        required=True,
                        help="Checkpoint file or directory (port or JAX).")
    parser.add_argument("-d", "--data-dir", type=str, dest="data_dir",
                        required=True,
                        help="Path to dataset test set directory.")
    parser.add_argument("-o", "--output", type=str, dest="output",
                        required=True,
                        help="Output directory to store prediction maps.")
    parser.add_argument("-t", "--dataset", type=str, dest="dataset",
                        required=True,
                        help="Dataset type: {cityscapes, freiburg, vistas}.")
    parser.add_argument("-m", "--model", type=str, default=None,
                        dest="model",
                        help="Model family of the checkpoint; defaults to "
                             "the network.model in the config.json next "
                             "to the checkpoint, else ENet.")
    parser.add_argument("-s", "--output-size", type=int, nargs=2,
                        dest="size", default=None,
                        help="Size of the output images: the class "
                             "probabilities of the plain forward are "
                             "resized to it before the argmax.")
    parser.add_argument("--color", action="store_true", default=False,
                        dest="color")
    parser.add_argument("--modalities", type=str, nargs="+", default=[],
                        dest="modalities",
                        help="Extra record modalities, stacked after the "
                             "RGB planes.")
    parser.add_argument("-b", "--batch-size", type=int, default=1,
                        dest="batch_size",
                        help="Images per predict call.")
    parser.add_argument("--device", choices=("cuda", "cpu"),
                        default="cuda", dest="device",
                        help="Serve on the first CUDA device (the kernel "
                             "chain; raises without one) or on the CPU "
                             "(the plain chain).")
    parser.add_argument("--view", action="store_true", default=False,
                        dest="view",
                        help="Interactive result viewer (not ported yet).")
    return parser.parse_args(argv)


if __name__ == "__main__":
    logging.basicConfig(
        level=logging.INFO,
        format="[%(levelname)s] %(asctime)s --- %(name)s : %(message)s")
    sys.exit(main(parse_arguments()))
