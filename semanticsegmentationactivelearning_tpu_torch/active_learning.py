"""Active-learning CLI of the PyTorch port, the counterpart of the JAX
package's root ``active_learning.py`` (reference: active_learning.py,
the flagship loop).

    python -m semanticsegmentationactivelearning_tpu_torch.active_learning \\
        {cityscapes,freiburg,vistas} -d DATA_DIR -l LOG_DIR -p CONF \\
        [-c CKPT [-r]] [-u UNLABELLED_DIR] [--seed N] [--trace DIR] \\
        [--tensorboard] [--device {cuda,cpu}]

The subcommands, flags, conf files and ``state.json`` are the JAX
CLI's, so a JAX AL log directory resumes here:

    { "checkpoint": str|null, "iteration": int,
      "dataset": { "train": {"filenames", "labelled", "unlabelled",
                             "no_label"},
                   "val":   {"filenames"},
                   "test":  {"filenames"} } }

It runs on a CUDA device (``--device cuda``, the default, raises
without one) or, with ``--device cpu``, on the CPU. Each round:
early-stopped training on the labelled set plus a pseudo-labelled
sample of the pool (warm-up grace, then ``epochs`` of patience; the
round's best checkpoint is committed on a validation mIoU gain, or
every epoch without a validation set), the restore of that checkpoint,
the test set's metrics, the pool pass (every train record's undistorted
crop, :func:`score_pool`, through ``make_score_step``: on a card ENet's
front, mid and tail score kernels, or ICNet's front + stem and CFF2 +
head score kernels) and the lowest-confidence pick
(:func:`select_lowest`), or a random draw for a negative
``selection_size``; then, for ``-u`` records, the annotation poll and
the ``state.json`` commit. ``metrics.jsonl`` gets the JAX CLI's
records: ``al_train_iter``, ``al_train``, ``al_test``,
``al_confidence`` (or ``al_coreset``) and ``al_timing`` (each phase's
wall seconds).

The conf's other acquisition strategies:

- ``measure: "bald"`` ranks the pool by ``mc_passes`` (default 8)
  MC-dropout passes (``make_mc_score_step``; a model without dropout,
  ICNet, or with every rate 0 raises the JAX CLI's ``ValueError``);
  the pass's key is ``(seed + 11, round)`` and each image's masks are
  drawn from it and the image's pool index, so the ranking does not
  depend on the batching. Pseudo-labelling then takes ``entropy``.
- ``selection: "coreset"`` embeds the pool (``make_embed_step``) and
  picks by greedy k-center from the labelled set
  (:func:`select_coreset`, ``ops.selection.k_center_greedy``), on the
  embeddings' device; it writes ``al_coreset`` instead of
  ``al_confidence``.

The pool pass's crops are drawn per example from ``(seed + 13, round,
index)`` (``pipeline.score_batch_indexed``): they do not depend on the
batching, but they are not the JAX CLI's crops, whose PRNG stream the
port does not reproduce, so the two CLIs' scores and selections differ.

It runs ENet and ICNet (ICNet's rounds train with the conf's loss;
``"softmax": {"multiscale": true}`` takes its cascade heads). ``freiburg
-m MOD ...`` stacks each record's extra modalities after its RGB planes
in every loader (labelled, validation, test and pool) and builds the
model with that many input planes; the pool pass, the pseudo step and
core-set's embed pass take all of them. ENet ranks such a pool through
the plain encoder and the decoder score kernel, ICNet through its plain
forward. Not ported (it raises before any training and names its
ROADMAP.md item): bf16 models (item 2).
``score_group`` and ``train_group`` are read and ignored: grouped
dispatch is not ported, and per-example crops make the score the same
either way.

Data-parallel over several processes: ``torchrun --nproc_per_node N -m
semanticsegmentationactivelearning_tpu_torch.active_learning ...`` (a
card a rank; ``parallel.distributed``). Every rank runs the host loop
identically, with the same seeds, as the JAX CLI's processes do: each
decodes and steps on its rows of every global batch (the conf's
``batch_size``, divisible by the world size), the validation mIoU is
the global batch's, the pool pass scores (or embeds) each rank's rows
through the kernels and gathers them in pool order, so every rank picks
the same examples. Rank 0 alone writes ``state.json``, the metrics, the
checkpoints and the images; after a barrier it broadcasts the round's
best checkpoint path, from which every rank restores. The pool pass is
data-parallel only: the JAX CLI's spatially sharded scoring is not
ported, since with the batch dividing by the world a space group would
hold as many pixels a rank as data parallelism does (ROADMAP.md "Not to
port").
"""

from __future__ import annotations

import glob
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from .data import loader, pipeline, sampler
from .data.device_prefetch import device_prefetch
from .models import conf_model_kwargs, get_model, model_class
from .ops import acquisition
from .ops import metrics as xmetrics
from .ops import selection
from .parallel import distributed
from .train import checkpoint as ckpt
from .train import config as conf
from .train import optim
from .train.__main__ import _not_ported, _on_device, run_eval_epoch
from .train.steps import (create_train_state, dropout_masks,
                          make_embed_step, make_eval_step,
                          make_mc_score_step, make_score_step,
                          make_train_step)
from .utils import cli, images

logger = logging.getLogger(__name__)


def _write_state_json(state_filename, state):
    """Atomic state.json write (tmp + rename): a reader never sees a
    truncated file."""
    tmp = state_filename + ".part"
    with open(tmp, "w") as f:
        json.dump(state, f, indent=2)
    os.replace(tmp, state_filename)


def init_or_load_state(state_filename, args, alparams, rng, write=True):
    """Initialize or restore the AL bookkeeping
    (active_learning.py:73-142): the JAX CLI's function, so the same
    seed and files give the same ``state.json``. ``write=False``
    computes the state without persisting it."""
    if os.path.exists(state_filename):
        with open(state_filename) as f:
            return json.load(f)

    train_glob = os.path.join(args.data_dir, "train", "*.tfrecord")
    if args.dataset == "freiburg":
        test_glob = os.path.join(args.data_dir, "test", "*.tfrecord")
    else:
        # cityscapes/vistas: annotated val split serves as the test set
        test_glob = os.path.join(args.data_dir, "val", "*.tfrecord")

    train_val = np.sort(np.array(glob.glob(train_glob)))
    val_examples = train_val[:alparams["num_validation"]]
    train_examples = train_val[alparams["num_validation"]:]
    test_examples = np.sort(np.array(glob.glob(test_glob)))

    train_indices = np.arange(len(train_examples), dtype=np.int64)
    rng.shuffle(train_indices)

    initially_labelled = alparams["num_initially_labelled"]
    if initially_labelled < 0:
        initially_labelled = len(train_examples)

    no_label_indices = np.empty(0, dtype=np.int64)
    if args.unlabelled is not None:
        no_label_examples = sorted(
            glob.glob(os.path.join(args.unlabelled, "*.tfrecord")))
        no_label_indices = np.arange(
            len(train_examples),
            len(train_examples) + len(no_label_examples))
        train_examples = np.concatenate(
            (train_examples, np.array(no_label_examples)))
        train_indices = np.concatenate((train_indices, no_label_indices))

    labelled = train_indices[:initially_labelled]
    unlabelled = train_indices[initially_labelled:]

    state = {
        "checkpoint": None,
        "iteration": 0,
        "dataset": {
            "train": {
                "filenames": [str(f) for f in train_examples],
                "labelled": labelled.tolist(),
                "unlabelled": unlabelled.tolist(),
                "no_label": no_label_indices.tolist(),
            },
            "val": {"filenames": [str(f) for f in val_examples]},
            "test": {"filenames": [str(f) for f in test_examples]},
        },
    }
    if write:
        _write_state_json(state_filename, state)
    return state


def poll_human_annotations(to_annotate_indices, train_examples, logger):
    """Block until the user supplies annotated record files for the
    selected truly-unlabelled examples (active_learning.py:796-823).
    Uses a tkinter file dialog when available, else stdin paths."""
    # Guard against fixed-width unicode arrays truncating new paths.
    train_examples = np.asarray(train_examples, dtype=object)
    try:
        import tkinter
        import tkinter.filedialog
        tkinter.Tk().withdraw()
        have_tk = True
    except Exception:
        have_tk = False

    while len(to_annotate_indices) > 0:
        to_annotate = train_examples[to_annotate_indices]
        basenames = [os.path.basename(p) for p in to_annotate]
        logger.info("Please annotate the following examples:\n%s",
                    "\n".join(basenames))
        if have_tk:
            filenames = tkinter.filedialog.askopenfilename(
                multiple=1, filetypes=(("TFRecord", "*.tfrecord"),))
        else:
            line = input("Paths to annotated .tfrecord files "
                         "(space-separated): ")
            filenames = line.split()
        hit = []
        for filename in filenames:
            basename = os.path.basename(filename)
            idx = -1
            for i, candidate in enumerate(to_annotate):
                if str(candidate).endswith(basename):
                    idx = i
                    break
            if idx != -1:
                train_examples[to_annotate_indices[idx]] = filename
                hit.append(idx)
            else:
                logger.info("Unrecognized filepath: %s", filename)
        to_annotate_indices = np.delete(to_annotate_indices, hit)
    return train_examples


def rank_plan(train_loader, batch_size: int, in_hw, bucket_conf="auto"):
    """The pool pass's loaders: ``[(indices, RecordLoader)]`` over the
    train loader's records, label-free. One loader on the train
    loader's storage window, or, where the records' sizes differ enough
    (``loader.size_buckets``: up to 3 windows, kept when they save at
    least 15% of the stack bytes; conf ``active_learning.size_buckets``,
    "auto", a count, or 0/1 to disable), one loader a size bucket."""
    files = train_loader.filenames
    if bucket_conf not in (0, 1, False, None) \
            and train_loader.record_dims is not None:
        nb = 3 if bucket_conf == "auto" else int(bucket_conf)
        plan, saving = loader.size_buckets(train_loader.record_dims, nb,
                                           min_hw=in_hw)
        if len(plan) > 1:
            logger.info("Pool scoring in %d size buckets (windows %s): "
                        "%.0f%% fewer stack bytes than the global %s "
                        "window", len(plan), [hw for _, hw in plan],
                        100 * saving, train_loader.storage_hw)
            return [(idx, loader.RecordLoader(
                files, batch_size, storage_hw=hw,
                channels=train_loader.channels,
                modalities=train_loader.modalities, with_label=False))
                for idx, hw in plan]
    return [(np.arange(len(files)), loader.RecordLoader(
        files, batch_size, storage_hw=train_loader.storage_hw,
        channels=train_loader.channels,
        modalities=train_loader.modalities, with_label=False))]


def pool_outputs(step, plan, pass_key, crop_hw, channels: int, device,
                 desc: str):
    """The pool pass (active_learning.py:682-715): every record of
    ``plan`` (:func:`rank_plan`) through ``device_prefetch``,
    ``pipeline.score_batch_indexed`` (the undistorted crop, drawn per
    example from ``pass_key`` and its index) and ``step({"image",
    "index"})``, ``index`` being the records' pool indices; under several
    ranks each takes its rows of every global batch (the plan's loaders
    hold a rank's share). Returns the valid rows' outputs ``[rows, ...]``
    on the device and their pool indices ``[rows]`` (on the device too),
    every rank's gathered in pool order."""
    world = distributed.process_count()

    def stream():
        for idx, ld in plan:
            yield from distributed.batches(ld, idx, ld.batch_size * world)

    total = sum(ld.num_batches(-(-len(idx) // world)) for idx, ld in plan)
    outs, rows = [], []
    for b in cli.progress(device_prefetch(stream(), device), desc,
                          total=total):
        raw = pipeline.score_batch_indexed(
            b["stack"], b["heights"], b["widths"], pass_key, b["index"],
            crop_hw, channels)
        out = step({"image": raw, "index": b["index"]})
        keep = torch.as_tensor(np.flatnonzero(b["valid"]), device=out.device)
        outs.append(out[keep])
        rows.append(torch.as_tensor(b["index"][b["valid"]],
                                    dtype=torch.int64, device=out.device))
    if not outs:
        return None, None
    return (distributed.all_gather_rows(torch.cat(outs)),
            distributed.all_gather_rows(torch.cat(rows)))


def score_pool(score_step, plan, num_examples: int, pass_key, crop_hw,
               channels: int, device, desc: str = "ranking") -> np.ndarray:
    """The pool pass's scores (:func:`pool_outputs`) as the float32
    ``[num_examples]`` confidences; they stay on the device until the
    pass ends."""
    confidence = np.zeros(num_examples, dtype=np.float32)
    scores, idx = pool_outputs(score_step, plan, pass_key, crop_hw,
                               channels, device, desc)
    if scores is not None:
        confidence[idx.cpu().numpy()] = scores.cpu().numpy()
    return confidence


def embed_pool(embed_step, plan, num_examples: int, pass_key, crop_hw,
               channels: int, device, desc: str = "embedding"
               ) -> torch.Tensor:
    """The pool pass's embeddings (:func:`pool_outputs`) as a float32
    ``[num_examples, D]`` tensor on ``device``, assembled there."""
    out, idx = pool_outputs(embed_step, plan, pass_key, crop_hw, channels,
                            device, desc)
    if out is None:
        return None
    emb = torch.zeros(num_examples, out.shape[1], dtype=torch.float32,
                      device=out.device)
    emb[idx] = out.float()
    return emb


def select_coreset(embeddings: torch.Tensor, labelled_flags: np.ndarray,
                   unlabelled: np.ndarray, selection_size: int):
    """Greedy k-center picks of up to ``selection_size`` unlabelled
    examples from the labelled set (active_learning.py:906-960), on the
    embeddings' device. ``k_center_greedy`` runs at ``max(k,
    selection_size)`` and is sliced to ``k``: its picks are
    prefix-stable. Returns (picked indices, the unlabelled examples'
    squared distances to the labelled set)."""
    k = int(np.minimum(len(unlabelled), selection_size))
    if k <= 0 or embeddings is None:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.float32)
    candidates = np.zeros(len(labelled_flags), dtype=bool)
    candidates[unlabelled] = True
    dev = embeddings.device
    picks, min_dist = selection.k_center_greedy(
        embeddings, torch.as_tensor(labelled_flags, device=dev),
        torch.as_tensor(candidates, device=dev),
        max(k, int(selection_size)))
    return (picks.cpu().numpy().astype(np.int64)[:k],
            min_dist.cpu().numpy()[unlabelled])


def select_lowest(confidence: np.ndarray, unlabelled: np.ndarray,
                  selection_size: int):
    """The ``selection_size`` unlabelled examples of lowest confidence,
    by ``np.argpartition`` as the JAX CLI picks them
    (active_learning.py:899-904). Returns (picked indices, the
    unlabelled examples' confidences)."""
    unlabelled_conf = confidence[unlabelled]
    if len(unlabelled_conf) == 0:
        return np.empty(0, dtype=np.int64), unlabelled_conf
    size = int(np.minimum(len(unlabelled), selection_size))
    idx = np.argpartition(unlabelled_conf,
                          np.minimum(size, len(unlabelled_conf) - 1))
    return unlabelled[idx[:size]], unlabelled_conf


def _check_ported(args, params) -> None:
    """Raise, naming its ROADMAP.md item, on what is not ported."""
    alparams = params["active_learning"]
    model_name = params["network"]["model"]
    if params["network"].get("dtype") in ("bfloat16", "bf16"):
        raise _not_ported("A bf16 model (network.dtype)", "2")
    # root active_learning.py:341-346: a model without dropout layers
    # (ICNet) or with every rate 0 has no MC sampling
    if alparams["measure"] in acquisition.MC_MEASURES and not (
            getattr(model_class(model_name), "uses_dropout", False)
            and any(params["hyperparams"]["dropout_rates"])):
        raise ValueError(
            f"measure {alparams['measure']!r} needs a model with active "
            f"dropout (MC sampling); {model_name} has none")
    selection_mode = alparams.get("selection", "uncertainty")
    if selection_mode not in ("uncertainty", "coreset"):
        raise ValueError(
            f"active_learning.selection must be 'uncertainty' or "
            f"'coreset', got {selection_mode!r}")


def main(args) -> int:
    params = args.params
    hparams = params["hyperparams"]
    alparams = params["active_learning"]
    _check_ported(args, params)
    device = cli.device_from_args(args.device)
    batch_size = params["batch_size"]
    world = distributed.env_world_size()
    distributed.check_batch_divisible(batch_size, world)
    # every rank runs the host loop identically (root
    # active_learning.py:168-177); rank 0 alone writes
    if distributed.launched():
        distributed.initialize_distributed(device)
    is_main = distributed.is_main()
    # this rank's rows of each global batch, from row `first` on
    local_bs = batch_size // world
    first = distributed.process_index() * local_bs

    state_filename = os.path.join(args.log_dir, "state.json")
    os.makedirs(args.log_dir, exist_ok=True)
    if is_main and not os.path.exists(os.path.join(args.log_dir,
                                                    "config.json")):
        conf.dump_params(params, args.log_dir)

    dataset = cli.make_dataset(args)
    num_classes = dataset.num_classes
    # every rank computes the same state from the seed; rank 0 persists it
    state = init_or_load_state(state_filename, args, alparams,
                               np.random.default_rng(args.seed),
                               write=is_main)
    # dtype=object: poll_human_annotations may assign longer paths
    train_examples = np.array(state["dataset"]["train"]["filenames"],
                              dtype=object)
    val_examples = np.array(state["dataset"]["val"]["filenames"])
    test_examples = np.array(state["dataset"]["test"]["filenames"])
    labelled = np.array(state["dataset"]["train"]["labelled"],
                        dtype=np.int64)
    unlabelled = np.array(state["dataset"]["train"]["unlabelled"],
                          dtype=np.int64)
    no_label_indices = np.array(state["dataset"]["train"]["no_label"],
                                dtype=np.int64)
    labelled_flags = np.zeros(len(train_examples), dtype=bool)
    labelled_flags[labelled] = True

    in_hw = (params["network"]["input"]["height"],
             params["network"]["input"]["width"])
    train_sampler = sampler.IndexSampler(
        train_examples, rng=np.random.default_rng(args.seed + 1))
    # extra modalities stack after the RGB planes in every loader
    # (active_learning.py:231-290)
    modalities = cli.extra_modalities(args)
    train_loader = loader.RecordLoader(train_examples, local_bs,
                                       min_hw=in_hw, modalities=modalities)
    in_channels = train_loader.channels
    if modalities:
        logger.info("Stacking modalities %s -> %d input channels",
                    list(modalities), in_channels)
    plan = rank_plan(train_loader, local_bs, in_hw,
                     alparams.get("size_buckets", "auto"))
    val_loader = loader.RecordLoader(val_examples, local_bs,
                                     min_hw=in_hw, modalities=modalities) \
        if len(val_examples) else None
    test_loader = loader.RecordLoader(test_examples, local_bs,
                                      min_hw=in_hw, modalities=modalities) \
        if len(test_examples) else None
    if device.type == "cuda":
        logger.info("Running on %s", torch.cuda.get_device_name(device))
    else:
        logger.info("Running on the CPU, as --device cpu asks")
    if world > 1:
        logger.info("Data-parallel over %d ranks: %d of each global batch "
                    "of %d a rank; pool scoring is data-parallel only "
                    "(spatial sharding: ROADMAP.md \"Not to port\")", world,
                    local_bs, batch_size)
    elif distributed.launched():
        logger.info("A world of one rank: the collectives run on it")
    for knob, value in (("score_group", alparams.get("score_group")),
                        ("train_group", params.get("train_group"))):
        if value is not None and int(value) > 1:
            logger.info("%s %d read and ignored: one dispatch a batch "
                        "(grouped dispatch is not ported)", knob, int(value))

    # model, optimizer and state (active_learning.py:293-336)
    model_name = params["network"]["model"]
    model = get_model(model_name, num_classes, in_channels=in_channels,
                      **conf_model_kwargs(model_name, hparams)).to(device)
    # the decay steps: batches an epoch over the initially labelled set
    steps_per_epoch = -(-max(len(labelled), 1) // batch_size)
    optimizer, scheduler = optim.make_optimizer(model.parameters(), hparams,
                                                steps_per_epoch)
    tstate = create_train_state(model, optimizer, scheduler, seed=args.seed)
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
        logger.info("Resuming from checkpoint \"%s\"", restore_from)
        ckpt.restore_training_state(restore_from, tstate)
        if args.reinitialize_output:
            ckpt.reinitialize_final_layer(
                tstate, model, torch.Generator().manual_seed(args.seed + 7))
            logger.info("Output layer %s drawn anew (-r)",
                        model.output_module)
    elif state["checkpoint"] is not None:
        logger.info("Resuming from checkpoint \"%s\"", state["checkpoint"])
        ckpt.restore_training_state(state["checkpoint"], tstate)

    # pseudo-labelling needs a per-pixel confidence in the predicted
    # label: with an MC ranking measure it takes the entropy
    measure = alparams["measure"]
    mc_measure = measure in acquisition.MC_MEASURES
    pseudo_cfg = {"measure": "entropy" if mc_measure else measure,
                  "threshold": alparams["threshold"]}
    train_step = make_train_step(model, num_classes, hparams,
                                 pseudo_cfg=pseudo_cfg)
    eval_step = make_eval_step(model, num_classes)
    if mc_measure:
        mc_passes = int(alparams.get("mc_passes", 8))
        logger.info("BALD acquisition: %d MC-dropout passes", mc_passes)
        mc_step = make_mc_score_step(model, num_classes, mc_passes)

        def score_step(batch):
            # the round's key; each image's masks follow its pool index
            return mc_step(batch, (args.seed + 11, state["iteration"]),
                           batch["index"])
    else:
        score_step = make_score_step(model, num_classes, measure)
    selection_mode = alparams.get("selection", "uncertainty")
    if selection_mode == "coreset":
        logger.info("Core-set (k-center greedy) selection enabled")
        embed_step = make_embed_step(model)
    ckpt_manager = ckpt.CheckpointManager(args.log_dir, async_io=True)
    writer = cli.MetricsWriter(args.log_dir,
                               tensorboard=getattr(args, "tensorboard",
                                                   False), enabled=is_main)
    aug_rng = np.random.default_rng(args.seed + 2)
    sel_rng = np.random.default_rng(args.seed + 3)
    img_cfg = params.get("image_summaries") or {}
    pseudo_cadence = int(img_cfg.get("pseudo_cadence", 100))
    img_count = int(img_cfg.get("count", 2))
    # step-resolution scalar cadence (train.py:167-176); 0 disables
    summary_interval = int(params.get("summary_interval", 1))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def dump_pseudo_snapshot(epoch):
        """Pseudo-label PNGs of a batch (active_learning.py:367-388), on
        rank 0; every rank draws the batch, so that the sampler stays in
        step."""
        order = train_sampler.epoch_order()[:batch_size]
        if not is_main:
            return
        b = next(iter(device_prefetch(train_loader.batches(order), device)))
        heights, widths, _ = _on_device(b, device)
        raw, _img, _lbl, _msk = pipeline.augment_batch(
            b["stack"], heights, widths,
            torch.Generator(device).manual_seed(0), crop_hw=in_hw,
            channels=in_channels)
        with torch.no_grad():
            lbl, msk, _conf = acquisition.pseudo_annotate(
                model(raw, training=False), pseudo_cfg["measure"],
                num_classes, pseudo_cfg["threshold"])
        images.dump_summaries(
            args.log_dir, "pseudo-iter%d" % state["iteration"], epoch,
            raw[..., :3].cpu().numpy(), preds=lbl.cpu().numpy(),
            masks=msk.cpu().numpy(), colormap=dataset.colormap,
            count=img_count, event_writer=writer.tb)

    def run_train_epoch(epoch_desc):
        """One training epoch over the sampler's current set."""
        order = train_sampler.epoch_order()
        acc = xmetrics.ConfusionAccumulator(num_classes)
        iter_buf = cli.StepScalarBuffer(("loss", "cost", "learning_rate"))
        step0 = int(tstate.step)
        batches = cli.progress(
            device_prefetch(distributed.batches(train_loader, order,
                                                batch_size), device),
            epoch_desc, total=-(-len(order) // batch_size))
        for b in batches:
            seed = int(aug_rng.integers(0, 2 ** 31 - 1))
            gen = torch.Generator(device).manual_seed(seed)
            heights, widths, valid = _on_device(b, device)
            raw, image, label, mask = pipeline.augment_batch(
                b["stack"], heights, widths, gen, crop_hw=in_hw,
                channels=in_channels, span=(first, batch_size))
            masks = dropout_masks(
                (args.seed + 2, state["iteration"], int(tstate.step)),
                first + np.arange(local_bs), device)
            m = train_step(tstate, {
                "image": image, "image_raw": raw, "label": label,
                "mask": mask, "valid": valid,
                "labelled": torch.as_tensor(labelled_flags[b["index"]],
                                            device=device)}, masks)
            iter_buf.append(m)
            acc.update(m["confusion"])
        scalars = iter_buf.flush()
        if summary_interval > 0:
            for i in range(0, scalars.shape[0], summary_interval):
                writer.write({
                    "split": "al_train_iter", "step": step0 + i + 1,
                    "round": state["iteration"],
                    "loss": float(scalars[i, 0]),
                    "cost": float(scalars[i, 1]),
                    "learning_rate": float(scalars[i, 2])})
        mean_loss = float(scalars[:, 0].mean()) if len(scalars) \
            else float("nan")
        return acc, mean_loss

    def train_loop(log_subdir):
        """Early-stopped AL training round (active_learning.py:523-649);
        returns the round's best checkpoint."""
        grace = alparams.get("epochs/warm_up", 0)
        best_ckpt_path = state["checkpoint"]
        best_mean_iou = 0.0
        run_name = os.path.basename(log_subdir)
        no_improvement = 0
        while no_improvement < params["epochs"] or grace >= 0:
            grace -= 1
            tstate.epoch += 1
            epoch = int(tstate.epoch)
            tacc, mean_loss = run_train_epoch(
                "%s[%d] NIC=%d" % (run_name, epoch, no_improvement))
            val_miou = 0.0
            if val_loader is not None:
                val_miou = run_eval_epoch(
                    eval_step, val_loader, in_hw, num_classes, device,
                    desc="val[%d]" % epoch, channels=in_channels).mean_iou
            writer.write({
                "split": "al_train", "round": state["iteration"],
                "epoch": epoch, "loss": mean_loss,
                "val_mean_iou": val_miou,
                "labelled": int(len(labelled)),
                "no_improvement": no_improvement,
                "confusion": tacc.metrics()["ConfusionMat"].tolist()})
            if (pseudo_cadence > 0 and state["iteration"] > 0
                    and epoch % pseudo_cadence == 0):
                dump_pseudo_snapshot(epoch)
            if is_main:
                ckpt_manager.cache(tstate)
            improved = val_miou > best_mean_iou
            if improved or val_loader is None:
                # without a validation set every epoch commits, so the
                # restore after the round keeps its training; the
                # validation mIoU is the global batch's, so every rank
                # takes this branch in the same epochs
                best_mean_iou = max(best_mean_iou, val_miou)
                if is_main:
                    committed = ckpt_manager.commit(
                        os.path.join(log_subdir, "model"))
                    if committed != "":
                        best_ckpt_path = committed
            if improved:
                no_improvement = 0
            else:
                no_improvement += 1
                if no_improvement >= params["epochs"] and grace < 0:
                    break
        # rank 0's write is done; its committed path for every rank's
        # restore (root active_learning.py:783-787)
        ckpt_manager.wait()
        distributed.sync_processes("al-round-committed")
        return distributed.broadcast_str(best_ckpt_path) or None

    def test_loop():
        """Test metrics keyed by the labelled set's size
        (active_learning.py:651-680)."""
        m = run_eval_epoch(eval_step, test_loader, in_hw, num_classes,
                           device, desc="test[%d]" % len(labelled),
                           channels=in_channels).metrics()
        writer.write({
            "split": "al_test", "round": state["iteration"],
            "labelled": int(len(labelled)),
            "mean_iou": float(m["MeanIoU"]),
            "pixel_accuracy": float(m["PixelAccuracy"]),
            "class_iou": m["ClassMeanIoU"].tolist(),
            "confusion": m["ConfusionMat"].tolist()})
        logger.info("test @%d labelled: mIoU %.4f", len(labelled),
                    m["MeanIoU"])

    iterations = alparams["iterations"]
    if iterations < 0:
        iterations = int(np.ceil(
            len(unlabelled) / float(abs(alparams["selection_size"]) or 1)))
        logger.info("Iteration count: %d", iterations)

    with cli.maybe_trace(getattr(args, "trace", None)):
        while state["iteration"] < iterations:
            t_round0 = time.time()
            phase_s = {}
            labelled0 = int(len(labelled))

            # Step 1: train on the labelled set (+ pseudo-label sample)
            train_sampler.set_indices(labelled)
            if state["iteration"] == 0:
                log_subdir = os.path.join(args.log_dir, "pretrain")
            else:
                log_subdir = os.path.join(args.log_dir,
                                          "iter-%d" % state["iteration"])
                p = alparams["pseudo_labelling_proportion"]
                if p > 0:
                    sample_size = int(len(labelled) * p / (1 - p))
                    train_sampler.set_sample_size(
                        int(np.minimum(sample_size, len(unlabelled))))
            os.makedirs(log_subdir, exist_ok=True)
            ckpt_manager.chdir(log_subdir)
            try:
                t0 = time.time()
                checkpoint_path = train_loop(log_subdir)
                sync()
                phase_s["train"] = time.time() - t0
            except KeyboardInterrupt:
                if is_main:
                    if ckpt_manager.latest_checkpoint != "":
                        state["checkpoint"] = ckpt_manager.latest_checkpoint
                    _write_state_json(state_filename, state)
                raise

            # reload the round's best checkpoint (active_learning.py:
            # 766-769), after the checkpoint write in flight
            t0 = time.time()
            ckpt_manager.wait()
            if checkpoint_path:
                ckpt.restore_training_state(checkpoint_path, tstate)
            sync()
            phase_s["restore"] = time.time() - t0

            # Step 2: test set metrics
            t0 = time.time()
            if test_loader is not None:
                test_loop()
            phase_s["test"] = time.time() - t0

            # Step 3: acquisition
            t0 = time.time()
            train_sampler.set_indices(None)
            train_sampler.set_sample_size(0)
            if alparams["selection_size"] > 0 and selection_mode == "coreset":
                emb = embed_pool(
                    embed_step, plan, len(train_examples),
                    (args.seed + 13, state["iteration"]), in_hw,
                    in_channels, device, "embedding[%d]" % len(labelled))
                low_conf, min_dists = select_coreset(
                    emb, labelled_flags, unlabelled,
                    alparams["selection_size"])
                # finite only: with no centers the distances are inf,
                # which json.dump would write as the non-JSON Infinity
                finite = min_dists[np.isfinite(min_dists)]
                writer.write({
                    "split": "al_coreset", "round": state["iteration"],
                    "selected": int(len(low_conf)),
                    "min_dist_mean": float(finite.mean())
                    if len(finite) else None,
                    "min_dist_max": float(finite.max())
                    if len(finite) else None})
            elif alparams["selection_size"] > 0:
                confidence = score_pool(
                    score_step, plan, len(train_examples),
                    (args.seed + 13, state["iteration"]), in_hw,
                    in_channels, device, "ranking[%d]" % len(labelled))
                low_conf, unlabelled_conf = select_lowest(
                    confidence, unlabelled, alparams["selection_size"])
                hist, edges = np.histogram(unlabelled_conf, bins=20,
                                           range=(0.0, 1.0))
                writer.write({
                    "split": "al_confidence", "round": state["iteration"],
                    "histogram": hist.tolist(),
                    "bin_edges": edges.tolist(),
                    "mean": float(unlabelled_conf.mean())
                    if len(unlabelled_conf) else None})
            else:
                # a negative selection_size N draws |N| at random, the
                # baseline conf's semantics (active_learning.py:785-793)
                draw = int(np.minimum(abs(alparams["selection_size"]),
                                      len(unlabelled)))
                low_conf = sel_rng.choice(unlabelled, draw, replace=False) \
                    if draw > 0 else np.empty(0, dtype=np.int64)
            phase_s["score_select"] = time.time() - t0

            # the annotation pause for truly-unlabelled selections
            to_annotate = no_label_indices[np.isin(no_label_indices,
                                                   low_conf)]
            if len(to_annotate) > 0:
                # rank 0 asks; every rank takes its answer
                if is_main:
                    train_examples = poll_human_annotations(
                        to_annotate, train_examples, logger)
                train_examples = np.array(json.loads(
                    distributed.broadcast_str(json.dumps(
                        train_examples.tolist()))), dtype=object)
            no_label_indices = no_label_indices[np.isin(
                no_label_indices, low_conf, invert=True)]
            if len(low_conf):
                logger.info("Moving following examples to labelled set:"
                            "\n%s",
                            "\n".join(train_examples[low_conf].tolist()))
            labelled_flags[low_conf] = True

            # Step 4: state commit (active_learning.py:842-854)
            labelled = np.append(labelled, low_conf)
            unlabelled = unlabelled[np.isin(unlabelled, low_conf,
                                            assume_unique=True,
                                            invert=True)]
            state["dataset"]["train"]["filenames"] = train_examples.tolist()
            state["dataset"]["train"]["labelled"] = labelled.tolist()
            state["dataset"]["train"]["unlabelled"] = unlabelled.tolist()
            state["dataset"]["train"]["no_label"] = \
                no_label_indices.tolist()
            writer.write({
                "split": "al_timing", "round": state["iteration"],
                "labelled": labelled0,
                "round_s": round(time.time() - t_round0, 3),
                **{f"{k}_s": round(v, 3) for k, v in phase_s.items()}})
            state["iteration"] += 1
            state["checkpoint"] = checkpoint_path
            if is_main:
                _write_state_json(state_filename, state)
    ckpt_manager.close()
    writer.close()
    distributed.shutdown()
    return 0


def _extra_args(parser):
    parser.add_argument(
        "-r", "--reinitialize-output-layer", action="store_true",
        dest="reinitialize_output", required=False,
        help="Reinitialize last layer of model (if checkpoint "
             "specified).")
    parser.add_argument(
        "-u", "--unlabelled-dir", type=str, default=None,
        dest="unlabelled", metavar="UNLABELLED_DIR",
        help="Path to directory containing only feature data.")


def parse_args(argv=None):
    args = cli.parse_dataset_args(
        "python -m semanticsegmentationactivelearning_tpu_torch."
        "active_learning", argv, extra_optional=_extra_args)
    args.params = conf.load_params(args.params)
    return args


if __name__ == "__main__":
    cli.setup_logging()
    _args = parse_args()
    logger.info("Running with following parameters:\n%s",
                json.dumps(_args.params, sort_keys=True, indent=4))
    sys.exit(main(_args))
