#!/usr/bin/env python3
"""Smoke run of the PyTorch port's ENet and ICNet serving and
pool-scoring paths, of ENet's and ICNet's training and active-learning
loop (BALD and core-set acquisition too), of multi-modal input and the
migration entries, of its multi-process runs and of its measurement rigs
on one NVIDIA GPU (on two or more, phase 15 also runs NCCL a card a
rank).

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises, so the exit code is not 0):
  1. device: the card's name and power limit; CUDA must be present.
  2. build: nvcc compiles the kernels of
     semanticsegmentationactivelearning_tpu_torch/csrc for sm_90a, one
     process per source; prints ptxas's registers and spills and the
     HMMA (tensor-core) instruction count of each front, mid, tail, ICNet
     front, CFF2 + head and head kernel's SASS (each ICNet front, CFF2 +
     head, head and deconv score instance must have some, and no ICNet
     front, head or deconv score instance may spill).
  3. kernels: the serving kernels (front, mid, tail predict) against
     their plain PyTorch versions on the same inputs at ENet-19, batch 2,
     1024x2048, with seeded weights (glorot-uniform convs, noised BN
     statistics); also each one's time beside its plain version's. The
     front's x1, the mid's y and the tail's x4 are held to 1e-3 of the
     plain maximum and under a share of the error of the plain version
     with its products' operands rounded one precision below the route's
     (PRECISION_GATE); the front's mask1 must be one-hot with no switch
     differing where the window is decided. The front's split (Initial +
     B1_0, each stage-1 bottleneck), the mid's (B2_0, the projection
     launches, the fused and the unfused blocks, a dilated block both
     ways at d = 1, 2, 4) and the tail's (its stage-4
     and stage-5 kernels alone, the decoder score route on the plain
     stage-4 output), each with its TFLOP/s of least work.
  4. serve: a seeded checkpoint saved and restored through the port's
     checkpoint module, then make_predict_fn over uint8 batches fed by
     device_prefetch. The kernels' launch counters are zeroed before this
     run and must show every kernel launched in it; the served maps must
     agree with the plain chain where its top-2 logit margin is decided.
     Then the inference CLI on four records.
  5. score, at the active-learning loop's shape (ENet-19, batch 8,
     512x1024, conf/enet_cityscapes_active_learning.json):
     a. the front and the mid on their score route (their precision,
        gates and split as in phase 3), then the three score kernels
        (tail, decoder, deconv) against their plain versions on the
        same inputs,
        |score difference| <= 1e-4 per image, with the smoke's Final
        kernel (x25), the recipe's (x1) and a sharp one (x1000), so that
        both ends of the entropy are held; each one's time, TFLOP/s of
        least work and bound beside its plain version's time; the decoder
        route (the tail's stage-5 kernel on its score route) also under
        PRECISION_GATE with B5_0's, B5_1's and the Final's products
        rounded, the deconv kernel (the tail's Final in TF32, its weights
        as hi + lo) at each scale with the Final's, both on their per-tile sums less
        each image's mean error (centred_max); the tail's split, its
        x4 gates and TFLOP/s as in phase 3.
     b. the pool: 6 uint8 batches through device_prefetch, /255 and
        make_score_step(model, 19, "entropy"), with the counters zeroed
        before; the scores against the plain chain's; then one batch
        through each of the decoder and deconv routes of fused_score.
  6. where the time goes: torch.profiler over PROFILE_BATCHES batches
     (after 2 warm-up) of the serving and the scoring chain, each as the
     kernel chain and as the plain chain. For each: the wall time per
     batch (host clock, profiler on, ending in a synchronize), the
     device-busy share of that window (the union of the CUDA kernel and
     copy intervals over the wall time) and the device time per batch of
     each kernel name, largest first.
  7. ICNet pool scoring, at its conf's shape (ICNet-19, batch 8,
     1024x2048, conf/icnet_cityscapes.json), with seeded weights:
     a. the four ICNet kernels (front, front+stem, CFF2 + head, head)
        against their plain versions on the same inputs: f1 and stem1 to
        1e-3 of their maximum and under PRECISION_GATE (the fronts on
        their score route, all six convs rounded), f1 bit-equal between
        the two fronts, x_half to 1e-5, scores to 1e-4 per image
        and bit-equal from run to run, with the classifier x5, x1, x25
        and x1000; each one's time, TFLOP/s and bound beside its plain
        version's time; the head kernel's scores under PRECISION_GATE
        with the classifier's operands rounded (its 3xTF32 against
        TF32); the front
        + stem's launches timed alone and its TFLOP/s of least work; the CFF2
        + head kernel's split (the GEMM alone, its fused8 to 1e-3 of the
        plain maximum and under PRECISION_GATE, and the head end) and its
        TFLOP/s of least work, its bound at its route's precision, and
        its scores under PRECISION_GATE with CFF2's products rounded;
     b. the pool: 6 uint8 batches through device_prefetch, /255 and
        make_score_step(icnet, 19, "entropy"), with the counters zeroed
        before (front+stem's launches and CFF2 + head once a batch); the scores
        against the plain chain's; then one batch each through the
        fuse_cff2=False and fuse_stem=False routes;
     c. the phase-6 breakdown of ICNet's scoring chain, kernel and
        plain.
  8. ICNet serving, at ENet serving's shape (ICNet-19, batch 2,
     1024x2048, fp32), with seeded weights:
     a. the two fronts on their predict route, checked and timed as in
        7a (the precision gate one below 3xTF32); the two predict kernels
        (CFF2 + head, head) against their plain
        versions on the same inputs (the plain chain's fused16 and
        fused8), with the classifier x5 and x25: no label may differ
        where the plain logits' top-2 margin exceeds 1e-3, and at least
        99% of the pixels must be so decided; each one's time, TFLOP/s
        and bound beside its plain version's time; the CFF2 + head
        kernel's split and gate as in 7a (fused8 in 3xTF32) and the
        decided labels that its plain version in TF32 moves; the score
        twins timed at batch 2, the head kernel's scores under its gate
        as in 7a;
     b. serving: 10 uint8 batches through device_prefetch and
        make_predict_fn, with the counters zeroed before (front+stem's
        launches and CFF2 + head predict once a batch); the maps against the plain
        forward's on decided pixels (at most 1e-4 of them may differ);
        the kernel chain's time beside the plain chain's; then one batch
        each through the fuse_cff2=False and fuse_stem=False routes of
        fused_predict;
     c. the inference CLI on four ICNet records with a checkpoint whose
        config.json names ICNet, once plainly and once with
        --output-size at half the record size;
     d. the phase-6 breakdown of ICNet's serving chain, kernel and plain.
  9. the rigs, each run once through its script at its default size
     with the counters zeroed before (tools/probe_launch_overhead.py,
     probe_matmul_floor.py and probe_front_packing.py of the port), then
     each rig kernel against its plain version on the scripts' inputs:
     every sum within 1e-5 (fp32) or 1e-2 (bf16) of the sum of the
     magnitudes it adds up.
  10. training, ENet-19 at 512x1024 (the confs' network.input), plain
     PyTorch with cuDNN (no kernel of its own):
     a. one train step at batch 2 with SGD and every dropout rate 0,
        from the same seeded weights and uint8 batch, on the card and on
        the CPU in fp32 and in float64, for conf/enet_cityscapes_pretrain.json
        (multiscale) and conf/enet_cityscapes_active_learning.json
        (log-inverse 1.02); on the card once at torch's default
        precision (cuDNN convs in TF32, the CLI's) and once with TF32
        off. The loss (relative), every parameter's gradient (relative
        L2 a tensor, the largest) and the new BN running statistics
        (the largest difference over the largest magnitude) against
        each CPU step, under the conf's and precision's bounds in
        TRAIN_BOUNDS (the statistics gated against the float64 step,
        STATS_REF); the float64 step takes the 2x2 pool switches of the
        card's fp32 step, and every window where they are not its own
        choice must be tied within TIE_TOL; the CPU's fp32 step against
        its float64 step too;
     b. speed at batch 8 (both confs' batch_size) with the confs'
        dropout, Adam and loss, at the default precision: augment_batch
        on a uint8 1024x2048 stack on the card, then train_step; median
        of TRAIN_TIMED steps after TRAIN_WARMUP, CUDA events; ms/step and
        images/s; then LEARN_STEPS steps on one fixed batch from the
        seeded weights, after which the pretrain conf's loss must be
        under half its first value;
     c. the phase-6 breakdown of 5 train steps of each conf;
     d. the train CLI in child processes, as phase 4's CLI: 16 labelled
        512x1024 records (colour blocks that give the class) and 4
        validation records, 2 epochs from the pretrain conf, then a
        resume for a third (it must start at epoch 3 and step 4); the
        records of metrics.jsonl (splits and keys), the numbered
        checkpoints, and epoch 2's training loss under epoch 1's; then
        the inference CLI serves the trained checkpoint through the
        kernel chain.
  11. the active-learning loop, ENet-19 at the AL conf's 512x1024 input
     and batch 8, on 36 + 4 synthetic 1024x2048 colour-block records:
     a. the pseudo-labelling step at batch 2, each part with the
        entropy threshold at the unlabelled row's median confidence on
        the CPU: its targets (the undistorted crop's eval forward,
        pseudo_annotate, the labelled row kept; the smoke's weights,
        Final x25) on the card against the CPU's, equal but on at most
        AL_FLIPS of the pixels decided by AL_DECIDED (the undecided are
        counted); then one pseudo step (SGD, dropout 0, TF32 off, phase
        10a's weights) on the card against the CPU's in fp32 and
        float64 on the targets the card's step used, under the AL
        conf's fp32 TRAIN_BOUNDS (the loss gated against the fp32 step,
        AL_LOSS_REF);
     b. the CLI's pool pass (active_learning.score_pool and
        select_lowest) over 32 records in this process, with the kernel
        and the plain score step: the scores within 1e-4 an image, the
        same selection but for scores within 1e-4 of the cut, and the
        counters (zeroed before) at front 5, mid 21 and tail score 2 a
        batch; then the pass over the records listed 8 times, timed
        with decode, H2D and the selection (median of 3 after 1),
        beside phase 5b's device-only rate;
     c. the AL CLI in child processes, with the conf cut to short
        rounds (epochs 1, no warm-up, 4 validation records, 8 initially
        labelled, 8 selected, learning rate 1e-7): two rounds, then side
        by side a resume to a third, a random-baseline round (no score
        kernel may launch) and -c <the first round's best> -r;
        state.json, the records' keys, the round directories, the
        kernels' launches and each round's al_timing.
  12. secondary acquisition, ENet-19 at the BALD conf's shape (batch 8,
     512x1024, mc_passes 8), plain PyTorch with cuDNN (the JAX package
     reaches no Pallas kernel here):
     a. the MC-dropout BALD step (train/steps.make_mc_score_step) on the
        card against the port's CPU step on the same weights, images,
        pool indices and key, hence the same masks (ops.nn.MCDropout's
        hash), at TF32 off and on: each image's score within MC_TOL
        (the CPU scores the first two images alone), and masks of
        another key must move a score by more than the bound; then the
        MC pool pass's images/s on the device (the passes stacked as
        one batch), the embed pass's, a forward's masks drawn a call a
        block (as MCDropout draws them) and in one go, and the MC pass
        under torch.profiler;
     b. ops.selection.k_center_greedy on the card at Cityscapes' pool
        size (N 2975, D 128, k 50, 50 centers) against a numpy oracle:
        the picks equal; its time;
     c. the AL CLI in two child processes side by side, one round each
        with the BALD and the core-set conf cut as in 11c: state.json,
        the records (al_confidence, al_coreset, al_timing), the log
        lines, no entropy score kernel launched, the card in use.
  13. ICNet's training, ICNet-19 from conf/icnet_cityscapes.json
     (Momentum 0.9, lr 1e-3, the cascade CE over cls4, aux8 and aux16
     weighted 1.0, 0.4, 0.4, L2 1e-4), plain PyTorch with cuDNN (the JAX
     train step reaches no Pallas kernel):
     a. phase 10a's check at ICNET_CHECK_HW with ICNet's seeded weights
        (BN means N(0, 0.1)) under TRAIN_BOUNDS["icnet"];
     b. phase 10b at the conf's batch 8 and 1024x2048 (augment_batch on
        a uint8 stack of 1024x2048 records), the learning check after
        ICNET_LEARN_STEPS steps;
     c. phase 10c's breakdown of 5 ICNet train steps;
     d. phase 10d with ICNet's conf on 16 + 4 records of 1024x2048: the
        inference CLI (-m ICNet) serves the trained checkpoint, and its
        counters must show the front + stem (#9) and CFF2 + head predict
        (#12) kernels launched once a batch; its children run beside
        13e's;
     e. the AL CLI on ICNet in child processes on phase 11's records,
        the AL conf made ICNet's (network.model, softmax.multiscale) and
        cut as 11c: an entropy round, whose pool pass must launch the
        front + stem's three kernels and CFF2 + head score (#11) once a
        batch, a core-set round and BALD side by side, BALD to exit with
        the JAX CLI's ValueError before state.json exists.
  14. Freiburg multi-modal and the migration entries, ENet on
     conf/freiburg_forest.json's shape (batch 8, 432x648, Freiburg's 6
     classes, RGB and the NIR plane: 4 input planes):
     a. a synthetic Freiburg tree (train/ and test/, each with rgb/,
        nir_gray/ and GT_color/ PNGs of seeded colour blocks in the
        dataset's colours), then the port's generate_dataset in a child
        process with --modalities rgb nir_gray: the records' splits,
        image size, 4 stacked planes and NIR plane;
     b. #7 (the decoder score route, tail5_kernel on its score route)
        at this shape (eighth grid 54x81: partial edge tiles), where the
        4-plane ENet's fused_score takes it: against its plain version
        on the same stage-4 features and the route against the plain
        chain, within SCORE_TOL an image at each Final scale of
        SCORE_SCALES, bit-equal run to run, its tile sums over their
        pixels under PRECISION_GATE at the first (the edge tiles are
        partial); its time, plain time and bound;
        the eval forward against the CPU's (phase 3's 1e-3 gate); the
        4-plane train step's ms/step at batch 8 (TF32 convs, median of
        10 after 3) and FB_LEARN_STEPS steps on one batch halving the
        loss;
     c. the CLIs with freiburg -m rgb nir_gray in child processes: an
        AL round (the AL conf at 432x648, cut as 11c) beside the train
        CLI (2 epochs of conf/freiburg_forest.json) and then the
        inference CLI on its checkpoint, which serves through the plain
        route (no kernel launched) the maps of this process's plain
        forward on decided pixels; the AL round's pool pass must launch
        #7 once a batch and no other kernel;
     d. the reference-checkpoint importer without TensorFlow: a seeded
        ENet-19 with the multiscale heads as the reference's variables
        (reference_variables, the inverse of train/tf_import's mapping)
        through convert_reference_variables, every tensor back
        bit-equal; the imported model serves batch 2 at 1024x2048
        through #1, #3 and #5 with the original's labels; then a 4-plane
        one, which a 3-plane model refuses and which scores a batch
        through #7 as the original does.
  15. multi-process runs (parallel.distributed), after phase 14 on phase
     11's records; each rank a child process with torchrun's variables:
     a. one train step of conf/enet_cityscapes_pretrain.json (dropout
        on, its masks keyed by the global rows; TF32 off) at batch 8,
        512x1024, as two ranks sharing the card over Gloo (4 rows
        each), against one process's step on the same card, batch and
        masks: the plain step in fp32 and in float64 and the step of a
        world of one rank (the ranks' BN code), the loss and every
        gradient (relative L2) against each, the BN statistics against
        the world of one (DP_STATS_REF), under the conf's fp32
        TRAIN_BOUNDS; the ranks' gradients bit-equal; each run's ms/step
        and the gradient all-reduce's ms;
     b. as two ranks sharing the card: the train CLI (the AL conf, one
        epoch) and one AL round cut as 11c, the round also in one process
        first: only rank 0 opens files for writing under the log
        directory, the records, the picks equal one process's, each
        rank's pool pass launches #1, #3 and #6 once a global batch, and
        each run's al_timing;
     c. the train CLI in a one-rank world, which the backend rule puts on
        NCCL. With two cards or more, 15a and 15b again over NCCL a card
        a rank, and make_predict_fn over two cards against one (each card
        launching its front, mid and tail once a batch); otherwise one
        line saying that this machine did not run that route.
Prints the card, a JSON line of per-kernel results, and last
{"ok": true, "device": {...}}. Neither this process nor its child
processes (the record writer and the CLI) import JAX or the JAX package;
each checks its own modules at its end.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import PIL.Image  # the CLI phases write and read PNGs
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

N, H, W, CLASSES = 2, 1024, 2048, 19
# the AL loop's scoring shape: batch_size 8 at 512x1024
# (conf/enet_cityscapes_active_learning.json), fp32
SN, SH, SW = 8, 512, 1024
POOL_BATCHES = 6
# ICNet's scoring shape: batch_size 8 at 1024x2048
# (conf/icnet_cityscapes.json), fp32
IN, IH, IW = 8, 1024, 2048
# The seeded classifier alone gives scores near 0.05 at this shape; x5
# moves them to about 0.5, x1000 near 1. Phase 7a also holds x25, the
# scale of ENet's Final kernel in phase 5a.
ICNET_CLS_SCALE = 5.0
ICNET_SCALES = (ICNET_CLS_SCALE, 1.0, 25.0, 1000.0)  # phase 7a's classifiers
# The recipe alone gives logits with a standard deviation of about 0.04,
# and only ~91% of pixels clear the 1e-3 label margin; a trained
# classifier spreads its logits over units. Scaling the Final kernel by
# 25 brings the decided share above 99% (measured on CPU at 256x512).
FINAL_SCALE = 25.0
SCORE_SCALES = (FINAL_SCALE, 1.0, 1000.0)  # phase 5a's Final kernels
SCORE_TOL = 1e-4                           # |score difference| per image
BATCHES, WARMUP = 10, 2  # served batches; the first WARMUP are not timed
REPS = 5                 # timed runs per kernel and per plain version
PROFILE_BATCHES = 5      # phase 6's profiled batches per chain
# published H100 SXM peaks: fp32 outside the tensor cores, HBM3, dense
# TF32 and bf16 on the tensor cores
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
PEAK_TF32, PEAK_BF16 = 495e12, 989e12
# the peak of a kernel on the tensor cores by its route's precision
# (front.PRECISION, mid.PRECISION, tail.PRECISION): 3xTF32 takes three
# TF32 products per multiply-add
TC_PEAK = {"3xTF32": PEAK_TF32 / 3, "TF32": PEAK_TF32}
_PALLAS = "semanticsegmentationactivelearning_tpu/ops/pallas_kernels.py"
_CSRC = "semanticsegmentationactivelearning_tpu_torch/csrc"
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "front": (f"{_CSRC}/front.cu", f"{_PALLAS}:1474"),
    "front_score": (f"{_CSRC}/front.cu", f"{_PALLAS}:1474"),
    "mid": (f"{_CSRC}/mid.cu", f"{_PALLAS}:2184"),
    "mid_score": (f"{_CSRC}/mid.cu", f"{_PALLAS}:2184"),
    "tail": (f"{_CSRC}/tail.cu", f"{_PALLAS}:2810"),
    "tail_score": (f"{_CSRC}/tail.cu", f"{_PALLAS}:2720"),
    "decoder_score": (f"{_CSRC}/tail.cu", f"{_PALLAS}:687"),
    "deconv_score": (f"{_CSRC}/tail.cu", f"{_PALLAS}:344"),
    "icnet_front_stem": (f"{_CSRC}/icnet_front.cu", f"{_PALLAS}:3346"),
    "icnet_front_stem_predict": (f"{_CSRC}/icnet_front.cu",
                                 f"{_PALLAS}:3346"),
    "icnet_front": (f"{_CSRC}/icnet_front.cu", f"{_PALLAS}:3189"),
    "icnet_front_predict": (f"{_CSRC}/icnet_front.cu", f"{_PALLAS}:3189"),
    "icnet_cff2_head_score": (f"{_CSRC}/icnet_head.cu", f"{_PALLAS}:3604"),
    "icnet_head8_score": (f"{_CSRC}/icnet_head.cu", f"{_PALLAS}:198"),
    "icnet_cff2_head_predict": (f"{_CSRC}/icnet_head.cu", f"{_PALLAS}:3677"),
    "icnet_head8_predict": (f"{_CSRC}/icnet_head.cu", f"{_PALLAS}:267"),
    "probe_launch": (f"{_CSRC}/probe_launch.cu",
                     "tools/probe_pallas_overhead.py:81"),
    "probe_matmul": (f"{_CSRC}/probe_matmul.cu",
                     "tools/probe_mosaic_floor.py:103 and "
                     "tools/probe_front_packing.py:134"),
}
# the ICNet front's kernels (csrc/icnet_front.cu), the head kernel
# (csrc/icnet_head.cu) and the deconv score kernel (csrc/tail.cu): phase 2
# fails on an instance with no HMMA or with spills (the CFF2 + head
# kernel's: on one with no HMMA)
ICNET_FRONT = ("branch1_kernel", "stem12_kernel", "stem3_kernel")
NO_SPILLS = ICNET_FRONT + ("head8_kernel", "deconv_score_kernel")
DECONV_INSTANCES = 4  # csrc/tail.cu deconv_for: 1-4 n-tiles a chunk
HMMA_GATED = NO_SPILLS + ("cff2_head_kernel",)
# phase 8a's classifiers: x5 already decides >99.9% of pixels at the
# 1e-3 margin (measured on the CPU at 256x512); x25 is ENet's Final scale
ICNET_PREDICT_SCALES = (ICNET_CLS_SCALE, 25.0)
RIG_TOL = {"bf16": 1e-2, "fp32": 1e-5}  # |k - p| / sum of magnitudes
# appended to each child script: fail if it imported JAX or the JAX
# package
JAX_SIDE = ("jax", "flax", "optax", "semanticsegmentationactivelearning_tpu")
LEAK_CHECK = (
    "import sys as _s\n"
    "_bad = sorted(m for m in _s.modules\n"
    f"              if m.split('.')[0] in {JAX_SIDE!r})\n"
    "if _bad:\n"
    "    raise SystemExit(f'imported JAX or the JAX package: {_bad}')\n")


# phase 10: the training slice (ENet-19, the confs' 512x1024 input)
TRAIN_CONFS = {"pretrain": "conf/enet_cityscapes_pretrain.json",
               "al": "conf/enet_cityscapes_active_learning.json"}
TN, TB, TH, TW = 2, 8, 512, 1024   # 10a's batch, 10b's batch, the input
TRAIN_WARMUP, TRAIN_TIMED, LEARN_STEPS = 3, 10, 20
DEV = "cuda"   # phase 10's device
# 10a's bounds on the card's step against the CPU's (in fp32 and in
# float64 alike), by conf and the card's precision: the loss (relative),
# the largest relative L2 error of a parameter's gradient, the BN
# statistics' largest difference over their largest magnitude. Set from
# their first measurement on the card (PERF.md §2): fp32 read at most
# 1.1e-7, 4.8e-3 and 1.3e-6, TF32 at least 1.1e-5, 7.5e-2 and 3.9e-4;
# each fp32 bound sits at least 10x under the TF32 run's error, each
# bound about 3x over its own run's.
TRAIN_BOUNDS = {
    "pretrain": {"default": {"loss": 4e-5, "grad": 0.25, "stats": 1.5e-3},
                 "fp32": {"loss": 1e-6, "grad": 5e-3, "stats": 1e-5}},
    "al": {"default": {"loss": 1e-4, "grad": 0.7, "stats": 1.5e-3},
           "fp32": {"loss": 1e-6, "grad": 1.5e-2, "stats": 1e-5}},
    "icnet": {"default": {"loss": 1e-3, "grad": 4.0, "stats": 1.5e-2},
              "fp32": {"loss": 1e-6, "grad": 0.1, "stats": 1e-5}}}
# ICNet's (13a, 1024x2048) by the same rule from their first measurement
# (PERF.md §6, seed 0; seeds 1 and 2 read within them): fp32 at most
# 2.8e-7, 3.4e-2 and 2.7e-6, TF32 3.6e-4, 1.34 and 4.5e-3. ICNet's
# train-mode step at batch 2 is ill-conditioned: the CPU's own fp32
# gradients sit 2-3% (relative L2) from its float64 ones, and TF32 convs
# move them by 50-130%, so the TF32 bound on the gradients catches gross
# faults only; the fp32 run holds them.
# 10a and 13a gate the BN statistics against the CPU's float64 step alone
# and print them against its fp32 step: at a near-tied pool window (ENet's
# 2x2 B2_0, ICNet's 3x3 stem pool) the CPU's fp32 step can take another
# switch than float64 does, which the card's step follows (10a at seed 1:
# 1.506e-5 against the fp32 step, 9.7e-7 against float64). The loss and
# the gradients are gated against both. The float64 step takes the card's
# fp32 ENet pool switches (forced_switches): at seed 3 its own choice
# differed from both fp32 steps' at a near-tied B2_0 window (1.485e-5 of
# the statistics, PERF.md). Each window where the card's switch is not
# float64's own must be tied: its top-two margin at most TIE_TOL of the
# largest magnitude of its image and channel (an fp32 forward's rounding
# at B2_0; a flip at a decided window fails the phase).
STATS_REF = "fp64"
TIE_TOL = 1e-6
# 11a gates the pseudo step's loss against the CPU's fp32 step alone and
# prints it against its float64 step: at seeds 0-4 the card's fp32 loss
# sat within 5.3e-7 of the CPU's fp32 loss, and the CPU's own fp32 loss
# sat 1.051e-6 and 1.045e-6 from its float64 loss at seeds 2 and 3 (the
# float32 sum of the CE over the batch's 1M pixels), so a float64 gate
# at 1e-6 passed or failed the card by the rounding of the CPU's fp32
# step (the per-seed figures: PERF.md §6). The gradients and the
# statistics are gated against both; the float64 step takes the card's
# pool switches, as 10a's does.
AL_LOSS_REF = "fp32"
# the keys of each metrics.jsonl record of the train CLI (the JAX CLI's)
TRAIN_RECORD_KEYS = {
    "train_iter": {"split", "step", "epoch", "loss", "cost",
                   "learning_rate", "wall_time"},
    "train": {"split", "epoch", "step", "loss", "cost", "learning_rate",
              "mean_iou", "pixel_accuracy", "confusion", "wall_time"},
    "val": {"split", "epoch", "step", "mean_iou", "pixel_accuracy",
            "class_iou", "confusion", "wall_time"},
    "final_val": {"split", "epoch", "step", "mean_iou", "pixel_accuracy",
                  "class_iou", "confusion", "wall_time"}}


def seeded_state_dict(model, seed: int, final_scale: float = FINAL_SCALE,
                      name: str = "ENet") -> dict:
    """Glorot-uniform conv weights, BN scale 1 / bias 0 with running
    mean |N(0, 0.3)| and var 1 + |N(0, 0.3)|, PReLU 0.25 (the noised-BN
    recipe of the JAX package's kernel tests), from numpy; the output
    layer (ENet's Final kernel, ICNet's classifier) is scaled by
    ``final_scale``. For ``name`` "ICNet" the running means are N(0, 0.1)
    instead: |N| means leave its ReLU outputs all zero after a few
    blocks."""
    rng = np.random.default_rng(seed)
    state = model.state_dict()
    icnet = name == "ICNet"
    out = {}
    for key, v in state.items():
        shape = tuple(v.shape)
        if key.endswith(".weight") and len(shape) == 4:
            rf = shape[2] * shape[3]
            lim = np.sqrt(6.0 / (rf * (shape[0] + shape[1])))
            a = rng.uniform(-lim, lim, size=shape)
        elif key.endswith("running_mean") and icnet:
            a = rng.normal(size=shape, scale=0.1)
        elif key.endswith("running_mean"):
            a = np.abs(rng.normal(size=shape, scale=0.3))
        elif key.endswith("running_var"):
            a = 1.0 + np.abs(rng.normal(size=shape, scale=0.3))
        elif key.endswith(".alpha"):
            a = np.full(shape, 0.25)
        elif key.endswith(".weight"):
            a = np.ones(shape)
        else:
            a = np.zeros(shape)
        if key in ("Final.deconv.weight", "Classifier.weight"):
            a = a * final_scale
        out[key] = torch.tensor(a, dtype=torch.float32)
    return out


def hmma_counts(lib_path) -> dict:
    """The tensor-core instructions (HMMA) in each kernel's SASS of the
    built library, by ``cuobjdump -sass``; {} where the toolkit has no
    cuobjdump."""
    exe = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                       "cuobjdump")
    if not os.path.exists(exe):
        print("build: no cuobjdump in the toolkit, SASS not read")
        return {}
    sass = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True,
                          text=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA" in ln:
            counts[fn] += 1
    return counts


def ptxas_spills(log: str) -> dict:
    """Bytes of spill stores and loads of each kernel in ptxas's ``-v``
    output (``build.Build.log``)."""
    spills, fn = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif fn is not None and "spill stores" in ln:
            words = ln.replace(",", " ").split()
            spills[fn] = sum(int(words[i - 2]) for i, w in enumerate(words)
                             if w == "spill")
    return spills


def cuda_ms(fn) -> float:
    """Median CUDA-event time of ``fn()`` over REPS runs after one."""
    fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def count_flops(fn, args) -> float:
    """The convolution and matmul FLOPs of ``fn(*args)`` (a plain
    version), run on meta copies of ``args``."""
    meta = []
    for a in args:
        if isinstance(a, torch.Tensor):
            meta.append(torch.empty_like(a, device="meta"))
        elif isinstance(a, torch.nn.Module):
            m = copy.deepcopy(a).to("meta")
            m.clear_packs()
            meta.append(m)
        else:
            meta.append(a)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        fn(*meta)
    return float(fc.get_total_flops())


def roofline(args, outs, flops: float, peak: float = PEAK_FLOPS,
             fp32_flops: float = 0.0) -> dict:
    """The least time the card could take for ``flops`` operations on
    ``args`` (and ``fp32_flops`` more on the CUDA cores): the largest of
    the operations of each kind over its peak (``flops`` over ``peak``,
    the fp32 peak unless the kernel computes them in another precision;
    the tensor and CUDA cores issue side by side, so their times do not
    add) and of the bytes (each input read once, each output in ``outs``
    written once) over the memory rate. A model in ``args`` counts as
    all of its weights (1.4 MB for ENet-19, 27 MB for ICNet-19, more
    than any one kernel reads): pass the tensors a kernel reads where
    its bound is set by bytes."""
    nbytes = 0
    for a in args:
        if isinstance(a, torch.Tensor):
            nbytes += a.numel() * a.element_size()
        elif isinstance(a, torch.nn.Module):
            nbytes += sum(p.numel() * p.element_size()
                          for p in a.parameters())
    nbytes += sum(o.numel() * o.element_size() for o in outs)
    t_ops = max(flops / peak, fp32_flops / PEAK_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops + fp32_flops, bytes=nbytes)


def softmax_flops(n, h, w, c) -> float:
    """Per pixel and class of an entropy score: subtract the maximum,
    exp, multiply, and two adds."""
    return 5.0 * n * h * w * c


def window_gap(x: torch.Tensor) -> torch.Tensor:
    """Top-2 gap of every 2x2 pool window: [N,H,W,C] -> [N,H/2,W/2,C]."""
    n, h, w, c = x.shape
    win = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    top2 = win.reshape(n, h // 2, w // 2, c, 4).topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def decided_labels(logits: torch.Tensor, margin: float):
    """(argmax, mask of pixels whose top-2 margin exceeds ``margin``)."""
    top2 = logits.topk(2, dim=-1).values
    return logits.argmax(dim=-1), (top2[..., 0] - top2[..., 1]) > margin


def check_kernels(model, seed: int) -> dict:
    """Each kernel against its plain version on the same inputs."""
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        tail)
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 1)
    stack = torch.from_numpy(
        rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)).to(dev)
    image = stack.float() / 255.0
    res = {}
    x1p, m1p, res["front"] = check_front(model, image, score=False)
    with torch.no_grad():
        # mid, on the plain front's output
        yp, sw2p, res["mid"] = check_mid(model, x1p, score=False)
        # tail, on the plain mid's and front's outputs
        lk = tail.fused_tail_predict(yp, sw2p, m1p, model)
        logits = model.forward_tail(yp, sw2p.reshape(N, H // 8, W // 8 * 64),
                                    tail.mask_to_switches(m1p))
        want, decided = decided_labels(logits, 1e-3)
        del logits
        frac = decided.float().mean().item()
        diff = (lk.long() - want).abs()[decided]
        bad = int((diff != 0).sum().item())
        print(f"tail: {bad} decided labels differ ({frac:.5f} of pixels "
              f"decided at margin 1e-3)")
        if bad or frac < 0.99:
            raise AssertionError("tail labels disagree with the plain ones")
        res["tail"] = dict(
            max_abs_err=float(diff.max().item()) if diff.numel() else 0.0,
            ms=cuda_ms(lambda: tail.fused_tail_predict(yp, sw2p, m1p, model)),
            plain_ms=cuda_ms(
                lambda: tail.tail_predict_plain(yp, sw2p, m1p, model)),
            **roofline((yp, sw2p, m1p, model), (lk,), count_flops(
                tail.tail_predict_plain, (yp, sw2p, m1p, model)),
                TC_PEAK[tail.PRECISION["predict"]]))
        res["tail"].update(tail_split(yp, sw2p, m1p, model, res["tail"],
                                      score=False))
    for k, r in res.items():
        print(f"{k}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms "
              f"(batch {N}, {H}x{W})")
    return res


def check_front(model, image, score: bool) -> tuple:
    """The front on one route against its plain version on ``image``: x1
    to 1e-3 of its maximum and under PRECISION_GATE, mask1 one-hot with
    no switch differing where Initial's pooled window has a top-2 gap
    above 1e-4; its time, the plain version's, its bound at the route's
    peak, and its split (tools/probe_front.py ``front_split``) with its
    TFLOP/s of least work. Returns (the plain x1, the plain mask1, the
    result)."""
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        front)
    from semanticsegmentationactivelearning_tpu_torch.tools.probe_front \
        import front_split
    route = "score" if score else "predict"
    precision = front.PRECISION[route]
    n, h, w, _ = image.shape
    with torch.no_grad():
        x1p, m1p = front.front_stage1_plain(image, model)
        x1k, m1k = front.fused_front_stage1(image, model, score=score)
        err = (x1k - x1p).abs().max().item()
        bound = 1e-3 * x1p.abs().max().item()
        if not err <= bound:
            raise AssertionError(f"front x1 ({route}): max err {err} > "
                                 f"{bound}")
        gap = window_gap(model.Initial(image))
        win = (n, h // 4, w // 4, 4, 16)
        swk = m1k.reshape(win).argmax(dim=3)
        swp = m1p.reshape(win).argmax(dim=3)
        onehot = bool((m1k.reshape(win).sum(3) == 1).all()
                      and ((m1k == 0) | (m1k == 1)).all())
        bad = ((swk != swp) & (gap > 1e-4)).sum().item()
        print(f"front ({route}): x1 max|k-p| {err:.3e} (bound {bound:.3e}); "
              f"mask1 one-hot {onehot}, {bad} decided switches differ "
              f"({(gap > 1e-4).float().mean().item():.5f} decided)")
        if bad or not onehot:
            raise AssertionError("front mask1 disagrees with the plain one")
        del gap, swk, swp
        # Initial's products stay fp32 on both routes: only B1_0..B1_4's
        # are rounded for the gate
        precision_gate(f"front x1, {route}", precision, err, model,
                       lambda m: front.front_stage1_plain(image, m)[0], x1p,
                       front.TC_BLOCKS)
        r = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: front.fused_front_stage1(image, model,
                                                        score=score)),
            plain_ms=cuda_ms(lambda: front.front_stage1_plain(image, model)),
            **roofline((image, model), (x1k, m1k),
                       count_flops(front.front_stage1_plain, (image, model)),
                       TC_PEAK[precision]))
        del x1k, m1k
        sp = front_split(front, model, image, score, REPS)
    r["tflops"] = r["flops"] / r["ms"] / 1e9
    blocks = ", ".join(f"{sp[f'b1_{i}']:.3f}"
                       for i in range(1, front.STAGE1_BLOCKS + 1))
    print(f"front {route} split (batch {n}, {h}x{w}, {precision}, "
          f"{front.LAUNCHES_PER_CALL} launches): Initial + B1_0 "
          f"{sp['b10']:.3f} ms, B1_1-4 {blocks} ms (launch errors "
          f"{sp['b10_err']:.2e}, {sp['blocks_err']:.2e}); the front "
          f"{r['ms']:.3f} ms = {r['tflops']:.1f} TFLOP/s of least work "
          f"({r['flops'] / 1e9:.2f} GFLOP), bound {r['bound_ms']:.3f} ms "
          f"({r['bound_by']})")
    return x1p, m1p, r


def check_mid(model, x1, score: bool) -> tuple:
    """The mid kernel on one route against its plain version on ``x1``:
    y to 1e-3 of its maximum and under PRECISION_GATE, no sw2 value
    differs where the pooled window's top-2 gap exceeds 1e-4; its time,
    the plain version's, its bound at the route's peak, and its split
    (tools/probe_mid.py ``mid_split``) with its TFLOP/s of least work.
    Returns (the plain y, the plain sw2, the result)."""
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import mid
    from semanticsegmentationactivelearning_tpu_torch.tools.probe_mid import (
        FUSABLE_DILATIONS, mid_split)
    route = "score" if score else "predict"
    precision = mid.PRECISION[route]
    n, hq, wq, _ = x1.shape
    with torch.no_grad():
        yp, sw2p = mid.mid_stage23_plain(x1, model)
        yk, sw2k = mid.fused_mid_stage23(x1, model, score=score)
        err = (yk - yp).abs().max().item()
        bound = 1e-3 * yp.abs().max().item()
        if not err <= bound:
            raise AssertionError(f"mid y ({route}): max err {err} > {bound}")
        gap = window_gap(x1)
        bad = ((sw2k != sw2p) & (gap > 1e-4)).sum().item()
        print(f"mid ({route}): y max|k-p| {err:.3e} (bound {bound:.3e}); "
              f"{bad} decided sw2 values differ "
              f"({(gap > 1e-4).float().mean().item():.5f} decided)")
        if bad:
            raise AssertionError("mid sw2 disagrees with the plain one")
        precision_gate(f"mid y, {route}", precision, err, model,
                       lambda m: mid.mid_stage23_plain(x1, m)[0], yp)
        r = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: mid.fused_mid_stage23(x1, model, score=score)),
            plain_ms=cuda_ms(lambda: mid.mid_stage23_plain(x1, model)),
            **roofline((x1, model), (yk, sw2k),
                       count_flops(mid.mid_stage23_plain, (x1, model)),
                       TC_PEAK[precision]))
        del yk, sw2k
        sp = mid_split(mid, model, x1, yp, score, REPS)
    r["tflops"] = r["flops"] / r["ms"] / 1e9
    print(f"mid {route} split (batch {n}, {4 * hq}x{4 * wq}, {precision}, "
          f"{mid.LAUNCHES_PER_CALL} launches): B2_0 {sp['b20']:.3f} ms, the "
          f"projection launches {sp['proj']:.3f}, the fused blocks "
          f"{sp['fused']:.3f}, the unfused blocks {sp['unfused']:.3f} (sum "
          f"{sp['total']:.3f}); a dilated block fused/unfused at d = 1, 2, "
          f"4: " + ", ".join(f"{sp[f'd{d}_fused']:.3f}/"
                             f"{sp[f'd{d}_unfused']:.3f}"
                             for d in FUSABLE_DILATIONS)
          + f"; the mid {r['ms']:.3f} ms = {r['tflops']:.1f} TFLOP/s of "
          f"least work ({r['flops'] / 1e9:.2f} GFLOP), bound "
          f"{r['bound_ms']:.3f} ms ({r['bound_by']})")
    return yp, sw2p, r


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10-bit mantissa, to nearest with ties
    away from zero (``cvt.rna.tf32.f32``), kept as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (to nearest even), kept as float32."""
    return x.to(torch.bfloat16).float()


def rounded(model, rnd, fn, parts=("",)):
    """``fn(m)`` (a plain function of the model) on a copy ``m`` of
    ``model`` with both operands of every product (each conv's,
    transposed conv's and 1x1 classifier's input and weights) inside the
    submodules named ``parts`` (the whole model by default) rounded by
    ``rnd`` and float32 sums: what a kernel that multiplies those
    products at that precision computes."""
    from semanticsegmentationactivelearning_tpu_torch.models import (
        blocks, icnet)
    m = copy.deepcopy(model)
    mods = {mod for name in parts for mod in m.get_submodule(name).modules()}
    for mod in mods:
        if isinstance(mod, (blocks.Conv, blocks.ConvTranspose,
                            icnet.Conv1x1Bias)):
            mod.weight.data = rnd(mod.weight.data)
            mod.register_forward_pre_hook(
                lambda _, args: (rnd(args[0]),) + args[1:])
    with torch.no_grad():
        return fn(m)


# A kernel's output (the tail's x4, the mid's y, the front's x1) against
# its plain version with every product that the kernel runs on the
# tensor cores rounded one precision below the route's (rounded; the
# front's Initial stays fp32): a route's error must stay under this share
# of that one, so that a kernel computing at the lower precision fails.
# A TF32 pass reads 6-11x less than a bf16 one at x4, 5-12x less at y,
# 6-9x less at x1, 7.5x at ICNet's fused8 and 10.7x at its scores,
# 3xTF32 about 1e3x less than a TF32 one (48x at fused8)
# (tests/test_torch_{tail,mid,front,cff2}_pack.py, PERF.md).
PRECISION_GATE = {"3xTF32": ("TF32", round_tf32, 0.1),
                  "TF32": ("bf16", round_bf16, 0.5)}


def max_abs(d: torch.Tensor) -> float:
    return d.abs().max().item()


def centred_max(d: torch.Tensor) -> float:
    """The max |error| of per-tile sums ``[N, tiles]`` less each image's
    mean error: without the one shift that rounding a layer's weights
    adds to every tile alike, which one rounding can cancel by chance
    and another not (tests/test_torch_{deconv,tail}_pack.py)."""
    return (d - d.mean(dim=1, keepdim=True)).abs().max().item()


def tile_pixels(hq: int, wq: int, device) -> torch.Tensor:
    """The pixels of each 32x32-pixel tile of ``tail5_kernel`` (its
    partial sums' order, row-major) on an image of 4hq x 4wq: fewer at
    the bottom and right edges where 32 does not divide the image."""
    rows = (4 * hq - 32 * torch.arange(-(-hq // 8), device=device)).clamp(
        max=32)
    cols = (4 * wq - 32 * torch.arange(-(-wq // 8), device=device)).clamp(
        max=32)
    return (rows[:, None] * cols[None, :]).reshape(-1).double()


def precision_gate(what: str, precision: str, err: float, model, fn,
                   want, parts=("",), measure=max_abs) -> None:
    """Raise unless ``err`` (a kernel's error against ``want``,
    ``fn(model)``, by ``measure`` of the difference: max |error| by
    default) is under PRECISION_GATE's share of the error of ``fn`` with
    the products that the kernel runs at ``precision`` (those inside the
    submodules ``parts``) rounded one precision below."""
    lower, rnd, share = PRECISION_GATE[precision]
    err_lower = measure(rounded(model, rnd, fn, parts) - want)
    print(f"{what} ({precision}): max|k-p| {err:.3e}; the plain version "
          f"in {lower} {err_lower:.3e}, the gate {share:g} of it")
    if not err <= share * err_lower:
        raise AssertionError(f"{what}: max err {err} is not below "
                             f"{share:g} of {lower}'s {err_lower}")


def tail_split(y, sw2, m1, model, r: dict, score: bool) -> dict:
    """The tail's two kernels timed alone on the inputs of its check
    (stage 4, then stage 5 + Final + argmax or entropy), x4 against the
    plain stage 4 (to 1e-3 of its maximum, and to PRECISION_GATE),
    the decoder score route on the plain stage 4's output (stage 5 +
    Final + entropy: the same stage-5 kernel through its own wrapper),
    and the tail's achieved TFLOP/s of least work (``r``'s flops over
    its ms)."""
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        decoder, tail)
    n, h8, w8, _ = y.shape
    precision = tail.PRECISION["score" if score else "predict"]
    with torch.no_grad():
        f4 = model.forward_stage4(y, sw2.reshape(n, h8, w8 * 64))
        x4 = tail.fused_tail_stage4(y, sw2, model, score)
        err = (x4 - f4).abs().max().item()
        bound = 1e-3 * f4.abs().max().item()
        if not err <= bound:
            raise AssertionError(f"tail x4: max err {err} > {bound}")
        precision_gate("tail x4", precision, err, model,
                       lambda m: m.forward_stage4(
                           y, sw2.reshape(n, h8, w8 * 64)), f4)
        out = dict(
            stage4_ms=cuda_ms(
                lambda: tail.fused_tail_stage4(y, sw2, model, score)),
            stage5_ms=cuda_ms(lambda: tail.fused_tail_decode(
                x4, m1, model, score)),
            decoder_ms=cuda_ms(lambda: decoder.fused_decoder_entropy_score(
                f4, None, model, mask=m1)),
            tflops=r["flops"] / r["ms"] / 1e9)
    print(f"tail {'score' if score else 'predict'} split (batch {n}, "
          f"{8 * h8}x{8 * w8}, {precision}): x4 max|k-p| {err:.3e} "
          f"(bound {bound:.3e}); stage 4 {out['stage4_ms']:.3f} ms, stage 5 "
          f"+ Final {out['stage5_ms']:.3f} ms, the decoder score route on "
          f"the plain stage-4 output {out['decoder_ms']:.3f} ms; the tail "
          f"{r['ms']:.3f} ms = {out['tflops']:.1f} TFLOP/s of least work "
          f"({r['flops'] / 1e9:.2f} GFLOP), bound {r['bound_ms']:.3f} ms "
          f"({r['bound_by']})")
    return out


def plain_predict(model, lut, stack):
    """The serving chain through the plain versions of its kernels."""
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        front, mid, tail)
    with torch.inference_mode():
        image = stack.float().div_(255.0)
        x1, m1 = front.front_stage1_plain(image, model)
        y, sw2 = mid.mid_stage23_plain(x1, model)
        return lut[tail.tail_predict_plain(y, sw2, m1, model).long()]


def serve(model_state: dict, seed: int):
    """The main path: checkpoint round trip, make_predict_fn over
    device_prefetch. Returns (launch counts, kernel ms/batch, plain
    ms/batch, the restored model)."""
    from semanticsegmentationactivelearning_tpu_torch.data.device_prefetch \
        import device_prefetch
    from semanticsegmentationactivelearning_tpu_torch.inference import (
        make_predict_fn)
    from semanticsegmentationactivelearning_tpu_torch.models import (
        get_model)
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        front, mid, tail)
    from semanticsegmentationactivelearning_tpu_torch.train import (
        checkpoint)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        src = get_model("ENet", CLASSES)
        src.load_state_dict(model_state)
        path = checkpoint.save_checkpoint(os.path.join(tmp, "model-1.ckpt"),
                                          src)
        model = get_model("ENet", CLASSES)
        checkpoint.restore_checkpoint(path, model)
    lut = torch.arange(256, dtype=torch.uint8)  # raw class ids
    predict = make_predict_fn(model, lut, H, W, 3, dev)
    rng = np.random.default_rng(seed + 2)
    host = [{"stack": rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)}
            for _ in range(BATCHES)]

    wrappers = (front.fused_front_stage1, mid.fused_mid_stage23,
                tail.fused_tail_predict)
    for fn in wrappers:
        fn.launches = 0
    outs, stacks, times = [], [], []
    for b in device_prefetch(iter(host), dev):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs.append(predict(b["stack"]))
        end.record()
        stacks.append(b["stack"])
        times.append((start, end))
    torch.cuda.synchronize()
    launches = [fn.launches for fn in wrappers]
    per_batch = (front.LAUNCHES_PER_CALL, mid.LAUNCHES_PER_CALL,
                 tail.LAUNCHES_PER_CALL)
    print(f"serve: {len(outs)} batches, launches front/mid/tail "
          f"{launches} (expected {[p * len(outs) for p in per_batch]})")
    if len(outs) != BATCHES or launches != [p * BATCHES for p in per_batch]:
        raise AssertionError("the serving run did not launch every kernel "
                             "once per batch")
    kernel_ms = float(np.median([s.elapsed_time(e)
                                 for s, e in times[WARMUP:]]))

    ptimes, lut = [], lut.to(dev)
    for stack in stacks:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        plain_predict(model, lut, stack)
        end.record()
        ptimes.append((start, end))
    torch.cuda.synchronize()
    plain_ms = float(np.median([s.elapsed_time(e)
                                for s, e in ptimes[WARMUP:]]))

    # the served maps against the plain chain's logits, first batch
    out = outs[0]
    if out.shape != (N, H, W) or out.dtype != torch.uint8 \
            or out.device.type != "cuda":
        raise AssertionError(f"served maps: {out.shape} {out.dtype}")
    bad, count, frac = served_disagreement(model, stacks[0], out)
    print(f"serve: kernel chain {kernel_ms:.3f} ms/batch, plain chain "
          f"{plain_ms:.3f} ms/batch (median of {BATCHES - WARMUP}); "
          f"{bad} decided pixels differ from the plain forward "
          f"({frac:.5f} decided)")
    # Unlike the per-kernel checks, the two chains feed each stage
    # slightly different inputs (fp32 sums in another order), so a pool
    # window whose top two values nearly tie may pick another switch and
    # move an unpooled value; allow such flips on 1e-4 of the pixels.
    if bad > 1e-4 * count or frac < 0.99:
        raise AssertionError("served maps disagree with the plain forward")
    return launches, kernel_ms, plain_ms, model


def run_cli(model, seed: int, name: str = "ENet", sizes=(None,)) -> None:
    """The port's inference CLI on four 1024x2048 records, once for each
    ``--output-size`` in ``sizes`` (None: the records' own size). The
    records are written, and read by the CLI, with the port's TFRecord
    and example modules; both run in child processes, which check at
    their end that they imported neither JAX nor the JAX package. The
    checkpoint's config.json names ``name``, as a training run's does."""
    from semanticsegmentationactivelearning_tpu_torch.train import (
        checkpoint)
    writer = (
        "import sys, numpy as np, io\n"
        "from PIL import Image\n"
        "from semanticsegmentationactivelearning_tpu_torch.data import "
        "example, tfrecord\n"
        "rng = np.random.default_rng(int(sys.argv[2]))\n"
        "def png(a):\n"
        "    b = io.BytesIO(); Image.fromarray(a).save(b, format='PNG')\n"
        "    return b.getvalue()\n"
        "for i in range(4):\n"
        f"    img = rng.integers(0, 256, ({H}, {W}, 3), dtype=np.uint8)\n"
        f"    lbl = np.zeros(({H}, {W}), np.uint8)\n"
        "    ex = example.SegExample(file_id=f'r{i}', height=img.shape[0],"
        " width=img.shape[1], label=png(lbl),"
        " modalities={'image': (png(img), 'png', 3)})\n"
        "    tfrecord.write_record_file(f'{sys.argv[1]}/r{i}.tfrecord',"
        " example.make_example(ex))\n" + LEAK_CHECK)
    cli = (
        "import runpy, sys\n"
        "sys.argv[0] = 'inference'\n"
        "try:\n"
        "    runpy.run_module("
        "'semanticsegmentationactivelearning_tpu_torch.inference',"
        " run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    if e.code:\n"
        "        raise\n"
        + LEAK_CHECK)
    with tempfile.TemporaryDirectory() as tmp:
        rec, run = os.path.join(tmp, "rec"), os.path.join(tmp, "run")
        os.makedirs(rec)
        os.makedirs(run)
        with open(os.path.join(run, "config.json"), "w") as fp:
            json.dump({"network": {"model": name}}, fp)
        ck = checkpoint.save_checkpoint(os.path.join(run, "m.ckpt"), model)
        subprocess.run([sys.executable, "-c", writer, rec, str(seed)],
                       check=True)
        for size in sizes:
            out = os.path.join(tmp, f"out{size}")
            flags = ["-s", *map(str, size)] if size else []
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-c", cli, "-c", ck, "-d", rec, "-o", out,
                 "-t", "cityscapes", "-b", "2", *flags],
                capture_output=True, text=True)
            if res.returncode != 0 or f"Model: {name}" not in res.stderr:
                raise AssertionError("inference CLI failed:\n" + res.stdout
                                     + res.stderr[-4000:])
            pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
            shape = np.asarray(PIL.Image.open(os.path.join(out, pngs[0]))
                               ).shape if pngs else None
            print(f"cli ({name}, {' '.join(flags) or 'record size'}): "
                  f"{len(pngs)} PNGs of {shape} in "
                  f"{time.perf_counter() - t0:.1f} s")
            if pngs != [f"r{i}.png" for i in range(4)] \
                    or shape != tuple(size or (H, W)):
                raise AssertionError(f"inference CLI wrote {pngs} {shape}")


def score_model(seed: int, final_scale: float, name: str = "ENet"):
    from semanticsegmentationactivelearning_tpu_torch.models import (
        get_model)
    model = get_model(name, CLASSES)
    model.load_state_dict(seeded_state_dict(model, seed, final_scale, name))
    return model.cuda().eval()


def check_score_kernels(seed: int) -> dict:
    """Phase 5a: each score kernel against its plain version on the same
    inputs (the plain chain's activations of one seeded batch), at each
    Final scale of SCORE_SCALES; timed at the first."""
    from semanticsegmentationactivelearning_tpu_torch.ops import acquisition
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        deconv_score, decoder, front, mid, packing, tail)
    rng = np.random.default_rng(seed + 3)
    image = torch.from_numpy(rng.integers(0, 256, (SN, SH, SW, 3),
                                          dtype=np.uint8)).cuda()
    image = image.float() / 255.0
    model = score_model(seed, FINAL_SCALE)
    x1, _, front_score = check_front(model, image, score=True)
    res = {"front_score": front_score,
           "mid_score": check_mid(model, x1, score=True)[2]}
    del x1
    for scale in SCORE_SCALES:
        model = score_model(seed, scale)
        with torch.no_grad():
            x1, m1 = front.front_stage1_plain(image, model)
            y, sw2 = mid.mid_stage23_plain(x1, model)
            f4 = model.forward_stage4(y, sw2.reshape(SN, SH // 8,
                                                     SW // 8 * 64))
            pre = model.decode_from_stage4(f4, tail.mask_to_switches(m1))
            kernel = packing.deconv_hwio(model.Final.deconv).contiguous()
            record = tail.pack_final(kernel, CLASSES)
            cases = {
                "tail_score": (tail.fused_tail_entropy_score,
                               tail.tail_score_plain, (y, sw2, m1, model)),
                "decoder_score": (
                    lambda f, m, mdl: decoder.fused_decoder_entropy_score(
                        f, None, mdl, mask=m),
                    decoder.decoder_score_plain, (f4, m1, model)),
                "deconv_score": (
                    lambda p, k, c: deconv_score.fused_deconv_entropy_score(
                        p, k, c, record=record),
                    deconv_score.deconv_score_plain, (pre, kernel, CLASSES)),
            }
            for name, (fused, plain, args) in cases.items():
                got, want = fused(*args), plain(*args)
                again = fused(*args)
                err = (got - want).abs().max().item()
                print(f"{name} (Final x{scale:g}): scores "
                      f"{[round(v, 6) for v in got.tolist()]}, max "
                      f"|k-p| {err:.3e}, repeat identical "
                      f"{torch.equal(got, again)}")
                if not err <= SCORE_TOL or not torch.isfinite(got).all():
                    raise AssertionError(f"{name}: scores differ by {err}")
                if not torch.equal(got, again):
                    raise AssertionError(f"{name}: not bit-repeatable")
                r = res.setdefault(name, dict(max_abs_err=0.0))
                r["max_abs_err"] = max(r["max_abs_err"], err)
                if name == "deconv_score":
                    # on the per-tile sums (a per-image mean is one shift
                    # a rounding of the weights can cancel in by chance)
                    parts = deconv_score.deconv_partials(
                        pre, kernel, CLASSES, record=record)
                    want_t = deconv_score.deconv_partials_plain(
                        pre, kernel, CLASSES)
                    precision_gate(
                        f"deconv tile sums (Final x{scale:g})",
                        tail.PRECISION["score"],
                        centred_max(parts - want_t), model,
                        lambda m: tail.tile_sums(
                            acquisition.confidence_map(
                                m.Final(pre), "entropy", CLASSES)),
                        want_t, ("Final",), centred_max)
                    del parts, want_t
                if len(r) == 1:  # time at the first scale only
                    r["ms"] = cuda_ms(lambda: fused(*args))
                    r["plain_ms"] = cuda_ms(lambda: plain(*args))
                    # every score kernel runs the tail's code on its score
                    # route
                    peak = TC_PEAK[tail.PRECISION["score"]]
                    # the decoder route reads f4, mask1 and the tail
                    # pack's stage-5 records, not the whole model; the
                    # deconv kernel the features and the Final's record
                    read = args
                    if name == "decoder_score":
                        first = tail.tail_layout(CLASSES)[tail.T5_FIRST][0]
                        read = (f4, m1, model.packed(
                            "tail", f4.device, tail.pack_tail)[first:])
                    if name == "deconv_score":
                        read = (pre, record)
                    r.update(roofline(read, (got,), count_flops(plain, args)
                                      + softmax_flops(SN, SH, SW, CLASSES),
                                      peak))
                    if name == "tail_score":
                        r.update(tail_split(y, sw2, m1, model, r, score=True))
                    if name == "decoder_score":  # as deconv's
                        parts = tail.launch_decode(f4, m1, model, True)
                        want_t = tail.decode_partials_plain(f4, m1, model)
                        precision_gate(
                            "decoder tile sums", tail.PRECISION["score"],
                            centred_max(parts - want_t), model,
                            lambda m: tail.decode_partials_plain(
                                f4, m1, m), want_t,
                            ("Bottleneck5_0", "Bottleneck5_1", "Final"),
                            centred_max)
                        del parts, want_t
        del x1, m1, y, sw2, f4, pre
    for k, r in res.items():
        print(f"{k}: kernel {r['ms']:.3f} ms "
              f"({r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s of least work), "
              f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}) (batch {SN}, {SH}x{SW})")
    return res


def prefetched(host, stacks):
    """The uint8 batches of ``host`` through device_prefetch; each stack
    on the device is also appended to ``stacks``."""
    from semanticsegmentationactivelearning_tpu_torch.data.device_prefetch \
        import device_prefetch
    for b in device_prefetch(iter(host), "cuda"):
        stacks.append(b["stack"])
        yield b["stack"]


def timed_scores(step, stacks):
    """``step({"image": stack / 255})`` on each uint8 stack, each timed
    with CUDA events: (the scores, the median ms after WARMUP batches)."""
    out = []
    for stack in stacks:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        scores = step({"image": stack.float().div_(255.0)})
        end.record()
        out.append((scores, start, end))
    torch.cuda.synchronize()
    ms = float(np.median([s.elapsed_time(e) for _, s, e in out[WARMUP:]]))
    return [sc for sc, _, _ in out], ms


def score_pool(seed: int):
    """Phase 5b, the scoring path: uint8 batches through device_prefetch,
    /255 and make_score_step; then the decoder and deconv routes of
    fused_score once each. Returns (launch counts, kernel ms/batch,
    plain ms/batch)."""
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        deconv_score, decoder, front, mid, tail)
    from semanticsegmentationactivelearning_tpu_torch.train.steps import (
        make_score_step)
    model = score_model(seed, FINAL_SCALE)
    score_step = make_score_step(model, CLASSES, "entropy")
    plain_step = make_score_step(model, CLASSES, "entropy", fused=False)
    rng = np.random.default_rng(seed + 4)
    host = [{"stack": rng.integers(0, 256, (SN, SH, SW, 3), dtype=np.uint8)}
            for _ in range(POOL_BATCHES)]

    wrappers = (front.fused_front_stage1, mid.fused_mid_stage23,
                tail.fused_tail_entropy_score, tail.fused_tail_predict,
                decoder.fused_decoder_entropy_score,
                deconv_score.fused_deconv_entropy_score)
    for fn in wrappers:
        fn.launches = 0
    stacks = []
    scores, kernel_ms = timed_scores(score_step, prefetched(host, stacks))
    launches = [fn.launches for fn in wrappers]
    per_batch = [front.LAUNCHES_PER_CALL, mid.LAUNCHES_PER_CALL,
                 tail.LAUNCHES_PER_CALL, 0, 0, 0]
    print(f"score: {len(scores)} batches, launches front/mid/tail score/"
          f"tail predict/decoder/deconv {launches} (expected "
          f"{[p * POOL_BATCHES for p in per_batch]})")
    if launches != [p * POOL_BATCHES for p in per_batch]:
        raise AssertionError("the pool run did not go front -> mid -> tail "
                             "score once per batch")
    plain, plain_ms = timed_scores(plain_step, stacks)
    err = max((k - p).abs().max().item() for k, p in zip(scores, plain))
    print(f"score: kernel chain {kernel_ms:.3f} ms/batch "
          f"({1e3 * SN / kernel_ms:.1f} images/s), plain chain "
          f"{plain_ms:.3f} ms/batch ({1e3 * SN / plain_ms:.1f} images/s) "
          f"(median of {POOL_BATCHES - WARMUP}, batch {SN}, {SH}x{SW}); "
          f"max |k-p| score {err:.3e}; first batch "
          f"{[round(v, 6) for v in scores[0].tolist()]}")
    if scores[0].shape != (SN,) or scores[0].dtype != torch.float32 \
            or not all(torch.isfinite(s).all() for s in scores):
        raise AssertionError(f"scores: {scores[0].shape} {scores[0].dtype}")
    if not err <= SCORE_TOL:
        raise AssertionError("pool scores disagree with the plain chain")

    image = stacks[0].float() / 255.0
    route_launches = {}
    for name, fn, kw in (("decoder_score", decoder.fused_decoder_entropy_score,
                          dict(fuse_tail=False)),
                         ("deconv_score",
                          deconv_score.fused_deconv_entropy_score,
                          dict(fuse_decoder=False))):
        fn.launches = 0
        got = model.fused_score(image, "entropy", **kw)
        torch.cuda.synchronize()
        route_launches[name] = fn.launches
        err = (got - plain[0]).abs().max().item()
        print(f"score: fused_score({kw}) launched {name} {fn.launches} "
              f"time(s); max |k-p| {err:.3e}")
        if fn.launches != 1 or not err <= SCORE_TOL:
            raise AssertionError(f"the {name} route failed")
    launches = dict(front_score=launches[0], mid_score=launches[1],
                    tail_score=launches[2],
                    **route_launches)
    return launches, kernel_ms, plain_ms


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    argument list."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name[5:] if name.startswith("void ") else name


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile_chain(label: str, fn, x) -> float:
    """Phase 6 for one chain: ``fn(x)`` twice to warm up, then
    PROFILE_BATCHES times under torch.profiler. Returns the device-busy
    share."""
    for _ in range(WARMUP):
        fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_BATCHES):
            fn(x)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    per_name, intervals = defaultdict(float), []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        per_name[short_name(e.name)] += e.time_range.elapsed_us()
        intervals.append((e.time_range.start, e.time_range.end))
    if not intervals:
        raise RuntimeError(f"{label}: the profiler saw no device activity")
    total = sum(per_name.values())
    print(f"profile: {label}: wall {wall_us / PROFILE_BATCHES / 1e3:.3f} "
          f"ms/batch (profiler on), device busy "
          f"{100 * busy_us(intervals) / wall_us:.1f}%, kernel time "
          f"{total / PROFILE_BATCHES / 1e3:.3f} ms/batch")
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us / PROFILE_BATCHES / 1e3:9.3f} ms/batch  "
              f"{100 * us / total:5.1f}%  {name}")
    return busy_us(intervals) / wall_us


def where_the_time_goes(seed: int) -> None:
    """Phase 6: the serving and scoring chains, kernel and plain, under
    torch.profiler."""
    from semanticsegmentationactivelearning_tpu_torch.inference import (
        make_predict_fn)
    model = score_model(seed, FINAL_SCALE)
    lut = torch.arange(256, dtype=torch.uint8, device="cuda")
    predict = make_predict_fn(model, lut, H, W, 3, torch.device("cuda"))
    rng = np.random.default_rng(seed + 5)
    serve_stack = torch.from_numpy(
        rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)).cuda()
    score_stack = torch.from_numpy(
        rng.integers(0, 256, (SN, SH, SW, 3), dtype=np.uint8)).cuda()

    with torch.inference_mode():
        for label, fn, x in (
                ("serve kernel chain", predict, serve_stack),
                ("serve plain chain",
                 lambda s: plain_predict(model, lut, s), serve_stack),
                ("score kernel chain", scored(model, True), score_stack),
                ("score plain chain", scored(model, False), score_stack)):
            batch = tuple(x.shape[:3])
            profile_chain(f"{label} (batch {batch[0]}, {batch[1]}x"
                          f"{batch[2]})", fn, x)


def scored(model, fused: bool):
    """uint8 stack -> scores through make_score_step (kernel chain with
    ``fused``, else the plain forward)."""
    from semanticsegmentationactivelearning_tpu_torch.train.steps import (
        make_score_step)
    step = make_score_step(model, CLASSES, "entropy", fused=fused)
    return lambda stack: step({"image": stack.float().div_(255.0)})


def head8_scores(model, fused8: torch.Tensor) -> torch.Tensor:
    """The plain head's entropy scores of ``fused8``
    (``icnet_head.head8_entropy_score_plain``), its classifier run as the
    model's ``Classifier`` module, so that :func:`rounded` rounds that
    product's operands (parts ``("Classifier",)``)."""
    from semanticsegmentationactivelearning_tpu_torch.ops import (
        acquisition)
    from semanticsegmentationactivelearning_tpu_torch.ops import nn as xops
    _, h8, w8, _ = fused8.shape
    cls4 = model.Classifier(xops.resize_bilinear(fused8, (2 * h8, 2 * w8)))
    return acquisition.chunked_upsample_mean_confidence(
        cls4, 4, "entropy", model.num_classes)


# nonzero taps of the composed 8x upsample's weights (_HEAD8_W,
# csrc/icnet_head.cu kHead8W) per output phase, averaged over the 8 phases
HEAD8_TAPS = (2 + 2 + 3 + 3 + 3 + 3 + 2 + 2) / 8


def icnet_head_flops(n: int, h8: int, w8: int, c: int) -> float:
    """The head's least work: the classifier at 1/8 resolution; the
    composed 8x upsample as two passes over the nonzero taps, one along
    the columns at 1/8 row resolution, then one along the rows at full
    resolution, a multiply and an add a tap; and the softmax entropy
    (``softmax_flops``)."""
    upsample = 2.0 * HEAD8_TAPS * (1.0 / 8 + 1.0)  # per full-res pixel
    return (2.0 * n * h8 * w8 * 128 * c
            + upsample * n * 64 * h8 * w8 * c
            + softmax_flops(n, 8 * h8, 8 * w8, c))


def peak(name: str) -> float:
    """The peak rate of an ICNet kernel (a KERNELS name) on its route
    (predict where the name ends in "_predict", else score): the fronts'
    and the CFF2 + head kernel's on the tensor cores at the route's
    precision (icnet_front.PRECISION, icnet_head.PRECISION); else fp32
    (the head kernel's bound is :func:`head_roofline`)."""
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        icnet_front, icnet_head)
    route = "predict" if name.endswith("_predict") else "score"
    for prefix, module in (("icnet_front", icnet_front),
                           ("icnet_cff2_head", icnet_head)):
        if name.startswith(prefix):
            return TC_PEAK[module.PRECISION[route]]
    return PEAK_FLOPS


def head_roofline(args, outs, flops: float, n: int, h8: int,
                  w8: int) -> dict:
    """:func:`roofline` of the head kernel on ``n x h8 x w8`` positions:
    its classifier's products on the tensor cores at
    icnet_head.CLASSIFIER_PRECISION, the rest of ``flops`` (the upsample
    and the entropy or the argmax) at the fp32 peak."""
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        icnet_head)
    cls = 2.0 * n * h8 * w8 * 128 * CLASSES
    return roofline(args, outs, cls,
                    TC_PEAK[icnet_head.CLASSIFIER_PRECISION], flops - cls)


def head8_gate(model, fused8, got, want) -> float:
    """The head kernel's scores ``got`` against the plain head's
    ``want``, under PRECISION_GATE with the classifier's operands
    rounded one precision below its own; returns the max |error|."""
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        icnet_head)
    err = (got - want).abs().max().item()
    precision_gate("head8 scores", icnet_head.CLASSIFIER_PRECISION, err,
                   model, lambda m: head8_scores(m, fused8), want,
                   ("Classifier",))
    return err


def cff2_split(model, fused16, f1, fused8, r: dict, score: bool) -> dict:
    """The CFF2 + head kernel's split on the inputs of its check: the GEMM
    alone (fused8 at the route's precision, held to 1e-3 of the plain
    CFF2's maximum and to PRECISION_GATE with CFF2's products rounded),
    the head end (the whole kernel less the GEMM), and the kernel's
    TFLOP/s of least work (``r``'s flops over its ms)."""
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        icnet_head)
    route = "score" if score else "predict"
    precision = icnet_head.PRECISION[route]
    kind = f"fused8_{route}"
    with torch.no_grad():
        f8k = icnet_head.launch_cff2(kind, fused16, f1, model)
        err = (f8k - fused8).abs().max().item()
        bound = 1e-3 * fused8.abs().max().item()
        del f8k
        if not err <= bound:
            raise AssertionError(f"cff2 fused8 ({route}): max err {err} > "
                                 f"{bound}")
        precision_gate(f"cff2 fused8, {route}", precision, err, model,
                       lambda m: m.CFF2(fused16, f1)[0], fused8, ("CFF2",))
        gemm_ms = cuda_ms(
            lambda: icnet_head.launch_cff2(kind, fused16, f1, model))
    out = dict(gemm_ms=gemm_ms, head_end_ms=r["ms"] - gemm_ms,
               tflops=r["flops"] / r["ms"] / 1e9)
    n, h8, w8, _ = fused8.shape
    print(f"cff2 + head {route} split (batch {n}, {8 * h8}x{8 * w8}, "
          f"{precision}): the GEMM alone {gemm_ms:.3f} ms (fused8 max|k-p| "
          f"{err:.3e}, bound {bound:.3e}), the head end "
          f"{out['head_end_ms']:.3f} ms; the kernel {r['ms']:.3f} ms = "
          f"{out['tflops']:.1f} TFLOP/s of least work "
          f"({r['flops'] / 1e9:.2f} GFLOP), bound {r['bound_ms']:.3f} ms "
          f"({r['bound_by']}, {precision})")
    return out


def check_icnet_fronts(model, image, score: bool) -> dict:
    """Both ICNet front entries on one route against their plain
    versions on ``image``: f1 and stem1 to 1e-3 of their maxima and
    under PRECISION_GATE (all six convs rounded), x_half to 1e-5, f1
    bit-equal between the entries; each one's time, the plain version's,
    its bound at the route's peak and TFLOP/s of least work, and the
    front + stem's launches timed alone. Returns {"icnet_front_stem",
    "icnet_front"} with "_predict" after the names on the predict
    route."""
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        icnet_front)
    route = "score" if score else "predict"
    precision = icnet_front.PRECISION[route]
    suffix = "" if score else "_predict"
    n, h, w, _ = image.shape
    res = {}
    with torch.no_grad():
        f1, x_half = icnet_front.icnet_front_plain(image, model)
        stem1 = model.SharedStem.front(x_half)
        want = dict(f1=f1, x_half=x_half, stem1=stem1)
        # what the kernels read besides the image: the pack, not the model
        pack = model.packed("icnet_front", image.device,
                            icnet_front.pack_icnet_front)
        # the downsample: 16 taps x 3 channels a half-res pixel
        down = 32.0 * 3 * n * (h // 2) * (w // 2)
        fronts = (
            ("icnet_front_stem", icnet_front.fused_icnet_front_stem,
             icnet_front.icnet_front_stem_plain, ("f1", "stem1")),
            ("icnet_front", icnet_front.fused_icnet_front,
             icnet_front.icnet_front_plain, ("f1", "x_half")))
        errs, f1s = {}, []
        for name, fused, plain, names in fronts:
            got = fused(image, model, score=score)
            f1s.append(got[0])
            worst = 0.0
            for g, what in zip(got, names):
                err = (g - want[what]).abs().max().item()
                bound = (1e-5 if what == "x_half"
                         else 1e-3 * want[what].abs().max().item())
                print(f"{name} ({route}): {what} max|k-p| {err:.3e} (bound "
                      f"{bound:.3e})")
                if not err <= bound:
                    raise AssertionError(f"{name} {what} ({route}): {err} > "
                                         f"{bound}")
                errs[what] = max(errs.get(what, 0.0), err)
                worst = max(worst, err)
            flops = count_flops(plain, (image, model)) + down
            r = res[name + suffix] = dict(
                max_abs_err=worst,
                ms=cuda_ms(lambda: fused(image, model, score=score)),
                plain_ms=cuda_ms(lambda: plain(image, model)),
                **roofline((image, pack), got, flops, peak(name + suffix)))
            r["tflops"] = flops / r["ms"] / 1e9
            del got
        if not torch.equal(f1s[0], f1s[1]):
            raise AssertionError("the two ICNet front entries' f1 differ")
        del f1s
        for what in ("f1", "stem1"):
            precision_gate(
                f"icnet front {what}, {route}", precision, errs[what], model,
                lambda m: icnet_front.icnet_front_stem_plain(image, m)[
                    what == "stem1"], want[what], icnet_front.TC_CONVS)
        # each launch of the front + stem alone, on its input
        split, x = {}, image
        for part in ("branch1",) + icnet_front.STEM_PARTS:
            src = image if part == "branch1" else x
            split[part] = cuda_ms(lambda: icnet_front.launch_part(
                part, src, model, score, (h, w)))
            if part != "branch1":
                (x,) = icnet_front.launch_part(part, x, model, score, (h, w))
        del x
    r = res["icnet_front_stem" + suffix]
    r["split"] = split
    print(f"icnet front + stem {route} split (batch {n}, {h}x{w}, "
          f"{precision}, {icnet_front.LAUNCHES_PER_CALL} launches): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
          + f"; the front + stem {r['ms']:.3f} ms = {r['tflops']:.1f} TFLOP/s"
          f" of least work ({r['flops'] / 1e9:.2f} GFLOP), bound "
          f"{r['bound_ms']:.3f} ms ({r['bound_by']}); the front "
          f"{res['icnet_front' + suffix]['ms']:.3f} ms = "
          f"{res['icnet_front' + suffix]['tflops']:.1f} TFLOP/s")
    return res


def check_icnet_kernels(seed: int) -> dict:
    """Phase 7a: each ICNet kernel against its plain version on the same
    inputs (the plain chain's activations of one seeded batch): the
    fronts once, the heads at each classifier scale of ICNET_SCALES;
    timed at the first."""
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        icnet_front, icnet_head)
    rng = np.random.default_rng(seed + 6)
    image = torch.from_numpy(rng.integers(0, 256, (IN, IH, IW, 3),
                                          dtype=np.uint8)).cuda()
    image = image.float() / 255.0
    h8, w8 = IH // 8, IW // 8
    res = {}
    for scale in ICNET_SCALES:
        model = score_model(seed, scale, "ICNet")
        with torch.no_grad():
            f1, x_half = icnet_front.icnet_front_plain(image, model)
            stem1 = model.SharedStem.front(x_half)
            if not res:  # the fronts do not read the classifier
                res.update(check_icnet_fronts(model, image, score=True))
            fused16 = model.fuse_to_cff1(stem1)
            fused8 = model.CFF2(fused16, f1)[0]
            wcls, bcls = model.packed("classifier", image.device,
                                      icnet_head.pack_classifier)
            head = icnet_head_flops(IN, h8, w8, CLASSES)
            cases = {
                "icnet_cff2_head_score": (
                    icnet_head.fused_cff2_head8_entropy_score,
                    icnet_head.cff2_head8_entropy_score_plain,
                    (fused16, f1, model), head + cff2_flops(IN, h8, w8)),
                "icnet_head8_score": (
                    icnet_head.fused_head8_entropy_score,
                    icnet_head.head8_entropy_score_plain,
                    (fused8, wcls, bcls, CLASSES), head),
            }
            for name, (fused, plain, args, flops) in cases.items():
                got, want = fused(*args), plain(*args)
                again = fused(*args)
                err = (got - want).abs().max().item()
                print(f"{name} (classifier x{scale:g}): scores "
                      f"{[round(v, 6) for v in got.tolist()]}, max |k-p| "
                      f"{err:.3e}, repeat identical "
                      f"{torch.equal(got, again)}")
                if not err <= SCORE_TOL or not torch.isfinite(got).all():
                    raise AssertionError(f"{name}: scores differ by {err}")
                if not torch.equal(got, again):
                    raise AssertionError(f"{name}: not bit-repeatable")
                r = res.setdefault(name, dict(max_abs_err=0.0))
                r["max_abs_err"] = max(r["max_abs_err"], err)
                if len(r) == 1:  # time at the first scale only
                    r["ms"] = cuda_ms(lambda: fused(*args))
                    r["plain_ms"] = cuda_ms(lambda: plain(*args))
                    if name == "icnet_head8_score":
                        r.update(head_roofline(args, (got,), flops, IN, h8,
                                               w8))
                        head8_gate(model, fused8, got, want)
                    else:
                        r.update(roofline(args, (got,), flops, peak(name)))
                    if name == "icnet_cff2_head_score":
                        # the scores the kernel writes, and its GEMM alone
                        precision_gate(
                            "cff2 + head scores", icnet_head.PRECISION[
                                "score"], err, model,
                            lambda m: icnet_head.cff2_head8_entropy_score_plain(
                                fused16, f1, m), want, ("CFF2",))
                        r.update(cff2_split(model, fused16, f1, fused8, r,
                                            score=True))
        del f1, x_half, stem1, fused16, fused8
    for k in ("icnet_front", "icnet_front_stem", "icnet_cff2_head_score",
              "icnet_head8_score"):
        r = res[k]
        print(f"{k}: kernel {r['ms']:.3f} ms "
              f"({r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s of least work), "
              f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}) (batch {IN}, {IH}x{IW})")
    return res


def score_icnet_pool(seed: int):
    """Phase 7b, ICNet's scoring path: uint8 batches through
    device_prefetch, /255 and make_score_step; then the fuse_cff2=False
    and fuse_stem=False routes of fused_score once each. Returns (launch
    counts, kernel ms/batch, plain ms/batch)."""
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        icnet_front, icnet_head)
    from semanticsegmentationactivelearning_tpu_torch.train.steps import (
        make_score_step)
    model = score_model(seed, ICNET_CLS_SCALE, "ICNet")
    score_step = make_score_step(model, CLASSES, "entropy")
    plain_step = make_score_step(model, CLASSES, "entropy", fused=False)
    rng = np.random.default_rng(seed + 7)
    host = [{"stack": rng.integers(0, 256, (IN, IH, IW, 3), dtype=np.uint8)}
            for _ in range(POOL_BATCHES)]
    wrappers = {"icnet_front_stem": icnet_front.fused_icnet_front_stem,
                "icnet_cff2_head_score":
                    icnet_head.fused_cff2_head8_entropy_score,
                "icnet_front": icnet_front.fused_icnet_front,
                "icnet_head8_score": icnet_head.fused_head8_entropy_score}
    for fn in wrappers.values():
        fn.launches = 0
    stacks = []
    scores, kernel_ms = timed_scores(score_step, prefetched(host, stacks))
    launches = {k: fn.launches for k, fn in wrappers.items()}
    want = dict(
        icnet_front_stem=POOL_BATCHES * icnet_front.LAUNCHES_PER_CALL,
        icnet_cff2_head_score=POOL_BATCHES, icnet_front=0,
        icnet_head8_score=0)
    print(f"icnet score: {len(scores)} batches, launches {launches} "
          f"(expected {want})")
    if launches != want:
        raise AssertionError("the ICNet pool run did not go front+stem -> "
                             "CFF2 + head once per batch")
    plain, plain_ms = timed_scores(plain_step, stacks)
    err = max((k - p).abs().max().item() for k, p in zip(scores, plain))
    print(f"icnet score: kernel chain {kernel_ms:.3f} ms/batch "
          f"({1e3 * IN / kernel_ms:.1f} images/s), plain chain "
          f"{plain_ms:.3f} ms/batch ({1e3 * IN / plain_ms:.1f} images/s) "
          f"(median of {POOL_BATCHES - WARMUP}, batch {IN}, {IH}x{IW}); "
          f"max |k-p| score {err:.3e}; first batch "
          f"{[round(v, 6) for v in scores[0].tolist()]}")
    if scores[0].shape != (IN,) or scores[0].dtype != torch.float32 \
            or not all(torch.isfinite(s).all() for s in scores):
        raise AssertionError(f"scores: {scores[0].shape} {scores[0].dtype}")
    if not err <= SCORE_TOL:
        raise AssertionError("ICNet pool scores disagree with the plain "
                             "chain")

    # the other two routes, one batch each, counted together
    image = stacks[0].float() / 255.0
    for fn in wrappers.values():
        fn.launches = 0
    for kw in (dict(fuse_cff2=False), dict(fuse_stem=False)):
        got = model.fused_score(image, "entropy", **kw)
        torch.cuda.synchronize()
        err = (got - plain[0]).abs().max().item()
        print(f"icnet score: fused_score({kw}) max |k-p| {err:.3e}")
        if not err <= SCORE_TOL:
            raise AssertionError(f"the ICNet route {kw} failed")
    routes = {k: fn.launches for k, fn in wrappers.items()}
    want = dict(icnet_front_stem=icnet_front.LAUNCHES_PER_CALL,
                icnet_cff2_head_score=0, icnet_front=1, icnet_head8_score=2)
    print(f"icnet score: the two routes launched {routes} (expected {want})")
    if routes != want:
        raise AssertionError("the ICNet routes did not launch their kernels")
    launches.update(icnet_front=routes["icnet_front"],
                    icnet_head8_score=routes["icnet_head8_score"])
    return launches, kernel_ms, plain_ms


def profile_icnet(seed: int) -> None:
    """Phase 7c: ICNet's scoring chain, kernel and plain, as phase 6."""
    model = score_model(seed, ICNET_CLS_SCALE, "ICNet")
    rng = np.random.default_rng(seed + 8)
    stack = torch.from_numpy(
        rng.integers(0, 256, (IN, IH, IW, 3), dtype=np.uint8)).cuda()
    with torch.inference_mode():
        for label, fused in (("icnet score kernel chain", True),
                             ("icnet score plain chain", False)):
            profile_chain(f"{label} (batch {IN}, {IH}x{IW})",
                          scored(model, fused), stack)


def icnet_head_predict_flops(n: int, h8: int, w8: int, c: int) -> float:
    """As :func:`icnet_head_flops`, ending in an argmax (one compare a
    pixel and class) in place of the entropy."""
    return (icnet_head_flops(n, h8, w8, c)
            - softmax_flops(n, 8 * h8, 8 * w8, c)
            + 1.0 * n * 64 * h8 * w8 * c)


def cff2_flops(n: int, h8: int, w8: int) -> float:
    """CFF2's work at 1/8 resolution: the dilated 3x3 and the 1x1 conv,
    and the separable 2x upsample of fused16 (3 taps a position)."""
    return 2.0 * n * h8 * w8 * (9 * 128 + 64 + 3) * 128


def check_icnet_predict_kernels(seed: int) -> dict:
    """Phase 8a: each ICNet predict kernel against its plain version on
    the same inputs (the plain chain's fused16 and fused8 of one seeded
    batch), at each classifier scale of ICNET_PREDICT_SCALES; timed at
    the first."""
    from semanticsegmentationactivelearning_tpu_torch.ops import nn as xops
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        icnet_front, icnet_head)
    rng = np.random.default_rng(seed + 9)
    image = torch.from_numpy(rng.integers(0, 256, (N, H, W, 3),
                                          dtype=np.uint8)).cuda()
    image = image.float() / 255.0
    h8, w8 = H // 8, W // 8
    head = icnet_head_predict_flops(N, h8, w8, CLASSES)
    res = {}
    for scale in ICNET_PREDICT_SCALES:
        model = score_model(seed, scale, "ICNet")
        if not res:  # the fronts do not read the classifier
            res.update(check_icnet_fronts(model, image, score=False))
        with torch.no_grad():
            f1, x_half = icnet_front.icnet_front_plain(image, model)
            fused16 = model.fuse_to_cff1(model.SharedStem.front(x_half))
            fused8 = model.CFF2(fused16, f1)[0]
            wcls, bcls = model.packed("classifier", image.device,
                                      icnet_head.pack_classifier)
            logits = xops.resize_bilinear(model.head_pre_logits(fused8),
                                          (H, W))
            want, decided = decided_labels(logits, 1e-3)
            del logits
            frac = decided.float().mean().item()
            cases = {
                "icnet_cff2_head_predict": (
                    icnet_head.fused_cff2_head8_predict,
                    icnet_head.cff2_head8_predict_plain,
                    (fused16, f1, model), head + cff2_flops(N, h8, w8)),
                "icnet_head8_predict": (
                    icnet_head.fused_head8_predict,
                    lambda f8, wc, bc, c: icnet_head.head8_predict_plain(
                        f8, wc, bc),
                    (fused8, wcls, bcls, CLASSES), head),
            }
            for name, (fused, plain, args, flops) in cases.items():
                got = fused(*args)
                diff = (got.long() - want).abs()[decided]
                bad = int((diff != 0).sum().item())
                print(f"{name} (classifier x{scale:g}): {bad} decided labels "
                      f"differ ({frac:.5f} of pixels decided at margin 1e-3)")
                if bad or frac < 0.99 or got.shape != (N, H, W):
                    raise AssertionError(f"{name} labels disagree with the "
                                         "plain ones")
                r = res.setdefault(name, dict(max_abs_err=0.0))
                r["max_abs_err"] = max(r["max_abs_err"],
                                       float(diff.max().item()))
                if len(r) == 1:  # time at the first scale only
                    r["ms"] = cuda_ms(lambda: fused(*args))
                    r["plain_ms"] = cuda_ms(lambda: plain(*args))
                    if name == "icnet_head8_predict":
                        r.update(head_roofline(args, (got,), flops, N, h8,
                                               w8))
                    else:
                        r.update(roofline(args, (got,), flops, peak(name)))
                    if name == "icnet_cff2_head_predict":
                        # the labels of the plain version with CFF2's
                        # products in TF32, one precision below the route
                        lower = rounded(
                            model, round_tf32,
                            lambda m: icnet_head.cff2_head8_predict_plain(
                                fused16, f1, m), ("CFF2",))
                        moved = int(((lower.long() != want)
                                     & decided).sum().item())
                        print(f"{name}: the plain version in TF32 moves "
                              f"{moved} decided labels, the kernel {bad}")
                        del lower
                        r.update(cff2_split(model, fused16, f1, fused8, r,
                                            score=False))
            if scale == ICNET_CLS_SCALE:
                # the score twins on the same inputs: their cost at batch 2
                cff2_ms = cuda_ms(
                    lambda: icnet_head.fused_cff2_head8_entropy_score(
                        fused16, f1, model))
                head_ms = cuda_ms(
                    lambda: icnet_head.fused_head8_entropy_score(
                        fused8, wcls, bcls, CLASSES))
                print(f"score twins at batch {N}: CFF2 + head {cff2_ms:.3f} "
                      f"ms, head {head_ms:.3f} ms")
                # the head kernel's scores at batch 2, under its gate
                err = head8_gate(
                    model, fused8, icnet_head.fused_head8_entropy_score(
                        fused8, wcls, bcls, CLASSES),
                    icnet_head.head8_entropy_score_plain(fused8, wcls, bcls,
                                                         CLASSES))
                if not err <= SCORE_TOL:
                    raise AssertionError(f"head8 scores differ by {err}")
        del f1, x_half, fused16, fused8, want, decided
    for k, r in res.items():
        print(f"{k}: kernel {r['ms']:.3f} ms "
              f"({r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s of least work), "
              f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}) (batch {N}, {H}x{W})")
    return res


def icnet_plain_predict(model, lut, stack):
    """ICNet's serving chain through the plain versions of its kernels."""
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        icnet_front, icnet_head)
    with torch.inference_mode():
        image = stack.float().div_(255.0)
        f1, stem1 = icnet_front.icnet_front_stem_plain(image, model)
        labels = icnet_head.cff2_head8_predict_plain(
            model.fuse_to_cff1(stem1), f1, model)
        return lut[labels.long()]


def served_disagreement(model, stack, out) -> tuple:
    """(decided pixels whose label differs from the plain forward's, the
    decided count, the decided share) of the maps ``out`` of ``stack``."""
    with torch.inference_mode():
        logits = model(stack.float() / 255.0)
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits")
    want, decided = decided_labels(logits, 1e-3)
    bad = int(((out.long() != want) & decided).sum().item())
    count = int(decided.sum().item())
    return bad, count, count / decided.numel()


def serve_icnet(seed: int):
    """Phase 8b, ICNet's serving path: make_predict_fn over uint8
    batches fed by device_prefetch; then one batch each through the
    fuse_cff2=False and fuse_stem=False routes. Returns (the predict
    kernels' and the fronts' launch counts on this route, kernel
    ms/batch, plain ms/batch, the model)."""
    from semanticsegmentationactivelearning_tpu_torch.inference import (
        make_predict_fn)
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        icnet_front, icnet_head)
    model = score_model(seed, ICNET_CLS_SCALE, "ICNet")
    lut = torch.arange(256, dtype=torch.uint8, device="cuda")
    predict = make_predict_fn(model, lut, H, W, 3, torch.device("cuda"))
    rng = np.random.default_rng(seed + 10)
    host = [{"stack": rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)}
            for _ in range(BATCHES)]
    wrappers = {"icnet_front_stem": icnet_front.fused_icnet_front_stem,
                "icnet_cff2_head_predict": icnet_head.fused_cff2_head8_predict,
                "icnet_front": icnet_front.fused_icnet_front,
                "icnet_head8_predict": icnet_head.fused_head8_predict}
    for fn in wrappers.values():
        fn.launches = 0
    stacks, outs, times = [], [], []
    for stack in prefetched(host, stacks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs.append(predict(stack))
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    want = dict(icnet_front_stem=BATCHES * icnet_front.LAUNCHES_PER_CALL,
                icnet_cff2_head_predict=BATCHES, icnet_front=0,
                icnet_head8_predict=0)
    print(f"icnet serve: {len(outs)} batches, launches {launches} "
          f"(expected {want})")
    if launches != want:
        raise AssertionError("the ICNet serving run did not go front+stem "
                             "-> CFF2 + head predict once per batch")
    kernel_ms = float(np.median([s.elapsed_time(e)
                                 for s, e in times[WARMUP:]]))
    ptimes = []
    for stack in stacks:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        icnet_plain_predict(model, lut, stack)
        end.record()
        ptimes.append((start, end))
    torch.cuda.synchronize()
    plain_ms = float(np.median([s.elapsed_time(e)
                                for s, e in ptimes[WARMUP:]]))
    out = outs[0]
    if out.shape != (N, H, W) or out.dtype != torch.uint8:
        raise AssertionError(f"served maps: {out.shape} {out.dtype}")
    bad, count, frac = served_disagreement(model, stacks[0], out)
    print(f"icnet serve: kernel chain {kernel_ms:.3f} ms/batch "
          f"({1e3 * N / kernel_ms:.1f} images/s), plain chain "
          f"{plain_ms:.3f} ms/batch ({1e3 * N / plain_ms:.1f} images/s) "
          f"(median of {BATCHES - WARMUP}, batch {N}, {H}x{W}); {bad} "
          f"decided pixels differ from the plain forward ({frac:.5f} "
          f"decided)")
    # as in phase 4: the chains feed each stage slightly different fp32
    # inputs, so a near-tied max-pool window may move a value
    if bad > 1e-4 * count or frac < 0.99:
        raise AssertionError("served ICNet maps disagree with the plain "
                             "forward")

    # the other two routes, one batch each, counted together
    image = stacks[0].float() / 255.0
    for fn in wrappers.values():
        fn.launches = 0
    for kw in (dict(fuse_cff2=False), dict(fuse_stem=False)):
        labels = model.fused_predict(image, **kw)
        torch.cuda.synchronize()
        bad, count, _ = served_disagreement(model, stacks[0], labels)
        print(f"icnet serve: fused_predict({kw}): {bad} decided pixels "
              f"differ from the plain forward")
        if bad > 1e-4 * count:
            raise AssertionError(f"the ICNet serving route {kw} failed")
    routes = {k: fn.launches for k, fn in wrappers.items()}
    want = dict(icnet_front_stem=icnet_front.LAUNCHES_PER_CALL,
                icnet_cff2_head_predict=0, icnet_front=1,
                icnet_head8_predict=2)
    print(f"icnet serve: the two routes launched {routes} (expected {want})")
    if routes != want:
        raise AssertionError("the ICNet serving routes did not launch their "
                             "kernels")
    return (dict(icnet_cff2_head_predict=launches["icnet_cff2_head_predict"],
                 icnet_head8_predict=routes["icnet_head8_predict"],
                 icnet_front_stem_predict=launches["icnet_front_stem"],
                 icnet_front_predict=routes["icnet_front"]),
            kernel_ms, plain_ms, model)


def profile_icnet_serving(model) -> None:
    """Phase 8d: ICNet's serving chain, kernel and plain, as phase 6."""
    from semanticsegmentationactivelearning_tpu_torch.inference import (
        make_predict_fn)
    lut = torch.arange(256, dtype=torch.uint8, device="cuda")
    predict = make_predict_fn(model, lut, H, W, 3, torch.device("cuda"))
    stack = torch.from_numpy(np.random.default_rng(11).integers(
        0, 256, (N, H, W, 3), dtype=np.uint8)).cuda()
    with torch.inference_mode():
        for label, fn in (("icnet serve kernel chain", predict),
                          ("icnet serve plain chain",
                           lambda s: icnet_plain_predict(model, lut, s))):
            profile_chain(f"{label} (batch {N}, {H}x{W})", fn, stack)


def rig_check(name: str, got, want, scale, tol: float) -> float:
    """|got - want| <= tol * scale elementwise; returns the largest
    |got - want|."""
    err = (got - want).abs()
    worst = (err / scale).max().item()
    print(f"{name}: max |k-p| {err.max().item():.3e}, at most "
          f"{worst:.2e} of the magnitudes summed (tolerance {tol:g})")
    if not worst <= tol:
        raise AssertionError(f"{name}: the kernel disagrees with its plain "
                             "version")
    return err.max().item()


def run_rigs(seed: int):
    """Phase 9: each rig run once through its script at its default
    size (the counters zeroed before), then each rig kernel against its
    plain version on the scripts' inputs. Returns (per-kernel results,
    launch counts)."""
    from semanticsegmentationactivelearning_tpu_torch.tools import (
        probe_front_packing, probe_launch_overhead, probe_matmul_floor, rigs)
    rigs.probe_launch.launches = rigs.probe_matmul.launches = 0
    launch = probe_launch_overhead.main(["--seed", str(seed)])
    floor = probe_matmul_floor.main(["--seed", str(seed)])
    packing = probe_front_packing.main(["--seed", str(seed)])
    launches = dict(probe_launch=rigs.probe_launch.launches,
                    probe_matmul=rigs.probe_matmul.launches)
    print(f"rigs: launches {launches}")

    # the launch rig (its script's defaults)
    y, sw, m1, consts = rigs.launch_inputs(16, 128, 256, 41, seed, "cuda")
    got = rigs.probe_launch(y, sw, m1, consts, 16)
    want = rigs.probe_launch_plain(y, sw, m1, consts, 16)
    scale = rigs.probe_launch_plain(y.abs(), sw.abs(), m1.abs(),
                                    [c.abs() for c in consts], 16)
    err = max(rig_check(f"probe_launch {what}", g, w, s, RIG_TOL["fp32"])
              for what, g, w, s in zip(("centre", "reads"), got, want, scale))
    nbytes = sum(t.numel() * 4 for t in (y, sw, m1, *consts, *got))
    res = {"probe_launch": dict(
        max_abs_err=err, ms=launch["41 consts"]["ms"],
        plain_ms=cuda_ms(lambda: rigs.probe_launch_plain(y, sw, m1, consts,
                                                         16)),
        bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes")}
    del y, sw, m1, consts, got, want, scale

    # the matmul-stream rig: the two scripts' cases at their defaults
    cases = [(d, mode, 1536, 128, 123, mode) for d in ("bf16", "fp32")
             for mode in ("indep", "chain", "prelu")]
    cases += [(d, "base", 512, 128, 108, "chain") for d in ("bf16", "fp32")]
    cases += [(d, "nside", 4096, 16, 12, "nside") for d in ("bf16", "fp32")]
    errs, plain_ms = [], {}
    for dname, label, rows, n_cols, m, mode in cases:
        a, w = rigs.matmul_inputs(64, rows, n_cols, rigs.dtype_named(dname),
                                  seed, "cuda")
        got = rigs.probe_matmul(a, w, m, mode)
        final = rigs.matmul_final_plain(a, w, m, mode)
        errs.append(rig_check(f"probe_matmul {dname} {label}", got,
                              final.sum(dim=1), final.abs().sum(dim=1),
                              RIG_TOL[dname]))
        plain_ms[dname, label] = cuda_ms(
            lambda: rigs.probe_matmul_plain(a, w, m, mode))
        print(f"probe_matmul {dname} {label}: plain version "
              f"{plain_ms[dname, label]:.4f} ms")
        if (dname, label) == ("bf16", "chain"):  # the entry's numbers
            bound_ms = 1e3 * rigs.matmul_flops(a, w, m) / PEAK_BF16
        del a, w, got, final
    res["probe_matmul"] = dict(
        max_abs_err=max(errs), ms=floor["bf16 chain"]["ms"],
        plain_ms=plain_ms["bf16", "chain"], bound_ms=bound_ms,
        bound_by="operations")
    for k, r in floor.items():
        print(f"rig floor {k}: {r['ms']:.4f} ms, {r['tflops']:.1f} TFLOP/s")
    for k, r in packing.items():
        print(f"rig packing {k}: {r}")
    return res, launches


BLOCK_CLASSES = 5   # the classes present in phase 10's images


def block_stack(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """uint8 ``[n, h, w, 4]``: an image whose 8x8 grid of blocks each
    have their class's colour (with noise) and the label plane with the
    classes (0 to BLOCK_CLASSES - 1 of the model's 19, as the JAX CLI
    test's records) and an ignored (255) top band."""
    rng = np.random.default_rng(seed)
    colors = rng.integers(0, 256, (BLOCK_CLASSES, 3))
    idx = rng.integers(0, BLOCK_CLASSES, (n, 8, 8))
    label = np.kron(idx, np.ones((1, h // 8, w // 8), np.int64))
    image = np.clip(colors[label] + rng.integers(-20, 20, (n, h, w, 3)),
                    0, 255)
    label[:, :h // 64] = 255
    return np.concatenate([image, label[..., None]], -1).astype(np.uint8)


def set_precision(precision: str) -> None:
    """"default": torch's defaults (cuDNN convs in TF32, matmuls in fp32),
    what the train CLI runs; "fp32": TF32 off, as phases 1-9 run."""
    torch.backends.cudnn.allow_tf32 = precision == "default"
    torch.backends.cuda.matmul.allow_tf32 = False


def train_setup(conf: str, device, check: bool, seed: int,
                classes: int = CLASSES, in_channels: int = 3):
    """(state, train_step, hyperparams) for the conf's model on
    ``device``, built as the train CLI builds it, with the seeded weights
    (ENet: glorot from the seed's generator; ICNet: seeded_state_dict's,
    BN means N(0, 0.1), the classifier x1); ``check``: SGD and dropout
    rates 0 (phases 10a, 11a, 13a), else the conf's optimizer and rates.
    ``classes`` and ``in_channels``: the model's (ENet-19 of RGB unless
    given)."""
    from semanticsegmentationactivelearning_tpu_torch.models import (
        conf_model_kwargs, get_model)
    from semanticsegmentationactivelearning_tpu_torch.train import (
        config, optim, steps)
    params = config.load_params(conf)
    name = params["network"]["model"]
    hp = copy.deepcopy(params["hyperparams"])
    if check:
        hp["optimizer"] = {"type": "SGD"}
        hp["dropout_rates"] = [0.0] * 5
    model = get_model(name, classes, in_channels=in_channels,
                      **conf_model_kwargs(name, hp))
    if name == "ICNet":
        model.load_state_dict(seeded_state_dict(model, seed, 1.0, name))
    model = model.to(device)
    opt, sched = optim.make_optimizer(model.parameters(), hp)
    state = steps.create_train_state(model, opt, sched,
                                     seed=None if name == "ICNet" else seed)
    return state, steps.make_train_step(model, classes, hp), hp


def fixed_batch(stack: np.ndarray, device, dtype=torch.float32) -> dict:
    """The train batch of ``stack`` through augment_batch's core with
    fixed draws (no crop offset, the second image flipped, scale 1.1),
    its floats in ``dtype``, with the undistorted crop ``image_raw``."""
    from semanticsegmentationactivelearning_tpu_torch.data import pipeline
    n = stack.shape[0]
    draws = (torch.zeros(n, dtype=torch.long), torch.zeros(n, dtype=torch.long),
             torch.arange(n) % 2 == 1, torch.full((n, 1, 1, 3), 1.1))
    raw, image, label, mask = pipeline.crop_flip_scale(
        torch.from_numpy(stack).to(device), *[d.to(device) for d in draws],
        crop_hw=stack.shape[1:3])
    return {"image": image.to(dtype), "label": label, "mask": mask.to(dtype),
            "valid": torch.ones(n, device=device, dtype=dtype),
            "image_raw": raw.to(dtype)}


def train_errors(got, want, out, ref) -> dict:
    """Phase 10a's errors of the card's step (``got``, metrics ``out``)
    against a CPU step (``want``, ``ref``), in float64."""
    loss = abs(out["loss"].item() - ref["loss"].item()) / abs(
        ref["loss"].item())
    grads = {}
    for (k, p), q in zip(got.model.named_parameters(),
                         want.model.parameters()):
        g, r = p.grad.cpu().double(), q.grad.double()
        grads[k] = ((g - r).norm() / r.norm()).item()
    worst = max(grads, key=grads.get)
    sd, ref_sd = got.model.state_dict(), want.model.state_dict()
    stats = max(((sd[k].cpu().double() - ref_sd[k].double()).abs().max()
                 / ref_sd[k].double().abs().max()).item()
                for k in ref_sd if "running" in k)
    return {"loss": loss, "grad": grads[worst], "grad_tensor": worst,
            "grad_median": float(np.median(list(grads.values()))),
            "stats": stats}


def recorded_switches(fn):
    """``fn()`` with the switches of every 2x2 pool of ENet
    (``ops.nn.max_pool_with_switches``: B1_0's, B2_0's) that a forward
    under autograd takes (a train step's; not the pseudo targets' eval
    forward) recorded in call order: (its result, the switches on the
    CPU)."""
    from semanticsegmentationactivelearning_tpu_torch.ops import nn as xops
    real, record = xops.max_pool_with_switches, []

    def spy(x):
        out = real(x)
        if torch.is_grad_enabled():
            record.append(out[1].detach().cpu())
        return out

    xops.max_pool_with_switches = spy
    try:
        return fn(), record
    finally:
        xops.max_pool_with_switches = real


def forced_switches(fn, switches):
    """``fn()`` with each 2x2 pool taking ``switches`` (in call order,
    as :func:`recorded_switches` gives them) instead of its own maxima:
    the pooled value is the one at the given position, and the gradient
    goes there (pools under autograd only, as recorded). Returns (its
    result, [(windows whose given switch is not the pool's own choice,
    the largest such window's top-two margin over the largest magnitude
    of its image and channel)] a call)."""
    from semanticsegmentationactivelearning_tpu_torch.ops import nn as xops
    real, given, flips = xops.max_pool_with_switches, iter(switches), []

    def forced(x):
        if not torch.is_grad_enabled():
            return real(x)
        win = xops._to_windows(x)                       # [N, h, w, 4, C]
        n, h2, w2, _, c = win.shape
        sw = next(given).to(x.device)
        idx = sw.reshape(n, h2, w2, 1, c).long()
        pooled = win.gather(3, idx).squeeze(3)
        with torch.no_grad():
            differ = win.argmax(dim=3) != idx.squeeze(3)
            scale = win.abs().amax(dim=(1, 2, 3), keepdim=True).squeeze(3)
            margin = (win.amax(dim=3) - pooled) / scale.clamp_min(1e-30)
            flips.append((int(differ.sum()),
                          float(margin[differ].max()) if differ.any()
                          else 0.0))
        return pooled, sw

    xops.max_pool_with_switches = forced
    try:
        return fn(), flips
    finally:
        xops.max_pool_with_switches = real


def check_flips(flips, what: str) -> str:
    """Fail unless every window where the card's fp32 switch is not the
    float64 step's own choice is tied within TIE_TOL; the report."""
    count = sum(n for n, _ in flips)
    worst = max((m for _, m in flips), default=0.0)
    report = (f"{count} windows took the card's switch against float64's "
              f"own choice, top-two margin at most {worst:.3e} of the "
              f"plane's largest magnitude (tie tolerance {TIE_TOL:.0e})")
    if worst > TIE_TOL:
        raise AssertionError(f"{what}: the card's fp32 step took another "
                             f"switch than float64 at a decided window: "
                             f"{report}")
    return report


def check_train_step(seed: int, confs=TRAIN_CONFS, hw=(TH, TW),
                     phase: str = "10a") -> dict:
    """Phase 10a (13a: ``confs`` ICNet's, at ``hw``): one train step at
    batch TN on the card against the CPU's, in fp32 and in float64 (the
    CPU's own fp32 gradients sit a median ~1e-3 from its float64 ones,
    PERF.md §2; the float64 step shows the card's error alone); the
    float64 step takes the 2x2 pool switches of the card's fp32 step
    (:func:`forced_switches`; the windows where they are not its own
    choice must be tied, :func:`check_flips`), and the BN statistics are
    gated against it (STATS_REF)."""
    stack = block_stack(TN, *hw, seed + 20)
    errors = {}
    for name, conf in confs.items():
        cards = {}
        for precision in ("default", "fp32"):
            set_precision(precision)
            state, step, _ = train_setup(conf, DEV, True, seed)
            out, switches = recorded_switches(
                lambda: step(state, fixed_batch(stack, DEV)))
            torch.cuda.synchronize()
            if not np.isfinite(out["loss"].item()):
                raise AssertionError(f"{name}: the loss is not finite")
            cards[precision] = (state, out, switches)
        set_precision("fp32")
        refs = {}
        for ref_name, dtype in (("fp32", torch.float32),
                                ("fp64", torch.float64)):
            ref_state, step, _ = train_setup(conf, "cpu", True, seed)
            ref_state.model.to(dtype)
            t0 = time.perf_counter()
            batch = fixed_batch(stack, "cpu", dtype)
            if dtype == torch.float64:
                ref, flips = forced_switches(lambda: step(ref_state, batch),
                                             cards["fp32"][2])
                print(f"train {phase} ({name}): the CPU's float64 step on "
                      f"the card's fp32 switches: "
                      + check_flips(flips, f"train {phase} ({name})"))
            else:
                ref = step(ref_state, batch)
            refs[ref_name] = (ref_state, ref, time.perf_counter() - t0)
        cpu = train_errors(refs["fp32"][0], refs["fp64"][0], refs["fp32"][1],
                           refs["fp64"][1])
        print(f"train {phase} ({name}): the CPU's fp32 step against its "
              f"float64 step: loss rel err {cpu['loss']:.3e}; gradients: "
              f"largest rel L2 {cpu['grad']:.3e} ({cpu['grad_tensor']}), "
              f"median {cpu['grad_median']:.3e}; BN statistics "
              f"{cpu['stats']:.3e}")
        for precision, (state, out, _) in cards.items():
            for ref_name, (ref_state, ref, secs) in refs.items():
                err = train_errors(state, ref_state, out, ref)
                errors[(name, precision, ref_name)] = err
                bounds = TRAIN_BOUNDS[name][precision]
                gated = [k for k in bounds
                         if k != "stats" or ref_name == STATS_REF]
                print(f"train {phase} ({name}, {hw[0]}x{hw[1]}, card "
                      f"{precision} against the CPU {ref_name}, {secs:.1f} "
                      f"s): loss {ref['loss']:.6f} "
                      f"rel err {err['loss']:.3e} (bound "
                      f"{bounds['loss']:.1e}); gradients: largest rel L2 "
                      f"{err['grad']:.3e} ({err['grad_tensor']}), median "
                      f"{err['grad_median']:.3e} (bound "
                      f"{bounds['grad']:.1e}); BN statistics "
                      f"{err['stats']:.3e} (bound {bounds['stats']:.1e}"
                      f"{'' if 'stats' in gated else ', not gated'})")
                if any(err[k] > bounds[k] for k in gated):
                    raise AssertionError(
                        f"train step on the card ({name}, {precision}) "
                        f"disagrees with the CPU's in {ref_name}")
        del refs, cards
    set_precision("fp32")
    return errors


def train_speed(seed: int, confs=TRAIN_CONFS, hw=(TH, TW),
                stack_hw=(2 * TH, 2 * TW), learn=("pretrain",),
                learn_steps: int = LEARN_STEPS, phase: str = "10b") -> dict:
    """Phase 10b (13b: ``confs`` ICNet's, crops ``hw`` of ``stack_hw``
    records): ms/step and images/s at batch 8, then the learning check on
    one fixed batch: after ``learn_steps`` the loss of each conf in
    ``learn`` must be under half its first value."""
    from semanticsegmentationactivelearning_tpu_torch.data import pipeline
    set_precision("default")
    stack = torch.from_numpy(block_stack(TB, *stack_hw, seed + 21)).to(DEV)
    heights = torch.full((TB,), stack_hw[0], device=DEV)
    widths = torch.full((TB,), stack_hw[1], device=DEV)
    out = {}
    for name, conf in confs.items():
        state, step, hp = train_setup(conf, DEV, False, seed)
        times = []
        for i in range(TRAIN_WARMUP + TRAIN_TIMED):
            gen = torch.Generator(DEV).manual_seed(seed + i)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _, image, label, mask = pipeline.augment_batch(
                stack, heights, widths, gen, hw)
            step(state, {"image": image, "label": label, "mask": mask,
                         "valid": torch.ones(TB, device=DEV)}, gen)
            end.record()
            times.append((start, end))
        torch.cuda.synchronize()
        ms = float(np.median([s.elapsed_time(e)
                              for s, e in times[TRAIN_WARMUP:]]))
        # the learning check starts from the seeded weights again
        state, step, hp = train_setup(conf, DEV, False, seed)
        batch = {"image": image, "label": label, "mask": mask,
                 "valid": torch.ones(TB, device=DEV)}
        losses = [step(state, batch,
                       torch.Generator(DEV).manual_seed(100 + i))["loss"]
                  for i in range(learn_steps)]
        losses = [v.item() for v in losses]
        out[name] = {"ms": ms, "images_per_s": 1000.0 * TB / ms,
                     "losses": losses}
        print(f"train {phase} ({name}: {hp['optimizer']['type']}, "
              f"multiscale {hp['softmax']['multiscale']}, log-inverse "
              f"{hp['softmax']['loginverse_scaling']}): {ms:.3f} ms/step, "
              f"{1000.0 * TB / ms:.1f} images/s (batch {TB}, "
              f"{hw[0]}x{hw[1]}, median of {TRAIN_TIMED}); loss on one "
              f"batch over {learn_steps} steps {losses[0]:.4f} -> "
              f"{losses[-1]:.4f} ({losses[-1] / losses[0]:.3f} of the "
              f"first)")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{name}: the train loss is not finite")
        if name in learn and not losses[-1] < 0.5 * losses[0]:
            raise AssertionError(f"the {name} conf's step does not learn "
                                 f"one batch in {learn_steps} steps")
        del state, step
    set_precision("fp32")
    return out


def profile_training(seed: int, confs=TRAIN_CONFS, hw=(TH, TW),
                     stack_hw=(2 * TH, 2 * TW)) -> dict:
    """Phase 10c (13c: ``confs`` ICNet's): 5 train steps of each conf
    under torch.profiler. Returns each conf's device-busy share."""
    from semanticsegmentationactivelearning_tpu_torch.data import pipeline
    set_precision("default")
    stack = torch.from_numpy(block_stack(TB, *stack_hw, seed + 22)).to(DEV)
    sizes = torch.full((TB,), stack_hw[0], device=DEV), \
        torch.full((TB,), stack_hw[1], device=DEV)
    valid = torch.ones(TB, device=DEV)
    busy = {}
    for name, conf in confs.items():
        state, step, _ = train_setup(conf, DEV, False, seed)
        gen = torch.Generator(DEV).manual_seed(seed)

        def one(s):
            _, image, label, mask = pipeline.augment_batch(s, *sizes, gen,
                                                           hw)
            step(state, {"image": image, "label": label, "mask": mask,
                         "valid": valid}, gen)

        busy[name] = profile_chain(
            f"train step {name} (batch {TB}, {hw[0]}x{hw[1]})", one, stack)
        del state, step
    set_precision("fp32")
    return busy


# writes colour-block records (as block_stack's, one 8x8 grid of blocks
# an image, drawn in order from one generator) and encodes their PNGs in
# 8 forked processes: python -c RECORD_WRITER root seed h w split=n ...
RECORD_WRITER = (
    "import sys, io, os, multiprocessing, numpy as np\n"
    "from PIL import Image\n"
    "from semanticsegmentationactivelearning_tpu_torch.data import "
    "example, tfrecord\n"
    "root, seed, h, w = sys.argv[1], *map(int, sys.argv[2:5])\n"
    "rng = np.random.default_rng(seed)\n"
    f"colors = rng.integers(0, 256, ({BLOCK_CLASSES}, 3))\n"
    "def png(a):\n"
    "    b = io.BytesIO(); Image.fromarray(a).save(b, format='PNG')\n"
    "    return b.getvalue()\n"
    "def write(k):\n"
    "    path, name, lbl, img = items[k]\n"
    "    ex = example.SegExample(file_id=name, height=lbl.shape[0], "
    "width=lbl.shape[1], label=png(lbl), "
    "modalities={'image': (png(img), 'png', 3)})\n"
    "    tfrecord.write_record_file(path, example.make_example(ex))\n"
    "items = []\n"
    "for split, n in (a.split('=') for a in sys.argv[5:]):\n"
    "    os.makedirs(f'{root}/{split}')\n"
    "    for i in range(int(n)):\n"
    f"        idx = rng.integers(0, {BLOCK_CLASSES}, (8, 8))\n"
    "        lbl = np.kron(idx, np.ones((h // 8, w // 8), np.int64))\n"
    "        img = np.clip(colors[lbl] + rng.integers(-20, 20, "
    "lbl.shape + (3,)), 0, 255).astype(np.uint8)\n"
    "        items.append((f'{root}/{split}/{i}.tfrecord', f'{split}{i}', "
    "lbl.astype(np.uint8), img))\n"
    "with multiprocessing.get_context('fork').Pool(8) as pool:\n"
    "    pool.map(write, range(len(items)))\n" + LEAK_CHECK)


def write_records(root: str, seed: int, h: int, w: int, **splits) -> None:
    """Colour-block records of ``h`` x ``w`` under ``root/<split>/``, as
    many as ``splits`` says, written by RECORD_WRITER in a child process.
    The child forks its encoders, so it runs with one BLAS thread: it
    has no thread when it forks."""
    env = dict(os.environ, OPENBLAS_NUM_THREADS="1", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    subprocess.run([sys.executable, "-c", RECORD_WRITER, root, str(seed),
                    str(h), str(w), *(f"{k}={n}" for k, n in splits.items())],
                   check=True, env=env)


def start_child(module: str, *argv, after: str = "", before: str = "",
                env=None):
    """Start ``python -m module argv`` in a child process that runs
    ``before``, the module, then ``after`` once the module is done, then
    checks that it imported no JAX; its output goes to temporary files;
    ``env``: its environment (default this process's). Returns a handle
    for :func:`wait_child`."""
    script = ("import runpy, sys\n" + before
              + f"sys.argv[0] = {module.rsplit('.', 1)[-1]!r}\n"
              "try:\n"
              f"    runpy.run_module({module!r}, run_name='__main__')\n"
              "except SystemExit as e:\n"
              "    if e.code:\n"
              "        raise\n" + after)
    return start_script(module, script, *argv, env=env)


def start_script(name: str, script: str, *argv, env=None):
    """Start ``python -c script argv`` (then the JAX check) in a child
    process, as :func:`start_child` does; ``name`` names it in errors."""
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-c", script + LEAK_CHECK,
                             *argv], stdout=out, stderr=err, text=True,
                            env=env)
    return name, proc, out, err, time.perf_counter()


def wait_child(handle):
    """Wait for a child of :func:`start_child`. Returns (a finished
    ``CompletedProcess``, its seconds); fails on an error."""
    module, proc, out, err, t0 = handle
    code = proc.wait()
    secs = time.perf_counter() - t0
    texts = []
    for f in (out, err):
        f.seek(0)
        texts.append(f.read())
        f.close()
    if code != 0:
        raise AssertionError(f"{module} failed:\n" + texts[0]
                             + texts[1][-4000:])
    return subprocess.CompletedProcess(proc.args, code, *texts), secs


# appended to an inference child: the serving kernels' launch counts in
# SERVE_COUNTED's order
SERVE_COUNTED = ("front", "mid", "tail", "icnet_front_stem_predict",
                 "icnet_cff2_head_predict")
SERVE_COUNTS = (
    "from semanticsegmentationactivelearning_tpu_torch.ops.kernels import "
    "front, mid, tail, icnet_front, icnet_head\n"
    "print('serve-kernel-launches:', front.fused_front_stage1.launches, "
    "mid.fused_mid_stage23.launches, tail.fused_tail_predict.launches, "
    "icnet_front.fused_icnet_front_stem.launches, "
    "icnet_head.fused_cff2_head8_predict.launches)\n")


def run_child(module: str, *argv, after: str = "", before: str = ""):
    """:func:`start_child`, then :func:`wait_child`."""
    return wait_child(start_child(module, *argv, after=after, before=before))


def run_train_cli(seed: int, conf_path: str = TRAIN_CONFS["pretrain"],
                  hw=(TH, TW), phase: str = "10d") -> dict:
    """Phase 10d (13d: ICNet's conf, ``hw`` records): the train CLI (2
    epochs, then a resume for a third) on 16 + 4 records of the conf's
    input size and the inference CLI on its checkpoint (``-m`` the
    conf's model), each in a child process that checks it imported no
    JAX; the inference child prints the serving kernels' launches.
    Returns them by kernel."""
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        front, icnet_front, mid, tail)
    port = "semanticsegmentationactivelearning_tpu_torch"
    with tempfile.TemporaryDirectory() as tmp:
        rec, log = os.path.join(tmp, "rec"), os.path.join(tmp, "log")
        write_records(rec, seed, *hw, train=16, val=4)
        with open(conf_path) as fp:
            conf = json.load(fp)
        model = conf["network"]["model"]
        for epochs in (2, 3):
            conf["epochs"] = epochs
            path = os.path.join(tmp, f"conf{epochs}.json")
            with open(path, "w") as fp:
                json.dump(conf, fp)
            res, secs = run_child(f"{port}.train", "cityscapes", "-d",
                                  rec, "-l", log, "-p", path, "--seed",
                                  str(seed))
            print(f"train cli {phase} ({model}, {epochs} epochs): "
                  f"{secs:.1f} s")
            if epochs == 3 and "at epoch 3..." not in res.stdout:
                raise AssertionError("the resumed run did not start at "
                                     "epoch 3:\n" + res.stderr[-4000:])
        with open(os.path.join(log, "metrics.jsonl")) as fp:
            records = [json.loads(line) for line in fp]
        splits = [r["split"] for r in records]
        want = (["train_iter"] * 2 + ["train", "val"]) * 2 + ["final_val"]
        want += ["train_iter"] * 2 + ["train", "val", "final_val"]
        bad = [r["split"] for r in records
               if set(r) != TRAIN_RECORD_KEYS[r["split"]]]
        resumed = [(r["epoch"], r["step"]) for r in records[9:]
                   if r["split"] == "train_iter"]
        train = [r["loss"] for r in records if r["split"] == "train"]
        files = sorted(f for f in os.listdir(log) if f.endswith(".ckpt"))
        print(f"train cli {phase}: records {splits}; resumed steps "
              f"{resumed}; train loss by epoch {train}; checkpoints {files}")
        if splits != want or bad or resumed != [(3, 5), (3, 6)] \
                or files != ["model-1.ckpt", "model-2.ckpt", "model-3.ckpt"]:
            raise AssertionError("the train CLI's records or checkpoints "
                                 f"are not as expected: {bad}")
        if not train[1] < train[0]:
            raise AssertionError("epoch 2's training loss is not under "
                                 "epoch 1's")
        out = os.path.join(tmp, "out")
        res, secs = run_child(f"{port}.inference", "-c", log, "-d",
                              os.path.join(rec, "val"), "-o", out, "-t",
                              "cityscapes", "-m", model, "-b", "2",
                              after=SERVE_COUNTS)
        pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        shape = np.asarray(PIL.Image.open(os.path.join(out, pngs[0]))).shape
        launches = dict(zip(SERVE_COUNTED, map(int, [
            ln for ln in res.stdout.splitlines()
            if ln.startswith("serve-kernel-launches:")][-1].split()[1:])))
        # 4 records at batch 2: 2 batches, each once through the chain
        want = ({"front": 2 * front.LAUNCHES_PER_CALL,
                 "mid": 2 * mid.LAUNCHES_PER_CALL,
                 "tail": 2 * tail.LAUNCHES_PER_CALL} if model == "ENet" else
                {"icnet_front_stem_predict": 2 * icnet_front.LAUNCHES_PER_CALL,
                 "icnet_cff2_head_predict": 2})
        print(f"inference cli {phase} on the trained {model} checkpoint: "
              f"{len(pngs)} PNGs of {shape} in {secs:.1f} s; launches "
              f"{launches}")
        if len(pngs) != 4 or shape != tuple(hw) \
                or f"Model: {model}" not in res.stderr \
                or "(kernel chain)" not in res.stderr \
                or any(launches[k] != v for k, v in want.items()) \
                or sum(launches.values()) != sum(want.values()):
            raise AssertionError("the inference CLI did not serve the "
                                 "trained checkpoint through the kernels")
        return {k: launches[k] for k in want}


# phase 11: the active-learning loop (ENet-19, the AL conf's 512x1024
# input and batch 8, on 1024x2048 colour-block records)
AL_CONF = TRAIN_CONFS["al"]
AL_POOL, AL_REPEAT, AL_PASSES = 32, 8, 3  # 11b: records, their listings
#                                           in the timed pool, timed passes
# 11a: a pixel's pseudo target is decided where its confidence sits at
# least this far from the threshold and its top-2 logit margin exceeds it;
# at most AL_FLIPS of the decided pixels may differ, phase 4's allowance
# for whole-chain labels (a 2x2 pool window whose top two values nearly
# tie takes another switch on the card, and its unpooled pixels move by
# more than the margin: 2 of 1.05 M decided labels at seed 1 on an H100)
AL_DECIDED, AL_FLIPS = 1e-3, 1e-4
# the keys of each metrics.jsonl record of the AL CLI (the JAX CLI's)
AL_RECORD_KEYS = {
    "al_train_iter": {"split", "step", "round", "loss", "cost",
                      "learning_rate", "wall_time"},
    "al_train": {"split", "round", "epoch", "loss", "val_mean_iou",
                 "labelled", "no_improvement", "confusion", "wall_time"},
    "al_test": {"split", "round", "labelled", "mean_iou", "pixel_accuracy",
                "class_iou", "confusion", "wall_time"},
    "al_confidence": {"split", "round", "histogram", "bin_edges", "mean",
                      "wall_time"},
    "al_timing": {"split", "round", "labelled", "round_s", "train_s",
                  "restore_s", "test_s", "score_select_s", "wall_time"}}


def pseudo_batch(stack: np.ndarray, device, dtype=torch.float32) -> dict:
    """fixed_batch with the first row labelled and the second not."""
    batch = fixed_batch(stack, device, dtype)
    batch["labelled"] = torch.tensor([True, False], device=device)
    return batch


def median_confidence(model, image: torch.Tensor) -> float:
    """The median entropy confidence of ``model`` on ``image``."""
    from semanticsegmentationactivelearning_tpu_torch.ops import acquisition
    with torch.no_grad():
        return float(acquisition.confidence_map(
            model(image), "entropy", CLASSES).median())


def check_pseudo_step(seed: int) -> dict:
    """Phase 11a: the pseudo-labelling step's targets on the card
    against the CPU's on decided pixels (the smoke's seeded weights,
    Final x25), then one pseudo step on the card (SGD, dropout 0, TF32
    off) against the CPU's in fp32 and float64 (on the card's pool
    switches, as 10a's) on the targets the card's step used; each at the
    unlabelled row's median confidence on the CPU, so that half its
    pixels take a pseudo label."""
    from semanticsegmentationactivelearning_tpu_torch.models import (
        get_model)
    from semanticsegmentationactivelearning_tpu_torch.ops import acquisition
    from semanticsegmentationactivelearning_tpu_torch.train import steps
    set_precision("fp32")
    stack = block_stack(TN, TH, TW, seed + 30)
    model = get_model("ENet", CLASSES)
    model.load_state_dict(seeded_state_dict(model, seed))
    card = copy.deepcopy(model).to(DEV)
    cpu_batch = pseudo_batch(stack, "cpu")
    threshold = median_confidence(model, cpu_batch["image_raw"][1:])
    cfg = {"measure": "entropy", "threshold": threshold}
    want = steps.pseudo_targets(model, cpu_batch, cfg, CLASSES)
    got = [t.cpu() for t in steps.pseudo_targets(
        card, pseudo_batch(stack, DEV), cfg, CLASSES)]
    with torch.no_grad():
        logits = model(cpu_batch["image_raw"])
    conf = acquisition.confidence_map(logits, "entropy", CLASSES)
    top2 = logits.topk(2, dim=-1).values
    decided = ((conf - threshold).abs() >= AL_DECIDED) \
        & (top2[..., 0] - top2[..., 1] > AL_DECIDED)
    decided[0] = True                  # the labelled row keeps its targets
    differ = [int(((g != w) & decided).sum()) for g, w in zip(got, want)]
    pseudo = want[1][1]
    print(f"al 11a: pseudo targets (entropy at the median confidence "
          f"{threshold:.6f}): {int(pseudo.sum())} of {pseudo.numel()} "
          f"unlabelled pixels pseudo-labelled; {int((~decided[1]).sum())} "
          f"undecided; differing on decided pixels: labels {differ[0]}, "
          f"masks {differ[1]}; everywhere: labels "
          f"{int((got[0] != want[0]).sum())}, masks "
          f"{int((got[1] != want[1]).sum())}")
    if max(differ) > AL_FLIPS * int(decided.sum()) \
            or int(decided[1].sum()) < pseudo.numel() // 2:
        raise AssertionError("the card's pseudo targets disagree with the "
                             "CPU's (or fewer than half are decided)")
    del card

    state, _, hp = train_setup(AL_CONF, DEV, True, seed)
    median = median_confidence(train_setup(AL_CONF, "cpu", True, seed)[0]
                               .model, cpu_batch["image_raw"][1:])
    cfg = {"measure": "entropy", "threshold": median}
    batch = pseudo_batch(stack, DEV)
    before = steps.pseudo_targets(state.model, batch, cfg, CLASSES)
    # the targets the card's step computes and uses, for the CPU's steps
    real, used = steps.pseudo_targets, []
    steps.pseudo_targets = lambda *a: used.append(real(*a)) or used[-1]
    try:
        out, switches = recorded_switches(
            lambda: steps.make_train_step(state.model, CLASSES, hp,
                                          pseudo_cfg=cfg)(state, batch))
    finally:
        steps.pseudo_targets = real
    torch.cuda.synchronize()
    targets = used[0]
    print(f"al 11a: the step's targets against the same call just before "
          f"it: {int((targets[0] != before[0]).sum())} labels and "
          f"{int((targets[1] != before[1]).sum())} mask pixels differ")
    bounds = TRAIN_BOUNDS["al"]["fp32"]
    errors, failed = {}, []
    for ref_name, dtype in (("fp32", torch.float32),
                            ("fp64", torch.float64)):
        gated = [k for k in bounds if k != "loss" or ref_name == AL_LOSS_REF]
        ref_state, _, _ = train_setup(AL_CONF, "cpu", True, seed)
        ref_state.model.to(dtype)
        steps.pseudo_targets = lambda *a: (targets[0].cpu(),  # noqa: E731
                                           targets[1].cpu().to(dtype))
        ref_step = steps.make_train_step(ref_state.model, CLASSES, hp,
                                         pseudo_cfg=cfg)
        ref_batch = pseudo_batch(stack, "cpu", dtype)
        try:
            if dtype == torch.float64:
                ref, flips = forced_switches(
                    lambda: ref_step(ref_state, ref_batch), switches)
                print("al 11a: the CPU's float64 pseudo step on the card's "
                      "fp32 switches: " + check_flips(flips, "al 11a"))
            else:
                ref = ref_step(ref_state, ref_batch)
        finally:
            steps.pseudo_targets = real
        err = train_errors(state, ref_state, out, ref)
        err["ref_loss"] = ref["loss"].item()
        errors[ref_name] = err
        print(f"al 11a: pseudo step (threshold {median:.6g}, "
              f"{int(targets[1][1].sum())} pseudo pixels) on the card "
              f"against the CPU {ref_name}: loss {ref['loss']:.6f} rel err "
              f"{err['loss']:.3e} (bound {bounds['loss']:.1e}"
              f"{'' if 'loss' in gated else ', not gated'}); gradients: "
              f"largest rel L2 {err['grad']:.3e} ({err['grad_tensor']}), "
              f"median {err['grad_median']:.3e} (bound "
              f"{bounds['grad']:.1e}); BN statistics {err['stats']:.3e} "
              f"(bound {bounds['stats']:.1e})")
        if any(err[k] > bounds[k] for k in gated):
            failed.append(ref_name)
    cpu = [errors[k]["ref_loss"] for k in ("fp32", "fp64")]
    print(f"al 11a: the CPU's fp32 loss against its float64 loss: rel err "
          f"{abs(cpu[0] - cpu[1]) / abs(cpu[1]):.3e}")
    if failed:
        # the supervised step on the same batch, for comparison
        state, step, _ = train_setup(AL_CONF, DEV, True, seed)
        out = step(state, batch)
        ref_state, step, _ = train_setup(AL_CONF, "cpu", True, seed)
        ref_state.model.double()
        ref = step(ref_state, pseudo_batch(stack, "cpu", torch.float64))
        err = train_errors(state, ref_state, out, ref)
        print(f"al 11a: the supervised step on this batch against the CPU "
              f"fp64: loss rel err {err['loss']:.3e}, gradients "
              f"{err['grad']:.3e}, BN statistics {err['stats']:.3e}")
        raise AssertionError(f"the pseudo step on the card disagrees with "
                             f"the CPU's in {failed}")
    return errors


def al_pool_pass(seed: int, files, score_ms: float):
    """Phase 11b: the AL CLI's pool pass (``active_learning.score_pool``,
    then ``select_lowest``) over ``files`` in this process, with the
    kernel score step and with the plain one; the launch counters are
    zeroed before the kernel pass. Then the pass over the files listed
    AL_REPEAT times, timed on the host's clock with decode, H2D and the
    selection. Returns (launches by kernel, images/s)."""
    from semanticsegmentationactivelearning_tpu_torch import (
        active_learning as al)
    from semanticsegmentationactivelearning_tpu_torch.data import loader
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        deconv_score, decoder, front, mid, tail)
    from semanticsegmentationactivelearning_tpu_torch.train.steps import (
        make_score_step)
    model = score_model(seed, FINAL_SCALE)
    in_hw, key = (SH, SW), (seed + 13, 0)

    def scores(step, names):
        plan = al.rank_plan(loader.RecordLoader(names, SN, min_hw=in_hw),
                            SN, in_hw)
        return al.score_pool(step, plan, len(names), key, in_hw, 3, DEV,
                             "al 11b")

    wrappers = (front.fused_front_stage1, mid.fused_mid_stage23,
                tail.fused_tail_entropy_score, tail.fused_tail_predict,
                decoder.fused_decoder_entropy_score,
                deconv_score.fused_deconv_entropy_score)
    for fn in wrappers:
        fn.launches = 0
    kernel_step = make_score_step(model, CLASSES, "entropy")
    got = scores(kernel_step, files)
    launches = [fn.launches for fn in wrappers]
    batches = -(-len(files) // SN)
    want = [front.LAUNCHES_PER_CALL * batches,
            mid.LAUNCHES_PER_CALL * batches,
            tail.LAUNCHES_PER_CALL * batches, 0, 0, 0]
    plain = scores(make_score_step(model, CLASSES, "entropy", fused=False),
                   files)
    err = float(np.abs(got - plain).max())
    unlabelled = np.arange(SN, len(files))
    picks = [set(al.select_lowest(c, unlabelled, SN)[0].tolist())
             for c in (got, plain)]
    cut = np.sort(plain[unlabelled])[SN - 1]
    moved = sorted(picks[0] ^ picks[1])
    print(f"al 11b: pool of {len(files)} records ({batches} batches): "
          f"launches front/mid/tail score/tail predict/decoder/deconv "
          f"{launches} (expected {want}); max |k-p| score {err:.3e}; "
          f"selected {sorted(picks[0])}, the plain chain's differ at "
          f"{moved} (cut {cut:.6f})")
    if launches != want:
        raise AssertionError("the pool pass did not go front -> mid -> "
                             "tail score once a batch")
    if not (err <= SCORE_TOL and np.isfinite(got).all()
            and all(abs(plain[i] - cut) <= SCORE_TOL for i in moved)):
        raise AssertionError("the pool pass's scores or selection disagree "
                             "with the plain chain's")
    names = list(files) * AL_REPEAT
    times = []
    for _ in range(1 + AL_PASSES):
        t0 = time.perf_counter()
        c = scores(kernel_step, names)
        al.select_lowest(c, np.arange(len(c)), SN)
        times.append(time.perf_counter() - t0)
    secs = float(np.median(times[1:]))
    ips = len(names) / secs
    print(f"al 11b: pool pass with decode, H2D and selection: "
          f"{len(names)} entries in {secs:.3f} s, {ips:.1f} images/s "
          f"(median of {AL_PASSES} after 1: "
          f"{[round(t, 3) for t in times]}); device only (phase 5b) "
          f"{1e3 * SN / score_ms:.1f} images/s")
    return dict(zip(("front_score", "mid_score", "tail_score"),
                    launches[:3])), ips


def run_al_cli(seed: int, rec: str) -> dict:
    """Phase 11c: the AL CLI in child processes on ``rec`` with the AL
    conf cut to short rounds: two rounds, then side by side a resume to
    a third, a random baseline round and ``-c <the first round's best>
    -r``; each child prints the score kernels' launches. Returns each
    run's al_timing records."""
    port = "semanticsegmentationactivelearning_tpu_torch"
    counts = (
        "from semanticsegmentationactivelearning_tpu_torch.ops.kernels "
        "import front, mid, tail\n"
        "print('al-kernel-launches:', front.fused_front_stage1.launches, "
        "mid.fused_mid_stage23.launches, "
        "tail.fused_tail_entropy_score.launches)\n")
    with open(AL_CONF) as fp:
        conf = json.load(fp)
    conf["epochs"] = 1
    # the rounds end on the first epoch without a validation gain (as
    # the JAX CLI's test bounds them)
    conf["hyperparams"]["learning_rate"] = 1e-7
    conf["active_learning"].update({
        "iterations": 2, "epochs/warm_up": 0, "num_validation": 4,
        "num_initially_labelled": 8, "selection_size": 8})
    pool = AL_POOL
    batches = -(-pool // SN)
    per_pass = [5 * batches, 21 * batches, 2 * batches]
    timings = {}
    with tempfile.TemporaryDirectory() as tmp:
        def start(name, log, extra=(), **al_over):
            c = copy.deepcopy(conf)
            c["active_learning"].update(al_over)
            path = os.path.join(tmp, f"{name}.json")
            with open(path, "w") as fp:
                json.dump(c, fp)
            return name, log, start_child(
                f"{port}.active_learning", "cityscapes", "-d", rec, "-l",
                log, "-p", path, "--seed", str(seed), *extra, after=counts)

        def finish(started):
            name, log, handle = started
            res, secs = wait_child(handle)
            line = [ln for ln in res.stdout.splitlines()
                    if ln.startswith("al-kernel-launches:")][-1]
            launches = [int(v) for v in line.split()[1:]]
            with open(os.path.join(log, "metrics.jsonl")) as fp:
                records = [json.loads(ln) for ln in fp]
            with open(os.path.join(log, "state.json")) as fp:
                state = json.load(fp)
            timing = [r for r in records if r["split"] == "al_timing"]
            timings[name] = timing
            lab = state["dataset"]["train"]["labelled"]
            unlab = state["dataset"]["train"]["unlabelled"]
            bad = [r["split"] for r in records
                   if set(r) != AL_RECORD_KEYS[r["split"]]]
            print(f"al 11c ({name}): {secs:.1f} s; iteration "
                  f"{state['iteration']}, {len(lab)} labelled, launches "
                  f"front/mid/tail score {launches}; al_timing "
                  + "; ".join(f"round {t['round']}: "
                              + ", ".join(f"{k} {t[k]}" for k in
                                          ("train_s", "restore_s", "test_s",
                                           "score_select_s", "round_s"))
                              for t in timing))
            if bad or not set(lab).isdisjoint(unlab) \
                    or len(set(lab)) != len(lab) \
                    or sorted(lab + unlab) != list(range(pool)):
                raise AssertionError(f"AL CLI ({name}): records {bad} or "
                                     "the labelled sets are not as expected")
            return res, state, records, launches

        # the two rounds alone (their al_timing is the round's split),
        # then the other three runs side by side
        log = os.path.join(tmp, "log")
        _, state, records, launches = finish(start("two_rounds", log))
        splits = {r["split"] for r in records}
        if state["iteration"] != 2 or len(state["dataset"]["train"][
                "labelled"]) != min(24, pool) \
                or splits != set(AL_RECORD_KEYS) \
                or launches != [2 * n for n in per_pass] \
                or not all(os.path.exists(os.path.join(log, d,
                                                       "checkpoint.json"))
                           for d in ("pretrain", "iter-1")):
            raise AssertionError("AL CLI: two rounds not as expected")
        runs = [start("resume", log, iterations=3),
                start("baseline", os.path.join(tmp, "baseline"),
                      iterations=1, selection_size=-8),
                start("reinitialize", os.path.join(tmp, "reinit"),
                      ("-c", os.path.join(log, "pretrain"), "-r"),
                      iterations=1)]
        res, state, _, launches = finish(runs[0])
        if state["iteration"] != 3 or launches != per_pass \
                or len(state["dataset"]["train"]["labelled"]) \
                != min(32, pool) \
                or "Resuming from checkpoint" not in res.stdout:
            raise AssertionError("AL CLI: the resume not as expected")
        _, state, records, launches = finish(runs[1])
        if launches != [0, 0, 0] or state["iteration"] != 1 \
                or len(state["dataset"]["train"]["labelled"]) \
                != min(16, pool) \
                or "al_confidence" in {r["split"] for r in records}:
            raise AssertionError("AL CLI: the baseline round scored the "
                                 "pool or selected wrongly")
        res, state, _, launches = finish(runs[2])
        if state["iteration"] != 1 or launches != per_pass \
                or "drawn anew" not in res.stdout:
            raise AssertionError("AL CLI: -c -r not as expected")
    return timings


# phase 12: secondary acquisition (ENet-19 at the BALD conf's shape: batch
# 8, 512x1024 crops, mc_passes 8; core-set at Cityscapes' pool size)
SECONDARY_CONFS = {
    "bald": "conf/enet_cityscapes_active_learning_bald.json",
    "coreset": "conf/enet_cityscapes_active_learning_coreset.json"}
MC_PASSES = 8   # the BALD conf's mc_passes
MC_CPU = 2      # 12a: the CPU step scores the first MC_CPU images alone
# 12a's bounds on |card - CPU| per image score, by the card's precision
# ("fp32": TF32 off; "default": cuDNN convs in TF32, what the CLI runs).
# Read at seed 0 (PERF.md, §6): 6.0e-8 and 6.6e-7. The bound is phase
# 5's per-image score bound, twice that in TF32: a 2x2 pool window whose
# top two values nearly tie may take another switch on the card than on
# the CPU (ROADMAP Queue 3), and its unpooled pixels move an image's mean
# by up to ~5e-5. Masks drawn from another key must move some score by
# more than the fp32 bound, so that the gate sees a wrong mask.
MC_TOL = {"fp32": SCORE_TOL, "default": 2 * SCORE_TOL}
# 12b: Cityscapes' 2975 training images, ENet's 128-wide embedding, a
# round's 50 picks from 50 labelled centers
KC_N, KC_D, KC_K, KC_CENTERS = 2975, 128, 50, 50
AL_SECONDARY_KEYS = {
    "al_coreset": {"split", "round", "selected", "min_dist_mean",
                   "min_dist_max", "wall_time"},
    **AL_RECORD_KEYS}


def mc_images(seed: int):
    """12a's uint8 batch (SN x SH x SW), its pool indices and key."""
    rng = np.random.default_rng(seed + 60)
    stack = rng.integers(0, 256, (SN, SH, SW, 3), dtype=np.uint8)
    return torch.from_numpy(stack), np.arange(100, 100 + SN), (seed + 11, 0)


def check_mc_step(seed: int) -> dict:
    """Phase 12a: the MC-dropout BALD step on the card against the
    port's CPU step on the same weights, images, indices and key (the
    masks are ``ops.nn.MCDropout``'s integer hash, the same bits on both
    devices), at both precisions; the CPU scores the first MC_CPU images
    alone, which the step's per-image masks allow. Returns the errors."""
    from semanticsegmentationactivelearning_tpu_torch.train.steps import (
        make_mc_score_step)
    model = score_model(seed, FINAL_SCALE)
    stack, index, key = mc_images(seed)
    image = stack.float() / 255.0
    t0 = time.perf_counter()
    want = make_mc_score_step(copy.deepcopy(model).cpu(), CLASSES,
                              MC_PASSES)({"image": image[:MC_CPU]}, key,
                                         index[:MC_CPU])
    cpu_s = time.perf_counter() - t0
    errs = {}
    for precision in ("fp32", "default"):
        set_precision(precision)
        got = make_mc_score_step(model, CLASSES, MC_PASSES)(
            {"image": image.cuda()}, key, torch.as_tensor(index).cuda())
        got = got.cpu()
        errs[precision] = float((got[:MC_CPU] - want).abs().max())
        print(f"mc 12a ({precision}): scores {got.numpy().round(6)}; the "
              f"CPU's {want.numpy().round(6)} ({cpu_s:.1f} s); max |card "
              f"- CPU| {errs[precision]:.3e} (bound {MC_TOL[precision]})")
        if got.shape != (SN,) or not torch.isfinite(got).all() \
                or not ((got > 0) & (got <= 1)).all() \
                or errs[precision] > MC_TOL[precision]:
            set_precision("fp32")
            raise AssertionError(f"the card's MC step ({precision}) "
                                 "disagrees with the CPU's")
    set_precision("fp32")
    other = make_mc_score_step(model, CLASSES, MC_PASSES)(
        {"image": image[:MC_CPU].cuda()}, (seed + 12, 0),
        torch.as_tensor(index[:MC_CPU]).cuda()).cpu()
    moved = float((other - want).abs().max())
    print(f"mc 12a: masks of another key move the scores by {moved:.3e}")
    # the passes disagree (the score is not the clip's constant 1), and
    # the gate would see masks drawn from another key
    if not (want < 1 - 1e-4).all() or moved <= MC_TOL["fp32"]:
        raise AssertionError("12a: the MC passes agree everywhere, or "
                             "another key's masks hide under the bound")
    return errs


def device_ips(fn, stacks) -> float:
    """Images/s of ``fn(stack)`` over uint8 ``stacks`` on the card: the
    median of CUDA-event times after WARMUP."""
    times = []
    for stack in stacks:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(stack)
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    ms = float(np.median([s.elapsed_time(e) for s, e in times[WARMUP:]]))
    return 1e3 * stacks[0].shape[0] / ms


def mask_draw_ms(model, index: torch.Tensor) -> dict:
    """12a: the MC masks of one stacked forward (MC_PASSES x SN rows),
    drawn as ``ops.nn.MCDropout`` draws them, a call a dropout block,
    and in one go over all of the forward's slots (then sliced): ms,
    median of REPS after one, CUDA events."""
    from semanticsegmentationactivelearning_tpu_torch.ops.nn import (
        MCDropout)
    widths = [m.exp_bn.weight.numel() for m in model.modules()
              if getattr(m, "drop_rate", 0.0) > 0.0]

    def a_call_a_block():
        masks = MCDropout((0, 0), index, range(MC_PASSES))
        for c in widths:
            masks.uniform(masks.offset, c)
            masks.offset += c

    def one_go():
        MCDropout((0, 0), index, range(MC_PASSES)).uniform(0, sum(widths))

    out = {}
    for label, fn in (("a call a block", a_call_a_block),
                      ("one go", one_go)):
        ms = []
        for _ in range(1 + REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        out[label] = float(np.median(ms[1:]))
    print(f"mc 12a: a forward's masks ({len(widths)} dropout blocks, "
          f"{sum(widths)} slots x {MC_PASSES * SN} rows): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in out.items()))
    return out


def mc_speed(seed: int) -> dict:
    """Phase 12a's timing: the MC pool pass on the card (uint8 stacks,
    /255, the MC step: MC_PASSES x SN images a forward) and the embed
    pass (12b) in images/s; the masks' draw; then the MC pass under
    torch.profiler (device-busy share)."""
    from semanticsegmentationactivelearning_tpu_torch.train.steps import (
        make_embed_step, make_mc_score_step)
    model = score_model(seed, FINAL_SCALE)
    rng = np.random.default_rng(seed + 61)
    stacks = [torch.from_numpy(rng.integers(0, 256, (SN, SH, SW, 3),
                                            dtype=np.uint8)).cuda()
              for _ in range(POOL_BATCHES)]
    index = torch.arange(SN, device="cuda")
    out = {}
    with torch.inference_mode():
        step = make_mc_score_step(model, CLASSES, MC_PASSES)

        def mc(s):
            return step({"image": s.float().div_(255.0)}, (seed + 11, 0),
                        index)

        out["mc"] = device_ips(mc, stacks)
        embed = make_embed_step(model)
        out["embed"] = device_ips(
            lambda s: embed({"image": s.float().div_(255.0)}), stacks)
        out["masks"] = mask_draw_ms(model, index)
        out["busy"] = profile_chain(f"bald MC pool pass (batch {SN}, "
                                    f"{SH}x{SW}, {MC_PASSES} passes "
                                    f"stacked)", mc, stacks[0])
    print(f"mc 12a: MC pool pass {out['mc']:.1f} images/s on the device; "
          f"embed pass {out['embed']:.1f} images/s")
    return out


def kcenter_oracle(emb: np.ndarray, centers: np.ndarray,
                   candidates: np.ndarray, k: int) -> list:
    """Greedy k-center in numpy (float64, exact differences)."""
    e = emb.astype(np.float64)
    dist = np.full(len(e), np.inf)
    for c in np.flatnonzero(centers):
        dist = np.minimum(dist, ((e - e[c]) ** 2).sum(axis=1))
    dist[~candidates] = -np.inf
    picks = []
    for _ in range(k):
        j = int(np.argmax(dist))
        picks.append(j)
        dist = np.minimum(dist, ((e - e[j]) ** 2).sum(axis=1))
        dist[j] = -np.inf
    return picks


def check_kcenter(seed: int) -> float:
    """Phase 12b: ``ops.selection.k_center_greedy`` on the card at
    Cityscapes' pool size against the numpy oracle (the picks equal);
    its time (median of REPS, CUDA events). Returns ms."""
    from semanticsegmentationactivelearning_tpu_torch.ops.selection import (
        k_center_greedy)
    rng = np.random.default_rng(seed + 70)
    emb = rng.normal(size=(KC_N, KC_D)).astype(np.float32)
    centers = np.zeros(KC_N, dtype=bool)
    centers[rng.choice(KC_N, KC_CENTERS, replace=False)] = True
    want = kcenter_oracle(emb, centers, ~centers, KC_K)
    args = (torch.from_numpy(emb).cuda(), torch.from_numpy(centers).cuda(),
            torch.from_numpy(~centers).cuda(), KC_K)
    picks, dist = k_center_greedy(*args)
    got = picks.cpu().tolist()
    ms = []
    for _ in range(1 + REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        k_center_greedy(*args)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    ms = float(np.median(ms[1:]))
    print(f"kcenter 12b: N {KC_N}, D {KC_D}, k {KC_K}, {KC_CENTERS} "
          f"centers: {ms:.3f} ms (median of {REPS}); picks "
          f"{'equal' if got == want else 'DIFFER'} to the numpy oracle's "
          f"(first {got[:5]})")
    if got != want or picks.device.type != "cuda" \
            or not torch.isneginf(dist[args[1]]).all():
        raise AssertionError("k_center_greedy on the card disagrees with "
                             "the numpy oracle")
    return ms


def run_secondary_cli(seed: int, rec: str, smi_name: str) -> dict:
    """Phase 12c: the AL CLI in two child processes side by side, one
    round each with the BALD conf and the core-set conf cut as 11c cuts
    the AL conf; state.json, the records (al_confidence for BALD,
    al_coreset for core-set, al_timing), the log lines, no entropy score
    kernel launched, and the card's memory in use. Returns each run's
    al_timing record."""
    port = "semanticsegmentationactivelearning_tpu_torch"
    after = (
        "from semanticsegmentationactivelearning_tpu_torch.ops.kernels "
        "import front, mid, tail\n"
        "import torch\n"
        "print('al-kernel-launches:', front.fused_front_stage1.launches, "
        "mid.fused_mid_stage23.launches, "
        "tail.fused_tail_entropy_score.launches)\n"
        "print('al-cuda-bytes:', torch.cuda.max_memory_allocated())\n")
    logs = {"bald": f"BALD acquisition: {MC_PASSES} MC-dropout passes",
            "coreset": "Core-set (k-center greedy) selection enabled"}
    timings = {}
    with tempfile.TemporaryDirectory() as tmp:
        started = {}
        for name, path in SECONDARY_CONFS.items():
            with open(path) as fp:
                conf = json.load(fp)
            conf["epochs"] = 1
            conf["hyperparams"]["learning_rate"] = 1e-7
            conf["active_learning"].update({
                "iterations": 1, "epochs/warm_up": 0, "num_validation": 4,
                "num_initially_labelled": 8, "selection_size": 8})
            cpath = os.path.join(tmp, f"{name}.json")
            with open(cpath, "w") as fp:
                json.dump(conf, fp)
            log = os.path.join(tmp, name)
            started[name] = log, start_child(
                f"{port}.active_learning", "cityscapes", "-d", rec, "-l",
                log, "-p", cpath, "--seed", str(seed), after=after)
        for name, (log, handle) in started.items():
            res, secs = wait_child(handle)
            lines = res.stdout.splitlines()
            launches = [int(v) for v in [ln for ln in lines if ln.startswith(
                "al-kernel-launches:")][-1].split()[1:]]
            cuda_bytes = int([ln for ln in lines if ln.startswith(
                "al-cuda-bytes:")][-1].split()[1])
            with open(os.path.join(log, "metrics.jsonl")) as fp:
                records = [json.loads(ln) for ln in fp]
            with open(os.path.join(log, "state.json")) as fp:
                state = json.load(fp)
            lab = state["dataset"]["train"]["labelled"]
            unlab = state["dataset"]["train"]["unlabelled"]
            splits = [r["split"] for r in records]
            timing = [r for r in records if r["split"] == "al_timing"]
            timings[name] = timing
            core = [r for r in records if r["split"] == "al_coreset"]
            print(f"al 12c ({name}): {secs:.1f} s; iteration "
                  f"{state['iteration']}, {len(lab)} labelled; records "
                  f"{sorted(set(splits))}; al_coreset {core}; entropy "
                  f"kernels launched {launches}; card memory peak "
                  f"{cuda_bytes / 2 ** 30:.2f} GiB; al_timing "
                  + ", ".join(f"{k} {timing[0][k]}" for k in (
                      "train_s", "restore_s", "test_s", "score_select_s",
                      "round_s")))
            want_split = "al_confidence" if name == "bald" else "al_coreset"
            other = "al_coreset" if name == "bald" else "al_confidence"
            if (state["iteration"] != 1 or len(lab) != 16
                    or len(set(lab)) != 16 or not set(lab).isdisjoint(unlab)
                    or sorted(lab + unlab) != list(range(AL_POOL))
                    or splits.count(want_split) != 1 or other in splits
                    or len(timing) != 1
                    or any(set(r) != AL_SECONDARY_KEYS[r["split"]]
                           for r in records)
                    or (core and core[0]["selected"] != 8)
                    or logs[name] not in res.stdout
                    or f"Running on {smi_name}" not in res.stdout
                    or launches != [0, 0, 0] or cuda_bytes <= 0):
                raise AssertionError(f"AL CLI ({name}): not as expected")
    return timings


# phase 13: ICNet's training (ICNet-19, conf/icnet_cityscapes.json:
# Momentum, the cascade loss over three heads, L2, batch 8 at 1024x2048)
ICNET_CONF = "conf/icnet_cityscapes.json"
# 13a's input: the conf's; the CPU's float64 step took 12.2 s there on
# the H100's machine (4.3 s in fp32)
ICNET_CHECK_HW = (IH, IW)
ICNET_LEARN_STEPS = 40   # 13b: the CPU halved the loss in 28 at 128x256


def run_icnet_al_cli(seed: int, rec: str, smi_name: str, during=None):
    """Phase 13e: the AL CLI on ICNet in child processes on phase 11's
    records, with the AL conf (batch 8, 512x1024) made ICNet's in a
    temporary directory (``network.model`` ICNet, ``softmax.multiscale``
    true) and cut as 11c cuts it: an entropy round, a core-set round and
    BALD side by side, BALD to fail with the JAX CLI's ValueError before
    state.json is written; ``during()`` runs in this process while they
    do (13d). Each round child prints ICNet's score kernels' launches
    (counted from 0 in the child). Returns (the entropy round's launches
    by kernel, each round's al_timing, what ``during`` returned)."""
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        icnet_front)
    port = "semanticsegmentationactivelearning_tpu_torch"
    after = (
        "from semanticsegmentationactivelearning_tpu_torch.ops.kernels "
        "import icnet_front, icnet_head\n"
        "print('icnet-score-launches:', "
        "icnet_front.fused_icnet_front_stem.launches, "
        "icnet_head.fused_cff2_head8_entropy_score.launches, "
        "icnet_front.fused_icnet_front.launches, "
        "icnet_head.fused_head8_entropy_score.launches)\n")
    with open(AL_CONF) as fp:
        conf = json.load(fp)
    conf["network"]["model"] = "ICNet"
    conf["hyperparams"]["softmax"]["multiscale"] = True
    conf["epochs"] = 1
    conf["hyperparams"]["learning_rate"] = 1e-7
    conf["active_learning"].update({
        "iterations": 1, "epochs/warm_up": 0, "num_validation": 4,
        "num_initially_labelled": 8, "selection_size": 8})
    batches = -(-AL_POOL // SN)
    timings, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        def conf_file(name, **al_over):
            c = copy.deepcopy(conf)
            c["active_learning"].update(al_over)
            path = os.path.join(tmp, f"{name}.json")
            with open(path, "w") as fp:
                json.dump(c, fp)
            return path

        started = {}
        for name, over in (("entropy", {}), ("coreset",
                                             {"selection": "coreset"})):
            log = os.path.join(tmp, name)
            started[name] = log, start_child(
                f"{port}.active_learning", "cityscapes", "-d", rec, "-l",
                log, "-p", conf_file(name, **over), "--seed", str(seed),
                after=after)
        # BALD: ICNet has no dropout layer
        bald_log = os.path.join(tmp, "bald")
        bald = subprocess.Popen(
            [sys.executable, "-m", f"{port}.active_learning", "cityscapes",
             "-d", rec, "-l", bald_log, "-p",
             conf_file("bald", measure="bald", mc_passes=MC_PASSES),
             "--seed", str(seed)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        procs = [bald] + [h[1] for _, h in started.values()]
        try:
            during_out = during() if during is not None else None
            for name, (log, handle) in started.items():
                res, secs = wait_child(handle)
                counts = [int(v) for v in [
                    ln for ln in res.stdout.splitlines()
                    if ln.startswith("icnet-score-launches:")][-1].split()[1:]]
                with open(os.path.join(log, "metrics.jsonl")) as fp:
                    records = [json.loads(ln) for ln in fp]
                with open(os.path.join(log, "state.json")) as fp:
                    state = json.load(fp)
                with open(os.path.join(log, "config.json")) as fp:
                    model = json.load(fp)["network"]["model"]
                lab = state["dataset"]["train"]["labelled"]
                unlab = state["dataset"]["train"]["unlabelled"]
                splits = [r["split"] for r in records]
                timing = [r for r in records if r["split"] == "al_timing"]
                timings[name] = timing
                # the entropy pass: the front + stem's launches and CFF2 +
                # head's once a pool batch; core-set embeds by the plain
                # forward
                want = ([icnet_front.LAUNCHES_PER_CALL * batches, batches,
                         0, 0] if name == "entropy" else [0, 0, 0, 0])
                print(f"al 13e (ICNet, {name}): {secs:.1f} s; iteration "
                      f"{state['iteration']}, {len(lab)} labelled; records "
                      f"{sorted(set(splits))}; ICNet score launches "
                      f"front+stem/CFF2 + head/front/head {counts} "
                      f"(expected {want}); "
                      f"al_timing " + ", ".join(
                          f"{k} {timing[0][k]}" for k in (
                              "train_s", "restore_s", "test_s",
                              "score_select_s", "round_s")))
                picked = "al_coreset" if name == "coreset" else "al_confidence"
                other = "al_confidence" if name == "coreset" else "al_coreset"
                if (model != "ICNet" or state["iteration"] != 1
                        or len(lab) != 16 or len(set(lab)) != 16
                        or not set(lab).isdisjoint(unlab)
                        or sorted(lab + unlab) != list(range(AL_POOL))
                        or splits.count(picked) != 1 or other in splits
                        or len(timing) != 1
                        or any(set(r) != AL_SECONDARY_KEYS[r["split"]]
                               for r in records)
                        or f"Running on {smi_name}" not in res.stdout
                        or counts != want):
                    raise AssertionError(f"AL CLI on ICNet ({name}): not as "
                                         "expected")
                if name == "entropy":
                    launches = {"icnet_front_stem": counts[0],
                                "icnet_cff2_head_score": counts[1]}

            _, err = bald.communicate()
            wrote = os.path.exists(os.path.join(bald_log, "state.json"))
            print(f"al 13e (ICNet, bald): exit {bald.returncode}; "
                  f"{(err.strip().splitlines() or [''])[-1]}; state.json "
                  f"written: {wrote}")
            if bald.returncode == 0 or wrote or "ValueError: measure 'bald' " \
                    "needs a model with active dropout" not in err:
                raise AssertionError("BALD on ICNet did not raise the JAX "
                                     "CLI's ValueError before writing")
        finally:
            for proc in procs:   # a failure leaves no child running
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return launches, timings, during_out


# phase 14: Freiburg multi-modal (conf/freiburg_forest.json: ENet, batch
# 8, 432x648, Freiburg's 6 classes; RGB and the NIR plane) and the
# migration entries (generate_dataset, the reference-checkpoint importer)
FB_CONF = "conf/freiburg_forest.json"
FB_CLASSES, FB_PLANES = 6, 4
FN, FH, FW = 8, 432, 648
FB_TRAIN, FB_TEST = 24, 4   # 14a's examples a split
# 14b's learning check: the conf's Adam at 5e-4 with label smoothing 0.05
# and dropout over 6 classes took the loss on one batch to 0.774 of its
# first in 20 steps on the card and to 0.547 in 60 on the CPU (216x328),
# falling steadily; 100 steps halve it
FB_LEARN_STEPS = 100
# GT_color colours of five Freiburg classes (datasets/freiburg.py: Road,
# Grass, Vegetation, Sky, Obstacle)
FB_COLORS = ((170, 170, 170), (0, 255, 0), (102, 102, 51), (0, 120, 255),
             (0, 0, 0))
# appended to a phase-14 child: every score and predict wrapper's launches
# in FB_COUNTED's order
FB_COUNTED = ("front", "mid", "tail", "tail_score", "decoder_score",
              "deconv_score", "icnet_front_stem", "icnet_cff2_head_score",
              "icnet_front", "icnet_head8_score")
FB_COUNTS = (
    "from semanticsegmentationactivelearning_tpu_torch.ops.kernels import "
    "front, mid, tail, decoder, deconv_score, icnet_front, icnet_head\n"
    "print('fb-kernel-launches:', front.fused_front_stage1.launches, "
    "mid.fused_mid_stage23.launches, tail.fused_tail_predict.launches, "
    "tail.fused_tail_entropy_score.launches, "
    "decoder.fused_decoder_entropy_score.launches, "
    "deconv_score.fused_deconv_entropy_score.launches, "
    "icnet_front.fused_icnet_front_stem.launches, "
    "icnet_head.fused_cff2_head8_entropy_score.launches, "
    "icnet_front.fused_icnet_front.launches, "
    "icnet_head.fused_head8_entropy_score.launches)\n")
PORT = "semanticsegmentationactivelearning_tpu_torch"


def fb_launches(res) -> dict:
    """The FB_COUNTS line of a child's output, by kernel."""
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("fb-kernel-launches:")][-1]
    return dict(zip(FB_COUNTED, map(int, line.split()[1:])))


def write_freiburg_tree(root: str, seed: int) -> None:
    """Phase 14a's dataset tree, the Freiburg layout: ``train/`` and
    ``test/``, each with ``rgb/``, ``nir_gray/`` (one plane) and
    ``GT_color/`` PNGs of FH x FW, a 6x8 grid of blocks an example whose
    class sets the label's colour (FB_COLORS), the image's (a colour a
    class, with noise) and the NIR plane's (50 a class, with noise)."""
    rng = np.random.default_rng(seed)
    tint = rng.integers(0, 256, (len(FB_COLORS), 3))
    colors = np.array(FB_COLORS, np.uint8)
    for split, n in (("train", FB_TRAIN), ("test", FB_TEST)):
        for sub in ("rgb", "nir_gray", "GT_color"):
            os.makedirs(os.path.join(root, split, sub))
        for i in range(n):
            idx = rng.integers(0, len(FB_COLORS), (6, 8))
            lbl = np.kron(idx, np.ones((FH // 6, FW // 8), np.int64))
            img = np.clip(tint[lbl] + rng.integers(-20, 20, (FH, FW, 3)),
                          0, 255).astype(np.uint8)
            nir = np.clip(lbl * 50 + 10 + rng.integers(-5, 5, (FH, FW)),
                          0, 255).astype(np.uint8)
            name = f"{split[0]}{i:03d}"
            for sub, a in (("GT_color", colors[lbl]), ("rgb", img),
                           ("nir_gray", nir)):
                PIL.Image.fromarray(a).save(os.path.join(
                    root, split, sub,
                    f"{name}_mask.png" if sub == "GT_color"
                    else f"{name}.png"))


def freiburg_etl(seed: int, tmp: str) -> str:
    """Phase 14a: the Freiburg tree (write_freiburg_tree), then the port's
    generate_dataset in a child process with ``--modalities rgb
    nir_gray``; the records' splits, planes and NIR plane checked.
    Returns the records' directory."""
    from semanticsegmentationactivelearning_tpu_torch.data import (example,
                                                                   loader)
    tree, rec = os.path.join(tmp, "freiburg"), os.path.join(tmp, "fb_rec")
    t0 = time.perf_counter()
    write_freiburg_tree(tree, seed + 70)
    os.makedirs(rec)
    _, secs = run_child(f"{PORT}.generate_dataset", "-d", tree, "-t",
                        "freiburg", "-o", rec, "--modalities", "rgb",
                        "nir_gray")
    counts = {s: len(os.listdir(os.path.join(rec, s)))
              for s in sorted(os.listdir(rec))}
    test = sorted(os.path.join(rec, "test", f)
                  for f in os.listdir(os.path.join(rec, "test")))
    dims = example.peek_dims(test[0])
    ld = loader.RecordLoader(test, FB_TEST, modalities=("nir_gray",))
    stack = next(iter(ld.batches()))["stack"]
    nir = np.stack([np.asarray(PIL.Image.open(os.path.join(
        tree, "test", "nir_gray", f"t{i:03d}.png"))) for i in range(FB_TEST)])
    labels = set(np.unique(stack[..., FB_PLANES]).tolist())
    print(f"fb 14a: the tree and generate_dataset in "
          f"{time.perf_counter() - t0:.1f} s (the child {secs:.1f} s); "
          f"records {counts}; image {dims}; loader channels {ld.channels}, "
          f"stack {stack.shape}; NIR planes equal {np.array_equal(stack[..., 3], nir)}; "
          f"label values {sorted(labels)}")
    if sum(counts.values()) != FB_TRAIN + FB_TEST or set(counts) != {
            "train", "val", "test"} or dims != (FH, FW, 3) \
            or ld.channels != FB_PLANES \
            or stack.shape != (FB_TEST, FH, FW, FB_PLANES + 1) \
            or not np.array_equal(stack[..., 3], nir) \
            or not labels <= set(range(len(FB_COLORS))):
        raise AssertionError("the Freiburg records are not as expected")
    return rec


def fb_model(seed: int, final_scale: float, device=DEV):
    """Phase 14b's ENet-6 of FB_PLANES input planes, seeded_state_dict's
    weights with the Final kernel x ``final_scale``."""
    from semanticsegmentationactivelearning_tpu_torch.models import (
        get_model)
    model = get_model("ENet", FB_CLASSES, in_channels=FB_PLANES)
    model.load_state_dict(seeded_state_dict(model, seed, final_scale))
    return model.to(device).eval()


def fb_stack(seed: int) -> np.ndarray:
    """block_stack's FN x FH x FW batch with a NIR plane (50 a class)
    before the label plane: uint8 ``[FN, FH, FW, FB_PLANES + 1]``."""
    stack = block_stack(FN, FH, FW, seed)
    label = stack[..., 3:].astype(np.int64)
    nir = np.where(label == 255, 0, label * 50 + 10).astype(np.uint8)
    return np.concatenate([stack[..., :3], nir, stack[..., 3:]], -1)


def check_freiburg(seed: int) -> dict:
    """Phase 14b: #7 (the decoder score route, ``tail5_kernel`` on its
    score route) at the Freiburg shape, where ENet's ``fused_score``
    takes it for FB_PLANES input planes: the kernel against its plain
    version on the same stage-4 features, and the route against the
    plain chain, at each Final scale of SCORE_SCALES, within SCORE_TOL
    an image; its per-tile means (tile sums over their pixels: the edge
    tiles are partial) under PRECISION_GATE at the first scale (as phase
    5a); its time beside its plain version's and its bound. Then the eval forward against the
    CPU's (phase 3's feature gate), the train step's ms/step at batch FN
    (TF32 convs) and the learning check on one batch. Returns #7's
    results and the train step's."""
    from semanticsegmentationactivelearning_tpu_torch.data import pipeline
    from semanticsegmentationactivelearning_tpu_torch.ops import acquisition
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        decoder, front, tail)
    set_precision("fp32")
    rng = np.random.default_rng(seed + 50)
    image = torch.from_numpy(rng.integers(
        0, 256, (FN, FH, FW, FB_PLANES), dtype=np.uint8)).to(DEV)
    image = image.float() / 255.0
    r = dict(max_abs_err=0.0)
    for scale in SCORE_SCALES:
        model = fb_model(seed, scale)
        with torch.no_grad():
            f4, sw1 = model(image, return_stage4=True)
            m1 = front.switches_to_mask(sw1)
            args = (f4, m1, model)

            def fused(f, m, mdl):
                return decoder.fused_decoder_entropy_score(f, None, mdl,
                                                           mask=m)

            got, again = fused(*args), fused(*args)
            want = decoder.decoder_score_plain(*args)
            route = model.fused_score(image, "entropy")
            chain = acquisition.mean_confidence(model(image), "entropy",
                                                FB_CLASSES)
        err = (got - want).abs().max().item()
        route_err = (route - chain).abs().max().item()
        print(f"fb 14b decoder_score (ENet-{FB_CLASSES}, {FB_PLANES} "
              f"planes, Final x{scale:g}, batch {FN}, {FH}x{FW}, eighth "
              f"grid {FH // 8}x{FW // 8}): scores "
              f"{[round(v, 6) for v in got.tolist()]}, max |k-p| "
              f"{err:.3e}; fused_score against the plain chain "
              f"{route_err:.3e}; repeat identical {torch.equal(got, again)}")
        if not (err <= SCORE_TOL and route_err <= SCORE_TOL
                and torch.isfinite(got).all()):
            raise AssertionError(f"decoder_score at {FH}x{FW}: scores "
                                 f"differ by {err} (route {route_err})")
        if not torch.equal(got, again):
            raise AssertionError("decoder_score: not bit-repeatable")
        r["max_abs_err"] = max(r["max_abs_err"], err, route_err)
        if "ms" not in r:  # at the first scale, as phase 5a
            # per pixel: the edge tiles hold fewer pixels here, so a
            # rounding's shift of every pixel's confidence moves their
            # sums less than the others' (5a's tiles are all full)
            pix = tile_pixels(f4.shape[1], f4.shape[2], DEV)

            def measure(d):
                return centred_max(d / pix)

            parts = tail.launch_decode(f4, m1, model, True)
            want_t = tail.decode_partials_plain(f4, m1, model)
            precision_gate(
                f"fb 14b decoder tile means (Final x{scale:g})",
                tail.PRECISION["score"], measure(parts - want_t), model,
                lambda m: tail.decode_partials_plain(f4, m1, m), want_t,
                ("Bottleneck5_0", "Bottleneck5_1", "Final"), measure)
            del parts, want_t
            r["ms"] = cuda_ms(lambda: fused(*args))
            r["plain_ms"] = cuda_ms(lambda: decoder.decoder_score_plain(
                *args))
            first = tail.tail_layout(FB_CLASSES)[tail.T5_FIRST][0]
            r.update(roofline(
                (f4, m1, model.packed("tail", f4.device,
                                      tail.pack_tail)[first:]), (got,),
                count_flops(decoder.decoder_score_plain, args)
                + softmax_flops(FN, FH, FW, FB_CLASSES),
                TC_PEAK[tail.PRECISION["score"]]))
        del f4, m1
    print(f"fb 14b decoder_score: kernel {r['ms']:.3f} ms "
          f"({r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s of least work), plain "
          f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
          f"({r['bound_by']}) (batch {FN}, {FH}x{FW})")

    model = fb_model(seed, FINAL_SCALE)
    cpu = fb_model(seed, FINAL_SCALE, "cpu")
    with torch.no_grad():
        got = model(image[:TN]).cpu()
        want = cpu(image[:TN].cpu())
    feat = ((got - want).abs().max() / want.abs().max()).item()
    print(f"fb 14b: the eval forward (batch {TN}) against the CPU's: max "
          f"|error| {feat:.3e} of the CPU's maximum (gate 1e-3)")
    if not feat <= 1e-3:
        raise AssertionError("the 4-plane eval forward disagrees with the "
                             "CPU's")
    del model, cpu, image

    set_precision("default")
    stack = torch.from_numpy(fb_stack(seed + 51)).to(DEV)
    heights = torch.full((FN,), FH, device=DEV)
    widths = torch.full((FN,), FW, device=DEV)
    state, step, hp = train_setup(FB_CONF, DEV, False, seed, FB_CLASSES,
                                  FB_PLANES)
    times = []
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        gen = torch.Generator(DEV).manual_seed(seed + i)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, img, label, mask = pipeline.augment_batch(
            stack, heights, widths, gen, (FH, FW), channels=FB_PLANES)
        step(state, {"image": img, "label": label, "mask": mask,
                     "valid": torch.ones(FN, device=DEV)}, gen)
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    ms = float(np.median([s.elapsed_time(e)
                          for s, e in times[TRAIN_WARMUP:]]))
    state, step, hp = train_setup(FB_CONF, DEV, False, seed, FB_CLASSES,
                                  FB_PLANES)
    batch = {"image": img, "label": label, "mask": mask,
             "valid": torch.ones(FN, device=DEV)}
    losses = [step(state, batch,
                   torch.Generator(DEV).manual_seed(100 + i))["loss"]
              for i in range(FB_LEARN_STEPS)]
    losses = [v.item() for v in losses]
    set_precision("fp32")
    print(f"fb 14b train ({FB_CONF}: {hp['optimizer']['type']}, "
          f"{FB_PLANES} planes): {ms:.3f} ms/step, {1000.0 * FN / ms:.1f} "
          f"images/s (batch {FN}, {FH}x{FW}, median of {TRAIN_TIMED} after "
          f"{TRAIN_WARMUP}); loss on one batch over {FB_LEARN_STEPS} steps "
          f"{losses[0]:.4f} -> {losses[19]:.4f} (20) -> {losses[-1]:.4f} "
          f"({losses[-1] / losses[0]:.3f} of the first)")
    if not all(np.isfinite(losses)) or not losses[-1] < 0.5 * losses[0]:
        raise AssertionError(f"the 4-plane step does not learn one batch in "
                             f"{FB_LEARN_STEPS} steps")
    return {"decoder_score": r, "train_ms": ms}


def run_freiburg_clis(seed: int, rec: str, tmp: str) -> tuple:
    """Phase 14c: the CLIs with ``freiburg -m rgb nir_gray`` on 14a's
    records, each in a child process that prints every score and predict
    kernel's launches. The AL child (one entropy round of the AL conf
    made Freiburg's: input FH x FW, cut as 11c) runs beside the train
    child (2 epochs of FB_CONF) and then the inference child, which
    serves the trained checkpoint through the plain route with no kernel
    launched; its maps must equal this process's plain forward on the
    decided pixels. The AL round's pool pass must launch #7 once a batch
    and no other kernel. Returns (#7's launches there, the round's
    al_timing)."""
    from semanticsegmentationactivelearning_tpu_torch import datasets
    from semanticsegmentationactivelearning_tpu_torch.data import loader
    from semanticsegmentationactivelearning_tpu_torch.models import (
        get_model)
    from semanticsegmentationactivelearning_tpu_torch.train import (
        checkpoint)
    mods = ("-m", "rgb", "nir_gray")
    with open(AL_CONF) as fp:
        conf = json.load(fp)
    conf["network"]["input"] = {"height": FH, "width": FW}
    conf["epochs"] = 1
    conf["hyperparams"]["learning_rate"] = 1e-7
    conf["active_learning"].update({
        "iterations": 1, "epochs/warm_up": 0, "num_validation": 4,
        "num_initially_labelled": 8, "selection_size": 8})
    al_conf, al_log = os.path.join(tmp, "fb_al.json"), \
        os.path.join(tmp, "fb_al")
    with open(al_conf, "w") as fp:
        json.dump(conf, fp)
    al = start_child(f"{PORT}.active_learning", "freiburg", "-d", rec, "-l",
                     al_log, "-p", al_conf, "--seed", str(seed), *mods,
                     after=FB_COUNTS)
    try:
        with open(FB_CONF) as fp:
            conf = json.load(fp)
        conf["epochs"] = 2
        train_conf, log = os.path.join(tmp, "fb_train.json"), \
            os.path.join(tmp, "fb_log")
        with open(train_conf, "w") as fp:
            json.dump(conf, fp)
        res, secs = run_child(f"{PORT}.train", "freiburg", "-d", rec, "-l",
                              log, "-p", train_conf, "--seed", str(seed),
                              *mods)
        with open(os.path.join(log, "metrics.jsonl")) as fp:
            records = [json.loads(line) for line in fp]
        losses = [r["loss"] for r in records if r["split"] == "train"]
        state = checkpoint.restore_checkpoint(log)
        planes = checkpoint.input_planes(state)
        print(f"fb 14c train cli (2 epochs, {FB_PLANES} planes): {secs:.1f} "
              f"s; records {[r['split'] for r in records]}; train loss by "
              f"epoch {losses}; the checkpoint's input planes {planes}")
        if planes != FB_PLANES or len(losses) != 2 \
                or "Stacking modalities ['nir_gray'] -> 4 input channels" \
                not in res.stdout + res.stderr:
            raise AssertionError("the 4-plane train CLI is not as expected")

        out = os.path.join(tmp, "fb_out")
        test_dir = os.path.join(rec, "test")
        res, secs = run_child(f"{PORT}.inference", "-c", log, "-d", test_dir,
                              "-o", out, "-t", "freiburg", "--modalities",
                              "nir_gray", "-b", "2", after=FB_COUNTS)
        served = fb_launches(res)
        files = sorted(os.path.join(test_dir, f)
                       for f in os.listdir(test_dir))
        model = get_model("ENet", FB_CLASSES, in_channels=FB_PLANES)
        checkpoint.restore_checkpoint(log, model)
        model = model.to(DEV).eval()
        set_precision("default")  # the CLI's precision
        ld = loader.RecordLoader(files, len(files), modalities=("nir_gray",),
                                 with_label=False)
        with torch.no_grad():
            logits = model(torch.from_numpy(next(iter(ld.batches()))[
                "stack"]).to(DEV).float() / 255.0)
        set_precision("fp32")
        want, decided = decided_labels(logits, AL_DECIDED)
        cmap = torch.from_numpy(datasets.Freiburg().colormap).to(DEV)
        differ = 0
        for i, f in enumerate(files):
            png = os.path.join(out, os.path.basename(f).replace(
                ".tfrecord", ".png"))
            got = torch.from_numpy(np.array(PIL.Image.open(png))).to(DEV)
            differ += int(((got != cmap[want[i]]).any(-1) & decided[i])
                          .sum())
        share = decided.float().mean().item()
        print(f"fb 14c inference cli ({FB_PLANES} planes): {len(files)} "
              f"maps in {secs:.1f} s; launches {served}; {differ} decided "
              f"pixels differ from this process's plain forward "
              f"({share:.5f} of pixels decided at margin {AL_DECIDED:g})")
        if any(served.values()) or differ > AL_FLIPS * int(decided.sum()) \
                or share < 0.9 or "through the plain forward" \
                not in res.stderr:
            raise AssertionError("the inference CLI did not serve the 4-plane "
                                 "checkpoint through the plain route")

        res, secs = wait_child(al)
    finally:
        if al[1].poll() is None:
            al[1].kill()
            al[1].wait()
    counts = fb_launches(res)
    with open(os.path.join(al_log, "state.json")) as fp:
        state = json.load(fp)
    with open(os.path.join(al_log, "metrics.jsonl")) as fp:
        records = [json.loads(line) for line in fp]
    timing = [r for r in records if r["split"] == "al_timing"]
    pool = len(state["dataset"]["train"]["filenames"])
    want = dict.fromkeys(FB_COUNTED, 0)
    want["decoder_score"] = -(-pool // SN)
    print(f"fb 14c al cli (entropy, {FB_PLANES} planes, {FH}x{FW}): "
          f"{secs:.1f} s; iteration {state['iteration']}, "
          f"{len(state['dataset']['train']['labelled'])} labelled of "
          f"{pool}; launches {counts} (expected {want}); al_timing "
          + ", ".join(f"{k} {timing[0][k]}" for k in (
              "train_s", "restore_s", "test_s", "score_select_s",
              "round_s")))
    if counts != want or state["iteration"] != 1 or len(timing) != 1 \
            or [r["split"] for r in records].count("al_confidence") != 1:
        raise AssertionError("the 4-plane AL round did not rank its pool "
                             "through #7 alone")
    return counts["decoder_score"], timing


_REF_BN = {"weight": "gamma", "bias": "beta", "running_mean": "mean",
           "running_var": "variance"}
_REF_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"


def reference_variables(state: dict) -> dict:
    """A port ENet's ``state_dict`` as the reference's TF checkpoint
    names and lays it out (``tf.train.load_checkpoint``'s key -> array):
    the inverse of ``train/tf_import``'s mapping, kept out of the package.
    Conv kernels HWIO, transposed-conv kernels ``[H, W, out, in]`` (both
    are the port's weight permuted (2, 3, 1, 0)), the asymmetric pair as
    ``conv_kernel/0|1``, BN as gamma/beta/mean/variance and the
    multiscale heads as ``loss_scale_weights/i``."""
    out = {}
    for key, value in state.items():
        a = value.detach().cpu().numpy()
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        *mods, leaf = key.split(".")
        block, sub = mods[0], mods[-1]
        if block.startswith("MultiscaleHead_"):
            path = f"loss_scale_weights/{block.rsplit('_', 1)[1]}"
        elif block in ("Initial", "Final"):
            path = block + "/" + ("kernel" if sub in ("conv", "deconv")
                                  else "alpha" if leaf == "alpha"
                                  else _REF_BN[leaf])
        else:
            attr = {"conv": "conv_kernel", "deconv": "conv_kernel",
                    "conv_col": "conv_kernel/0", "conv_row": "conv_kernel/1",
                    "res_conv": "res_kernel",
                    "res_prelu": "residual_alpha"}.get(sub)
            if attr is None:
                part, kind = sub.rsplit("_", 1)
                attr = (f"{part}_kernel" if kind == "conv" else
                        f"{part}_alpha" if kind == "prelu" else
                        f"{part}_{_REF_BN[leaf]}")
            path = f"{block}/{attr}"
        out[f"model/{path}{_REF_SUFFIX}"] = np.ascontiguousarray(a)
    return out


def check_importer(seed: int) -> dict:
    """Phase 14d: the reference-checkpoint importer without TensorFlow.
    A seeded ENet-19 with the multiscale heads, as the reference's
    variables (reference_variables, with its epoch, step, save counter
    and an optimizer slot), through ``tf_import.convert_reference_variables``:
    every tensor must come back bit-equal, and ``load_into`` must place
    each. The imported model serves a batch of 2 at 1024x2048 through #1,
    #3 and #5 with the original model's labels. Then once more with
    FB_PLANES input planes (``--modality-channels 4``): a 3-plane model
    must refuse its first conv, and the imported model must score a
    batch through #7 as the original does. Returns the launches by
    kernel of the 3-plane serving."""
    from semanticsegmentationactivelearning_tpu_torch.models import (
        get_model)
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        decoder, front, mid, tail)
    from semanticsegmentationactivelearning_tpu_torch.train import tf_import
    rng = np.random.default_rng(seed + 60)
    launches = {}
    for planes in (3, FB_PLANES):
        model = get_model("ENet", CLASSES, multiscale_heads=True,
                          in_channels=planes)
        state = seeded_state_dict(model, seed + planes)
        model.load_state_dict(state)
        named = reference_variables(state)
        named.update({
            f"epoch{_REF_SUFFIX}": np.int64(7),
            f"step{_REF_SUFFIX}": np.int64(123),
            f"save_counter{_REF_SUFFIX}": np.int64(7),
            "model/Initial/kernel/.OPTIMIZER_SLOT/optimizer/m"
            f"{_REF_SUFFIX}": np.zeros(1, np.float32)})
        conv = tf_import.convert_reference_variables(named)
        got = conv["state_dict"]
        unequal = [k for k in state if k not in got
                   or not torch.equal(got[k], state[k])]
        imported = get_model("ENet", CLASSES, multiscale_heads=True,
                             in_channels=planes)
        report = tf_import.load_into(imported, conv)
        refused = tf_import.merge_report(
            get_model("ENet", CLASSES, multiscale_heads=True).state_dict(),
            conv)["mismatched"]
        print(f"importer 14d ({planes} planes): {len(named)} reference "
              f"variables -> {len(got)} tensors, {len(unequal)} not "
              f"bit-equal {unequal[:3]}; epoch {conv['epoch']}, step "
              f"{conv['step']}, save counter {conv.get('save_counter')}, "
              f"skipped {conv['skipped']}; merged {report['merged']}, "
              f"missing {report['missing']}, mismatched "
              f"{report['mismatched']}; a 3-plane ENet refuses "
              f"{[k for k, _, _ in refused]}")
        if unequal or set(got) != set(state) or report["merged"] != len(state) \
                or report["missing"] or report["mismatched"] \
                or (conv["epoch"], conv["step"], conv.get("save_counter")) \
                != (7, 123, 7) or len(conv["skipped"]) != 1 \
                or [k for k, _, _ in refused] != (
                    [] if planes == 3 else ["Initial.conv.weight"]):
            raise AssertionError("the importer did not map the reference's "
                                 "variables back bit-equal")
        model, imported = model.to(DEV).eval(), imported.to(DEV).eval()
        if planes == 3:
            image = torch.from_numpy(rng.integers(
                0, 256, (N, H, W, 3), dtype=np.uint8)).to(DEV).float() / 255.0
            want = model.fused_predict(image)
            wrappers = (front.fused_front_stage1, mid.fused_mid_stage23,
                        tail.fused_tail_predict)
            for fn in wrappers:
                fn.launches = 0
            labels = imported.fused_predict(image)
            launches = dict(zip(("front", "mid", "tail"),
                                (fn.launches for fn in wrappers)))
            same = torch.equal(labels, want)
            print(f"importer 14d: the imported ENet-19 serves batch {N} at "
                  f"{H}x{W} with launches {launches}; labels equal the "
                  f"original's: {same}")
            if not same or launches != {
                    "front": front.LAUNCHES_PER_CALL,
                    "mid": mid.LAUNCHES_PER_CALL,
                    "tail": tail.LAUNCHES_PER_CALL}:
                raise AssertionError("the imported model does not serve as "
                                     "the original")
        else:
            image = torch.from_numpy(rng.integers(
                0, 256, (N, SH, SW, planes), dtype=np.uint8)).to(DEV)
            image = image.float() / 255.0
            before = decoder.fused_decoder_entropy_score.launches
            # the 4-plane route's encoder is the plain forward, whose cuDNN
            # convolutions are not bit-repeatable by default (ROADMAP
            # Queue 3): one ulp apart in a score at seed 0 (PR 18)
            torch.backends.cudnn.deterministic = True
            got = imported.fused_score(image, "entropy")
            want = model.fused_score(image, "entropy")
            torch.backends.cudnn.deterministic = False
            print(f"importer 14d: the imported {planes}-plane ENet-19 scores "
                  f"{got.tolist()} through #7 "
                  f"({decoder.fused_decoder_entropy_score.launches - before}"
                  f" launches for both), the original {want.tolist()}")
            if not torch.equal(got, want):
                raise AssertionError("the imported 4-plane model does not "
                                     "score as the original")
        del model, imported
    return launches


# phase 15: multi-process runs (parallel.distributed): two ranks share the
# card over Gloo (15a the train step, 15b the train and AL CLIs), a
# one-rank NCCL world through the train CLI (15c); with two cards or more
# also NCCL a card a rank and serving over two cards
DP_WORLD = 2       # 15a, 15b: the ranks
DP_TIMED = 3       # 15a: timed steps (and gradient all-reduces) after one
DP_CONF = TRAIN_CONFS["pretrain"]   # 15a: the conf's dropout, loss, Adam
# 15a gates the BN statistics against a world of one rank alone (its BN
# code is the ranks'): at batch 8, 512x1024 an fp32 step takes ~1 pool
# switch at a near-tied window (B1_0's and B2_0's 4 M windows each) other
# than another fp32 or float64 step does, and each moves the decoder's
# statistics by up to ~1e-5 of their magnitude. PR 18's calls read the
# two ranks against the plain fp32 step at 6.7e-7 to 1.035e-5 (seeds 3,
# 1, 0, 2) and against float64 at 2.4e-6 to 1.26e-5, and the plain fp32
# step itself 1.3e-5 off float64 at seed 1 (PERF.md). The loss and the
# gradients are gated against every reference.
DP_STATS_REF = "world of one"
# a rank of 15a (a child with torchrun's variables): its step's results
STEP_RANK = ("import sys\n"
             "import chip_smoke\n"
             "chip_smoke.step_rank(int(sys.argv[1]), sys.argv[2])\n")
# before a CLI rank's module: count the files it opens for writing under
# the log directory after its "-l"; after it: print the count and the
# score kernels' launches (front, mid, tail score)
WRITE_COUNTER = (
    "import builtins, os\n"
    "_log = os.path.abspath(sys.argv[sys.argv.index('-l') + 1])\n"
    "_writes, _open = [], builtins.open\n"
    "def _counted(file, mode='r', *args, **kwargs):\n"
    "    if isinstance(file, (str, bytes, os.PathLike)) \\\n"
    "            and set(mode) & set('wax+') \\\n"
    "            and os.path.abspath(os.fsdecode(file)).startswith(_log):\n"
    "        _writes.append(file)\n"
    "    return _open(file, mode, *args, **kwargs)\n"
    "builtins.open = _counted\n")
RANK_REPORT = (
    "from semanticsegmentationactivelearning_tpu_torch.ops.kernels import "
    "front, mid, tail\n"
    "print('rank-report:', len(_writes), front.fused_front_stage1.launches, "
    "mid.fused_mid_stage23.launches, "
    "tail.fused_tail_entropy_score.launches)\n")


def rank_env(rank: int, world: int, port: int, shared: bool) -> dict:
    """torchrun's variables for ``rank`` of ``world`` on this host;
    ``shared``: the ranks see the first card alone (Gloo, the backend
    rule of ``parallel.distributed``), else every card (NCCL, a card a
    rank)."""
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world))
    if shared:
        env["CUDA_VISIBLE_DEVICES"] = os.environ.get(
            "CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    return env


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dp_step(seed: int, device, rank: int = 0, world: int = 1,
            dtype=torch.float32) -> dict:
    """15a's step: DP_CONF's state from the seeded weights on ``device``
    in ``dtype``, one train step on rows ``rank``'s share of a batch of
    TB at TH x TW (fixed_batch's draws; the dropout masks keyed by (seed,
    0) and the global rows, ``train.steps.dropout_masks``), TF32 off.
    Returns its loss, gradients and BN statistics; in float32 also the
    ms a step over DP_TIMED more (after one) and the gradient
    all-reduce's ms (no-op in one process), each on the host's clock
    between synchronizes."""
    from semanticsegmentationactivelearning_tpu_torch.parallel import (
        distributed)
    from semanticsegmentationactivelearning_tpu_torch.train import steps
    set_precision("fp32")
    state, step, _ = train_setup(DP_CONF, device, False, seed)
    state.model.to(dtype)
    n = TB // world
    rows = np.arange(rank * n, (rank + 1) * n)
    batch = fixed_batch(block_stack(TB, TH, TW, seed + 60)[rows], device,
                        dtype)

    def timed(fn):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        return 1e3 * (time.perf_counter() - t0)

    def one(i):
        return step(state, batch, steps.dropout_masks((seed, i), rows,
                                                      device))

    out = {"loss": one(0)["loss"].item(),
           "grads": {k: p.grad.detach().cpu().clone()
                     for k, p in state.model.named_parameters()},
           "stats": {k: v.detach().cpu().clone()
                     for k, v in state.model.state_dict().items()
                     if "running" in k}}
    if dtype != torch.float32:
        return out
    ms = [timed(lambda: one(i + 1)) for i in range(DP_TIMED + 1)]
    reduce_ms = [timed(lambda: distributed.all_reduce_grads(
        state.model.parameters())) for _ in range(DP_TIMED + 1)]
    out.update(ms=float(np.median(ms[1:])),
               reduce_ms=float(np.median(reduce_ms[1:])))
    set_precision("fp32")
    return out


def step_rank(seed: int, out: str) -> None:
    """15a's rank, in a child process with torchrun's variables: joins
    the world on its card (``utils.cli.device_from_args``, the backend
    rule), runs :func:`dp_step` on its share and writes the result to
    ``out/rank{R}.pt``."""
    from semanticsegmentationactivelearning_tpu_torch.parallel import (
        distributed)
    from semanticsegmentationactivelearning_tpu_torch.utils import cli
    device = cli.device_from_args("cuda")
    distributed.initialize_distributed(device)
    rank, world = distributed.process_index(), distributed.process_count()
    res = dp_step(seed, device, rank, world)
    res["backend"] = torch.distributed.get_backend()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    distributed.shutdown()


def check_dp_step(seed: int, shared: bool = True, phase: str = "15a"
                  ) -> dict:
    """Phase 15a: :func:`dp_step` in DP_WORLD ranks (sharing the card over
    Gloo, or NCCL a card a rank) against one process on the same card,
    batch and masks: the plain step in fp32 and in float64 (the loss and
    each tensor's gradient, relative L2, against both) and the step of a
    world of one rank (the same BN code as the ranks'; the loss, the
    gradients and the BN statistics), under DP_CONF's fp32
    TRAIN_BOUNDS; the ranks' gradients bit-equal. The statistics against
    the plain steps are printed, not gated (DP_STATS_REF). Returns the
    times."""
    def start(world, tmp):
        port = free_port()
        return [start_script(f"{phase} rank {r} of {world}", STEP_RANK,
                             str(seed), tmp,
                             env=rank_env(r, world, port, shared))
                for r in range(world)]

    def results(handles, tmp):
        for h in handles:
            wait_child(h)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(len(handles))]

    # the ranks alone (their times are read), then the world of one beside
    # this process's float64 step, then its fp32 step alone
    with tempfile.TemporaryDirectory() as tmp2, \
            tempfile.TemporaryDirectory() as tmp1:
        ranks = results(start(DP_WORLD, tmp2), tmp2)
        handles = start(1, tmp1)
        torch.cuda.empty_cache()
        fp64 = dp_step(seed, DEV, dtype=torch.float64)
        one_rank, = results(handles, tmp1)
    refs = {"world of one": one_rank, "fp32": dp_step(seed, DEV),
            "fp64": fp64}
    ref = refs["fp32"]
    bounds = TRAIN_BOUNDS["pretrain"]["fp32"]

    def errors(got, want):
        return {"loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
                "grad": max(((got["grads"][k].double() - g.double()).norm()
                             / g.double().norm()).item()
                            for k, g in want["grads"].items()),
                "stats": max(((got["stats"][k].double() - v.double()).abs()
                              .max() / v.double().abs().max()).item()
                             for k, v in want["stats"].items())}

    got = ranks[0]
    err = {name: errors(got, r) for name, r in refs.items()}
    own = errors(ref, refs["fp64"])
    same = all(torch.equal(g, ranks[1]["grads"][k])
               for k, g in got["grads"].items())
    backend = got["backend"]
    print(f"dp {phase} ({DP_WORLD} ranks, {backend}, "
          f"{'sharing one card' if shared else 'a card a rank'}; ENet-"
          f"{CLASSES} {DP_CONF}, batch {TB} at {TH}x{TW}, {TB // DP_WORLD} "
          f"rows a rank, dropout on, TF32 off): loss {ref['loss']:.6f}; "
          + "; ".join(
              f"against one process's {name} step on the same card: loss "
              f"rel err {e['loss']:.3e}, gradients largest rel L2 "
              f"{e['grad']:.3e}, BN statistics {e['stats']:.3e}"
              f"{'' if name == DP_STATS_REF else ' (not gated)'}"
              for name, e in err.items())
          + f" (bounds {bounds}); one process's fp32 against its float64: "
          f"{own['loss']:.3e}, {own['grad']:.3e}, {own['stats']:.3e}; the "
          f"ranks' gradients bit-equal {same}; ms/step one process "
          f"{ref['ms']:.1f}, ranks "
          f"{[round(r['ms'], 1) for r in ranks]}, the gradient all-reduce "
          f"{[round(r['reduce_ms'], 2) for r in ranks]} ms (median of "
          f"{DP_TIMED} after 1)")
    if not same or any(e[k] > bounds[k] for name, e in err.items()
                       for k in bounds
                       if k != "stats" or name == DP_STATS_REF):
        raise AssertionError(f"the {DP_WORLD}-rank train step disagrees "
                             f"with one process's ({backend})")
    return {"ms": ref["ms"], "rank_ms": [r["ms"] for r in ranks],
            "reduce_ms": [r["reduce_ms"] for r in ranks],
            "backend": backend}


def start_ranks(module: str, world: int, shared: bool, argv) -> list:
    """Start ``module`` with ``argv`` as ``world`` ranks (WRITE_COUNTER
    before, RANK_REPORT after); :func:`wait_ranks` waits for them."""
    port = free_port()
    return [start_child(module, *argv, before=WRITE_COUNTER,
                        after=RANK_REPORT, env=rank_env(r, world, port, shared))
            for r in range(world)]


def wait_ranks(handles) -> list:
    """Each rank's (stdout, files written under the log directory, [front,
    mid, tail score launches]); fails on a rank's failure."""
    out = []
    for h in handles:
        res, _ = wait_child(h)
        report = [int(v) for v in [
            ln for ln in res.stdout.splitlines()
            if ln.startswith("rank-report:")][-1].split()[1:]]
        out.append((res.stdout, report[0], report[1:]))
    return out


def run_dp_clis(seed: int, rec: str, shared: bool = True,
                phase: str = "15b", during=None) -> dict:
    """Phase 15b: on phase 11's records, the train CLI (AL_CONF, one
    epoch) and one AL round (AL_CONF cut as 11c: 8 labelled, 8 picked,
    4 validation records, lr 1e-7) as DP_WORLD ranks; the AL round also
    in one process first. Rank 0 alone writes, the backend is the rule's
    (Gloo sharing the card, NCCL a card a rank), the records are as
    expected, the ranks' picks equal one process's, each rank's pool
    pass launches #1, #3 and #6 once a global batch. ``during()`` starts
    what runs beside the train CLI's ranks and returns what waits for it.
    Returns the ranks' launches by kernel and each run's al_timing."""
    port_pkg = "semanticsegmentationactivelearning_tpu_torch"
    backend = "gloo" if shared else "nccl"
    with open(AL_CONF) as fp:
        conf = json.load(fp)
    conf["epochs"] = 1
    conf["hyperparams"]["learning_rate"] = 1e-7
    conf["active_learning"].update({
        "iterations": 1, "epochs/warm_up": 0, "num_validation": 4,
        "num_initially_labelled": 8, "selection_size": 8})
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "conf.json")
        with open(path, "w") as fp:
            json.dump(conf, fp)
        args = ("cityscapes", "-d", rec, "-p", path, "--seed", str(seed))

        def checked(ranks, what):
            for r, (stdout, writes, _) in enumerate(ranks):
                if f"backend {backend}" not in stdout \
                        or f"Data-parallel over {DP_WORLD} ranks" \
                        not in stdout or (writes > 0) != (r == 0):
                    raise AssertionError(
                        f"{what}, rank {r}: {writes} files written, or not "
                        f"data-parallel over {backend}:\n{stdout[-3000:]}")
            return [w for _, w, _ in ranks]

        t0 = time.perf_counter()
        log = os.path.join(tmp, "train")
        handles = start_ranks(f"{port_pkg}.train", DP_WORLD, shared,
                              args + ("-l", log))
        finish = during() if during is not None else None
        writes = checked(wait_ranks(handles), "train CLI")
        if finish is not None:
            finish()
        with open(os.path.join(log, "metrics.jsonl")) as fp:
            splits = [json.loads(ln)["split"] for ln in fp]
        steps = -(-(AL_POOL + 4) // SN)
        print(f"dp {phase} train CLI ({DP_WORLD} ranks, {backend}): "
              f"{time.perf_counter() - t0:.1f} s; files written by rank "
              f"{writes}; records {splits}")
        if splits != ["train_iter"] * steps + ["train", "val", "final_val"] \
                or not os.path.exists(os.path.join(log, "model-1.ckpt")):
            raise AssertionError("the train CLI's ranks wrote other records "
                                 "or no checkpoint")

        def al_round(log, world):
            if world == 1:
                res = run_child(f"{port_pkg}.active_learning", *args, "-l",
                                log, before=WRITE_COUNTER,
                                after=RANK_REPORT)[0]
                ranks = [(res.stdout, 0, [int(v) for v in [
                    ln for ln in res.stdout.splitlines()
                    if ln.startswith("rank-report:")][-1].split()[2:]])]
            else:
                ranks = wait_ranks(start_ranks(
                    f"{port_pkg}.active_learning", world, shared,
                    args + ("-l", log)))
                checked(ranks, "AL CLI")
            with open(os.path.join(log, "state.json")) as fp:
                state = json.load(fp)
            with open(os.path.join(log, "metrics.jsonl")) as fp:
                records = [json.loads(ln) for ln in fp]
            return ranks, state, records

        one = al_round(os.path.join(tmp, "al_one"), 1)
        t0 = time.perf_counter()
        dp = al_round(os.path.join(tmp, "al_dp"), DP_WORLD)
        secs = time.perf_counter() - t0
    batches = -(-AL_POOL // SN)
    want = [5 * batches, 21 * batches, 2 * batches]
    picks = [s["dataset"]["train"]["labelled"] for _, s, _ in (one, dp)]
    timing = [[r for r in records if r["split"] == "al_timing"]
              for _, _, records in (one, dp)]
    splits = [sorted(r["split"] for r in records)
              for _, _, records in (one, dp)]
    launches = [r[2] for r in dp[0]]
    print(f"dp {phase} AL round ({DP_WORLD} ranks, {backend}): {secs:.1f} "
          f"s; picks {sorted(picks[1][8:])}, one process's "
          f"{sorted(picks[0][8:])}; launches front/mid/tail score by rank "
          f"{launches} (one process {one[0][0][2]}; expected {want} each); "
          f"al_timing one process "
          + ", ".join(f"{k} {timing[0][0][k]}" for k in
                      ("train_s", "score_select_s", "round_s"))
          + f"; {DP_WORLD} ranks "
          + ", ".join(f"{k} {timing[1][0][k]}" for k in
                      ("train_s", "score_select_s", "round_s")))
    if picks[0] != picks[1] or len(picks[1]) != 16 \
            or splits[0] != splits[1] \
            or any(r != want for r in launches + [one[0][0][2]]):
        raise AssertionError("the AL round's ranks picked otherwise than one "
                             "process, wrote other records or did not rank "
                             "the pool through #1, #3, #6")
    return {"launches": dict(zip(("front_score", "mid_score", "tail_score"),
                                 np.sum(launches, 0).tolist())),
            "timing": timing}


def one_rank_nccl(seed: int, rec: str):
    """Phase 15c: start the train CLI (AL_CONF, one epoch) in a world of
    one rank, which the backend rule puts on NCCL; returns what waits for
    it and checks it."""
    port_pkg = "semanticsegmentationactivelearning_tpu_torch"
    with open(AL_CONF) as fp:
        conf = json.load(fp)
    conf["epochs"] = 1
    tmp = tempfile.TemporaryDirectory()
    path, log = os.path.join(tmp.name, "conf.json"), \
        os.path.join(tmp.name, "log")
    with open(path, "w") as fp:
        json.dump(conf, fp)
    t0 = time.perf_counter()
    handles = start_ranks(f"{port_pkg}.train", 1, False,
                          ("cityscapes", "-d", rec, "-p", path, "--seed",
                           str(seed), "-l", log))

    def finish():
        with tmp:
            (stdout, writes, _), = wait_ranks(handles)
            with open(os.path.join(log, "metrics.jsonl")) as fp:
                splits = [json.loads(ln)["split"] for ln in fp]
        joined = [ln.split(": ", 1)[-1] for ln in stdout.splitlines()
                  if "backend" in ln]
        print(f"dp 15c train CLI (one rank, beside 15b's train CLI): "
              f"{time.perf_counter() - t0:.1f} s; {joined}; {writes} files "
              f"written; records {splits}")
        if "backend nccl" not in stdout \
                or "A world of one rank" not in stdout or not writes \
                or splits[-1] != "final_val":
            raise AssertionError("the one-rank NCCL world did not train")

    return finish


def multi_process(seed: int, rec: str) -> dict:
    """Phase 15 on phase 11's records ``rec``: 15a and 15b with the ranks
    sharing the card over Gloo, 15c; with two cards or more, 15a and 15b
    again over NCCL a card a rank and serving over two cards, else one
    line saying that this machine did not run them. Returns 15a's times,
    15b's launches (summed over the ranks) and al_timing."""
    t0 = time.perf_counter()
    out = {"step": check_dp_step(seed)}
    torch.cuda.empty_cache()
    out.update(run_dp_clis(seed, rec,
                           during=lambda: one_rank_nccl(seed, rec)))
    cards = torch.cuda.device_count()
    if cards >= 2:
        check_dp_step(seed, shared=False, phase="15c")
        nccl = run_dp_clis(seed, rec, shared=False, phase="15c")
        for k, v in nccl["launches"].items():
            out["launches"][k] += v
        serve_two_cards(seed)
    else:
        print(f"dp 15c: {cards} card on this machine: the two-card NCCL "
              f"route (15a and 15b a card a rank, serving over two cards) "
              f"was not run")
    print(f"dp: phase 15 in {time.perf_counter() - t0:.1f} s")
    return out


def serve_two_cards(seed: int) -> None:
    """Phase 15c on two cards or more: make_predict_fn over cuda:0 and
    cuda:1 (ENet-19, batch 2 at 1024x2048, a row a card) against cuda:0
    alone: the maps equal but on at most 1e-4 of the pixels, and each
    card's front, mid and tail predict launched once a batch."""
    from semanticsegmentationactivelearning_tpu_torch.inference import (
        make_predict_fn)
    from semanticsegmentationactivelearning_tpu_torch.models import get_model
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        front, mid, tail)
    model = get_model("ENet", CLASSES)
    model.load_state_dict(seeded_state_dict(model, seed))
    lut = torch.arange(256, dtype=torch.uint8)
    stack = torch.from_numpy(np.random.default_rng(seed + 70).integers(
        0, 256, (N, H, W, 3), dtype=np.uint8)).to("cuda:0")
    cards = [torch.device("cuda", i) for i in range(2)]
    want = make_predict_fn(model, lut, H, W, 3, cards[:1])(stack)
    wrappers = (front.fused_front_stage1, mid.fused_mid_stage23,
                tail.fused_tail_predict)
    for fn in wrappers:
        fn.launches = 0
    got = make_predict_fn(copy.deepcopy(model), lut, H, W, 3, cards)(stack)
    torch.cuda.synchronize()
    differ = (got != want).float().mean().item()
    launches = [fn.launches for fn in wrappers]
    print(f"dp 15c inference over 2 cards (batch {N}, {H}x{W}): maps "
          f"differ from one card's at {differ:.2e} of the pixels; launches "
          f"front/mid/tail {launches}")
    if differ > 1e-4 or launches != [front.LAUNCHES_PER_CALL * 2,
                                     mid.LAUNCHES_PER_CALL * 2,
                                     tail.LAUNCHES_PER_CALL * 2]:
        raise AssertionError("serving over two cards disagrees with one")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and the input batches")
    args = ap.parse_args(argv)
    t_main = time.perf_counter()

    def started(phase: int) -> None:
        print(f"phase {phase} starts at {time.perf_counter() - t_main:.1f} "
              f"s")

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from semanticsegmentationactivelearning_tpu_torch.models import (
        get_model)
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        build)

    started(2)
    # 2. build
    b = build.build()
    build.library()
    ptxas = [ln.strip() for ln in b.log.splitlines()
             if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    print(f"build: {b.seconds:.1f} s -> {b.path.name}")
    for ln in ptxas:
        print(f"  {ln}")
    for fn, count in hmma_counts(b.path).items():
        gated = any(k in fn for k in HMMA_GATED)
        if gated or any(k in fn for k in ("b10_kernel", "stage1_kernel",
                                          "tail", "b20_kernel",
                                          "proj_kernel", "block_kernel")):
            print(f"  SASS: {count} HMMA instructions in {fn}")
            if gated and not count:
                raise AssertionError(f"{fn} runs no tensor-core product")
    spills = ptxas_spills(b.log)
    head8 = {fn: n for fn, n in spills.items() if "head8_kernel" in fn}
    print(f"  head8_kernel: {len(head8)} instances, spill bytes "
          f"{sorted(head8.values())}")
    deconv = {fn: n for fn, n in spills.items()
              if "deconv_score_kernel" in fn}
    print(f"  deconv_score_kernel: {len(deconv)} instances, spill bytes "
          f"{sorted(deconv.values())}")
    spilled = {fn: n for fn, n in spills.items()
               if any(k in fn for k in NO_SPILLS) and n}
    if not b.log or spilled or len(head8) != 2 \
            or len(deconv) != DECONV_INSTANCES:
        raise AssertionError(f"ICNet front, head or deconv score kernels "
                             f"spill (or no ptxas log): {spilled}, {head8}, "
                             f"{deconv}")

    started(3)
    # 3. kernels against their plain versions
    state = seeded_state_dict(get_model("ENet", CLASSES), args.seed)
    model = get_model("ENet", CLASSES).cuda()
    model.load_state_dict(state)
    per_kernel = check_kernels(model, args.seed)

    started(4)
    # 4. the serving path
    launches, kernel_ms, plain_ms, served = serve(state, args.seed)
    launches = dict(zip(("front", "mid", "tail"), launches))
    run_cli(served, args.seed)
    del served, model
    torch.cuda.empty_cache()

    started(5)
    # 5. the scoring path
    per_kernel.update(check_score_kernels(args.seed))
    score_launches, score_ms, score_plain_ms = score_pool(args.seed)
    launches.update(score_launches)

    started(6)
    # 6. where the time goes
    torch.cuda.empty_cache()
    where_the_time_goes(args.seed)

    started(7)
    # 7. ICNet pool scoring
    torch.cuda.empty_cache()
    per_kernel.update(check_icnet_kernels(args.seed))
    torch.cuda.empty_cache()
    icnet_launches, icnet_ms, icnet_plain_ms = score_icnet_pool(args.seed)
    launches.update(icnet_launches)
    torch.cuda.empty_cache()
    profile_icnet(args.seed)

    started(8)
    # 8. ICNet serving
    torch.cuda.empty_cache()
    per_kernel.update(check_icnet_predict_kernels(args.seed))
    torch.cuda.empty_cache()
    serve_launches, icnet_serve_ms, icnet_serve_plain_ms, icnet = \
        serve_icnet(args.seed)
    launches.update(serve_launches)
    run_cli(icnet, args.seed, "ICNet", sizes=(None, (H // 2, W // 2)))
    profile_icnet_serving(icnet)
    del icnet

    started(9)
    # 9. the rigs
    torch.cuda.empty_cache()
    rig_results, rig_launches = run_rigs(args.seed)
    per_kernel.update(rig_results)
    launches.update(rig_launches)

    started(10)
    # 10. training
    torch.cuda.empty_cache()
    check_train_step(args.seed)
    torch.cuda.empty_cache()
    train = train_speed(args.seed)
    torch.cuda.empty_cache()
    profile_training(args.seed)
    torch.cuda.empty_cache()
    run_train_cli(args.seed)

    started(11)
    # 11. the active-learning loop
    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    check_pseudo_step(args.seed)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        rec = os.path.join(tmp, "rec")
        # the CLI holds out the first 4 (sorted) train records for
        # validation; 11b scores the pool the CLI ranks
        write_records(rec, args.seed + 40, 2 * TH, 2 * TW,
                      train=AL_POOL + 4, val=4)
        pool = sorted(os.path.join(rec, "train", f)
                      for f in os.listdir(os.path.join(rec, "train")))[4:]
        al_launches, al_ips = al_pool_pass(args.seed, pool, score_ms)
        for k, v in al_launches.items():
            launches[k] += v
        torch.cuda.empty_cache()
        run_al_cli(args.seed, rec)
        print(f"al: phase 11 in {time.perf_counter() - t11:.1f} s")

        started(12)
        # 12. secondary acquisition
        torch.cuda.empty_cache()
        t12 = time.perf_counter()
        mc_errs = check_mc_step(args.seed)
        torch.cuda.empty_cache()
        mc = mc_speed(args.seed)
        torch.cuda.empty_cache()
        kc_ms = check_kcenter(args.seed)
        secondary = run_secondary_cli(args.seed, rec, name)
        print(f"secondary: phase 12 in {time.perf_counter() - t12:.1f} s")

        started(13)
        # 13. ICNet's training
        torch.cuda.empty_cache()
        t13 = time.perf_counter()
        icnet_confs = {"icnet": ICNET_CONF}
        icnet_errs = check_train_step(args.seed, icnet_confs, ICNET_CHECK_HW,
                                      "13a")
        torch.cuda.empty_cache()
        icnet_train = train_speed(args.seed, icnet_confs, (IH, IW), (IH, IW),
                                  ("icnet",), ICNET_LEARN_STEPS,
                                  "13b")["icnet"]
        torch.cuda.empty_cache()
        icnet_busy = profile_training(args.seed, icnet_confs, (IH, IW),
                                      (IH, IW))["icnet"]
        torch.cuda.empty_cache()
        # 13d's train and inference children run beside 13e's AL children
        icnet_al_launches, icnet_al, icnet_cli_launches = run_icnet_al_cli(
            args.seed, rec, name, during=lambda: run_train_cli(
                args.seed, ICNET_CONF, (IH, IW), "13d"))
        for k, v in {**icnet_al_launches, **icnet_cli_launches}.items():
            launches[k] += v
        print(f"icnet train: phase 13 in {time.perf_counter() - t13:.1f} s")

        started(14)
        # 14. Freiburg multi-modal and the migration entries
        torch.cuda.empty_cache()
        t14 = time.perf_counter()
        with tempfile.TemporaryDirectory() as fb_tmp:
            fb_rec = freiburg_etl(args.seed, fb_tmp)
            fb = check_freiburg(args.seed)
            torch.cuda.empty_cache()
            fb_launches_al, fb_timing = run_freiburg_clis(args.seed, fb_rec,
                                                          fb_tmp)
            launches["decoder_score"] += fb_launches_al
        torch.cuda.empty_cache()
        for k, v in check_importer(args.seed).items():
            launches[k] += v
        print(f"freiburg: phase 14 in {time.perf_counter() - t14:.1f} s")

        started(15)
        # 15. multi-process runs, on phase 11's records
        torch.cuda.empty_cache()
        dp = multi_process(args.seed, rec)
        for k, v in dp["launches"].items():
            launches[k] += v

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in JAX_SIDE)
    if leaked:
        raise AssertionError(f"imported JAX or the JAX package: {leaked}")

    kernels = []
    for k, (source, replaces) in KERNELS.items():
        r = per_kernel[k]
        if launches[k] < 1:
            raise AssertionError(f"{k} was never launched on its path")
        kernels.append(dict(
            name=k, route="cuda", source=source, replaces=replaces,
            launches=launches[k], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None))
    print(f"chain: kernel {kernel_ms:.3f} ms/batch, plain {plain_ms:.3f} "
          f"ms/batch (batch {N}, {H}x{W}, ENet-{CLASSES}; {smi})")
    print(f"score: kernel {score_ms:.3f} ms/batch, plain {score_plain_ms:.3f}"
          f" ms/batch (batch {SN}, {SH}x{SW}, ENet-{CLASSES}; {smi})")
    print(f"icnet score: kernel {icnet_ms:.3f} ms/batch, plain "
          f"{icnet_plain_ms:.3f} ms/batch (batch {IN}, {IH}x{IW}, "
          f"ICNet-{CLASSES}; {smi})")
    print(f"icnet serve: kernel {icnet_serve_ms:.3f} ms/batch, plain "
          f"{icnet_serve_plain_ms:.3f} ms/batch (batch {N}, {H}x{W}, "
          f"ICNet-{CLASSES}; {smi})")
    for conf, r in train.items():
        print(f"train {conf}: {r['ms']:.3f} ms/step, "
              f"{r['images_per_s']:.1f} images/s (batch {TB}, {TH}x{TW}, "
              f"ENet-{CLASSES}, {TRAIN_CONFS[conf]}; {smi})")
    print(f"al pool pass: {al_ips:.1f} images/s with decode, H2D and "
          f"selection (batch {SN}, {SH}x{SW} crops of 1024x2048 records, "
          f"ENet-{CLASSES}; {smi})")
    print(f"bald MC pool pass: {mc['mc']:.1f} images/s on the device, "
          f"device busy {100 * mc['busy']:.1f}% (profiler on); masks a "
          f"forward " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                          mc["masks"].items())
          + f"; |card - CPU| fp32 {mc_errs['fp32']:.3e}, TF32 "
          f"{mc_errs['default']:.3e} (batch {SN}, {SH}x{SW}, {MC_PASSES} "
          f"passes, ENet-{CLASSES}; {smi})")
    print(f"coreset: embed pass {mc['embed']:.1f} images/s on the device; "
          f"k_center_greedy {kc_ms:.3f} ms (N {KC_N}, D {KC_D}, k {KC_K}; "
          f"{smi})")
    for conf, timing in secondary.items():
        print(f"al {conf} round: " + ", ".join(
            f"{k} {timing[0][k]}" for k in ("train_s", "score_select_s",
                                            "round_s"))
            + f" (cut {SECONDARY_CONFS[conf]}, 32 + 4 records; {smi})")
    fp32 = icnet_errs[("icnet", "fp32", STATS_REF)]
    tf32 = icnet_errs[("icnet", "default", STATS_REF)]
    print(f"icnet train: {icnet_train['ms']:.3f} ms/step, "
          f"{icnet_train['images_per_s']:.1f} images/s, device busy "
          f"{100 * icnet_busy:.1f}% (profiler on) (batch {TB}, {IH}x{IW}, "
          f"ICNet-{CLASSES}, {ICNET_CONF}); 13a against the CPU float64 at "
          f"{ICNET_CHECK_HW[0]}x{ICNET_CHECK_HW[1]}: fp32 loss "
          f"{fp32['loss']:.3e}, gradients {fp32['grad']:.3e}, BN statistics "
          f"{fp32['stats']:.3e}; TF32 {tf32['loss']:.3e}, {tf32['grad']:.3e}, "
          f"{tf32['stats']:.3e} ({smi})")
    for conf, timing in icnet_al.items():
        print(f"al icnet {conf} round: " + ", ".join(
            f"{k} {timing[0][k]}" for k in ("train_s", "score_select_s",
                                            "round_s"))
            + f" (cut {AL_CONF} made ICNet's, 32 + 4 records; {smi})")
    r = fb["decoder_score"]
    print(f"freiburg: decoder_score (#7) {r['ms']:.3f} ms, plain "
          f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
          f"({r['bound_by']}), max |k-p| {r['max_abs_err']:.3e}; "
          f"{fb_launches_al} launches in the AL pool pass; train "
          f"{fb['train_ms']:.3f} ms/step; al round " + ", ".join(
              f"{k} {fb_timing[0][k]}" for k in ("train_s", "score_select_s",
                                                 "round_s"))
          + f" (batch {FN}, {FH}x{FW}, ENet-{FB_CLASSES}, {FB_PLANES} "
          f"planes, {FB_CONF}; {smi})")
    st = dp["step"]
    print(f"dp: train step (15a, ENet-{CLASSES} {DP_CONF}, batch {TB} at "
          f"{TH}x{TW}, TF32 off) one process {st['ms']:.1f} ms/step, "
          f"{DP_WORLD} ranks sharing the card ({st['backend']}) "
          f"{[round(v, 1) for v in st['rank_ms']]} ms/step, the gradient "
          f"all-reduce {[round(v, 2) for v in st['reduce_ms']]} ms; AL round "
          f"(15b) one process " + ", ".join(
              f"{k} {dp['timing'][0][0][k]}" for k in
              ("train_s", "score_select_s", "round_s"))
          + f", {DP_WORLD} ranks " + ", ".join(
              f"{k} {dp['timing'][1][0][k]}" for k in
              ("train_s", "score_select_s", "round_s")) + f" ({smi})")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
