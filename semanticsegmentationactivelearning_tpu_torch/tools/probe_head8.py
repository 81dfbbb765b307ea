"""ICNet's head kernel (``head8_kernel``) on a CUDA device, on both
routes: score at batch 8 and predict at batch 2, 1024x2048, with the
seeded ICNet-19 of ``chip_smoke.py`` (classifier x5) on the plain
chain's fused8; beside it the CFF2 + head kernel, which shares the
head, on the plain chain's fused16 and f1.

    python semanticsegmentationactivelearning_tpu_torch/tools/probe_head8.py \\
        [--root DIR] [--tile RxCxTxB ...] [--iters 5] [--seed 0]

``--root`` imports the port (and ``chip_smoke.py``) from another
checkout of the repo, e.g. the parent commit unpacked with ``git
archive``, so that two versions are timed on one card by running this
script once for each. For each route: the head kernel as its wrapper
launches it and the CFF2 + head kernel (ms, TFLOP/s of least work, the
max |score difference| or the decided labels that differ from the plain
version). Each ``--tile`` (R x C eighth-res positions a block, T
threads, at least B blocks an SM) builds ``csrc/icnet_head.cu`` of this
checkout with that tile in place of its own (the line ``constexpr int
HR = .., HC = .., HEAD8_THREADS = .., HEAD8_BLOCKS = ..;``) into
``build/probe_head8/`` and times its head kernel the same way. Prints
the card, the ptxas lines and SASS HMMA counts of the head kernels, one
line per time (CUDA events, median of ``--iters`` after a warm-up) and a
JSON object of them.
"""

from __future__ import annotations

import argparse
import json
import os
import runpy
import subprocess
import sys
from pathlib import Path

import torch

SHAPES = {"score": (8, 1024, 2048), "predict": (2, 1024, 2048)}
TILE_LINE = (r"constexpr int HR = \d+, HC = \d+, HEAD8_THREADS = \d+, "
             r"HEAD8_BLOCKS = \d+;")
HEAD8_ENTRIES = ("ssal_head8_partials", "ssal_head8_score",
                 "ssal_head8_predict")


def launch(lib, build, route, f8, wcls, bcls, c):
    """One launch of ``lib``'s head kernel: the scores or the labels."""
    n, h8, w8, _ = f8.shape
    args = (build.ptr(f8), build.ptr(wcls), build.ptr(bcls))
    stream = build.stream_of(f8)
    if route == "score":
        parts = torch.empty((n, lib.ssal_head8_partials(h8, w8)),
                            device=f8.device)
        build.check(lib.ssal_head8_score(*args, build.ptr(parts), n, h8, w8,
                                         c, stream), "head8 score")
        return parts.sum(dim=1) / float(64 * h8 * w8)
    labels = torch.empty((n, 8 * h8, 8 * w8), dtype=torch.int8,
                         device=f8.device)
    build.check(lib.ssal_head8_predict(*args, build.ptr(labels), n, h8, w8,
                                       c, stream), "head8 predict")
    return labels


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="checkout to import the port from")
    ap.add_argument("--tile", nargs="*", default=[], metavar="RxCxTxB",
                    help="head kernel tiles to build and time besides the "
                         "checkout's own")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, root)
    import numpy as np
    import chip_smoke
    from semanticsegmentationactivelearning_tpu_torch.ops import nn as xops
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        build, icnet_front, icnet_head)
    from semanticsegmentationactivelearning_tpu_torch.tools import rigs

    rigs.require_cuda()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    b = build.build()
    build.library()
    print(f"root {root}: build {b.seconds:.1f} s")
    # this checkout's tile builds, whichever checkout --root names
    tb = runpy.run_path(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tile_builds.py"))
    for ln in tb["ptxas_lines"](b.log, ("head8",)):
        print(f"  {ln}")
    for fn, count in chip_smoke.hmma_counts(b.path).items():
        if "head8" in fn:
            print(f"  SASS: {count} HMMA instructions in {fn}")
    libs = tb["tile_libraries"](
        build, "icnet_head.cu", TILE_LINE,
        lambda tile: "constexpr int HR = {}, HC = {}, HEAD8_THREADS = {}, "
        "HEAD8_BLOCKS = {};".format(*tile.split("x")), HEAD8_ENTRIES,
        args.tile, Path(root) / "build" / "probe_head8")
    for tile, (_, log) in libs.items():
        print(f"tile {tile}:")
        for ln in tb["ptxas_lines"](log, ("head8",)):
            print(f"  {ln}")
    model = chip_smoke.score_model(args.seed, chip_smoke.ICNET_CLS_SCALE,
                                   "ICNet")
    c = chip_smoke.CLASSES
    res = {}
    for route, (n, h, w) in SHAPES.items():
        score = route == "score"
        h8, w8 = h // 8, w // 8
        rng = np.random.default_rng(args.seed + 6)
        image = torch.from_numpy(rng.integers(
            0, 256, (n, h, w, 3), dtype=np.uint8)).cuda().float() / 255.0
        with torch.no_grad():
            f1, x_half = icnet_front.icnet_front_plain(image, model)
            fused16 = model.fuse_to_cff1(model.SharedStem.front(x_half))
            fused8 = model.CFF2(fused16, f1)[0]
            wcls, bcls = model.packed("classifier", image.device,
                                      icnet_head.pack_classifier)
            if score:
                head = chip_smoke.icnet_head_flops(n, h8, w8, c)
                want = icnet_head.head8_entropy_score_plain(fused8, wcls,
                                                            bcls, c)
                err = lambda got: (got - want).abs().max().item()
                head_kernel = lambda: icnet_head.fused_head8_entropy_score(
                    fused8, wcls, bcls, c)
                cff2 = lambda: icnet_head.fused_cff2_head8_entropy_score(
                    fused16, f1, model)
            else:
                head = chip_smoke.icnet_head_predict_flops(n, h8, w8, c)
                logits = xops.resize_bilinear(model.head_pre_logits(fused8),
                                              (h, w))
                labels, decided = chip_smoke.decided_labels(logits, 1e-3)
                del logits
                err = lambda got: int(((got.long() != labels)
                                       & decided).sum().item())
                head_kernel = lambda: icnet_head.fused_head8_predict(
                    fused8, wcls, bcls, c)
                cff2 = lambda: icnet_head.fused_cff2_head8_predict(
                    fused16, f1, model)
            what = "max|k-p| score" if score else "decided labels differ"
            cases = {"head8_kernel": (head_kernel, head)}
            for tile, (lib, _) in libs.items():
                cases[f"head8_kernel {tile}"] = (
                    lambda lib=lib: launch(lib, build, route, fused8, wcls,
                                           bcls, c), head)
            cases["cff2_head_kernel"] = (
                cff2, head + chip_smoke.cff2_flops(n, h8, w8))
            for name, (fn, flops) in cases.items():
                ms = rigs.cuda_ms(fn, args.iters)
                res[f"{route}/{name}"] = ms
                print(f"{route} (batch {n}, {h}x{w}) {name}: {ms:.3f} ms, "
                      f"{flops / ms / 1e9:.1f} TFLOP/s of least work, "
                      f"{what} {err(fn())}")
        del image, f1, x_half, fused16, fused8
        if not score:
            del labels, decided
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
