"""The ENet front's time on a CUDA device and its split by launch, at the
serving shape (batch 2, 1024x2048) and the scoring shape (batch 8,
512x1024), with the seeded ENet-19 of ``chip_smoke.py``.

    python semanticsegmentationactivelearning_tpu_torch/tools/probe_front.py \\
        [--root DIR] [--iters 5] [--seed 0]

``--root`` imports the port (and ``chip_smoke.py``) from another
checkout of the repo, e.g. the parent commit unpacked with ``git
archive``, so that two versions are timed on one card by running this
script once for each. Times the front as its wrapper launches it, on
each route where the front has routes (``front.PRECISION``), with its
max |error| against the plain version. Where the front has the
tensor-core design (``ssal_front_block``), also its split
(:func:`front_split`): ``b10_kernel`` (Initial + B1_0) and each stage-1
bottleneck's ``stage1_kernel``, each launch's output against its plain
part. Prints the
ptxas lines and SASS HMMA counts of the front's kernels, one line per
time (CUDA events, median of ``--iters`` after a warm-up) and a JSON
object of them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

SHAPES = {"serve": (2, 1024, 2048), "score": (8, 512, 1024)}
# multiply-adds per quarter-res position: Initial (4 phases x 13 x 27),
# B1_0 (2x2/s2 projection 64 x 8, 3x3 72 x 8, expand 8 x 64) and a
# stage-1 bottleneck (projection 64 x 16, 3x3 144 x 16, expand 16 x 64)
INITIAL_MACS = 4 * 13 * 27
B10_MACS = 64 * 8 + 72 * 8 + 8 * 64
BLOCK_MACS = 64 * 16 + 144 * 16 + 16 * 64


def front_flops(n: int, hq: int, wq: int) -> float:
    """The front's least FLOPs: two a multiply-add."""
    return 2.0 * (INITIAL_MACS + B10_MACS + 4 * BLOCK_MACS) * n * hq * wq


def front_split(front, model, image, score: bool, iters: int) -> dict:
    """Each launch of the front alone on inputs of the main path's
    shapes: ``b10`` (image -> x, mask1), and each stage-1 bottleneck
    ``b1_{i}`` on its plain input, ``blocks`` their sum, with the max
    |error| of each launch's output against its plain part (``b10_err``,
    ``blocks_err``, the largest of the four)."""
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        build)
    from semanticsegmentationactivelearning_tpu_torch.tools import rigs
    lib = build.library()
    pack = model.packed("front", image.device, front.pack_front)
    n, h, w, _ = image.shape
    hq, wq = h // 4, w // 4
    s = int(score)
    stream = build.stream_of(image)
    x = torch.empty((n, hq, wq, 64), device=image.device)
    mask1, y = torch.empty_like(x), torch.empty_like(x)

    def b10():
        build.check(lib.ssal_front_b10(build.ptr(image), build.ptr(pack),
                                       build.ptr(x), build.ptr(mask1), n, h,
                                       w, s, stream), "front B1_0")

    def block(xin, index):
        build.check(lib.ssal_front_block(
            build.ptr(xin), build.ptr(pack), build.ptr(y), n, hq, wq, index,
            s, stream), "front stage-1")

    res = dict(b10=rigs.cuda_ms(b10, iters))
    want, _ = front.b10_plain(image, model)
    res["b10_err"] = (x - want).abs().max().item()
    res["blocks"], res["blocks_err"] = 0.0, 0.0
    for i in range(front.STAGE1_BLOCKS):
        res[f"b1_{i + 1}"] = rigs.cuda_ms(lambda: block(want, i), iters)
        res["blocks"] += res[f"b1_{i + 1}"]
        want = front.block_plain(want, model, i)
        res["blocks_err"] = max(res["blocks_err"],
                                (y - want).abs().max().item())
    res["total"] = res["b10"] + res["blocks"]
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="checkout to import the port from")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, root)
    import numpy as np
    import chip_smoke
    from semanticsegmentationactivelearning_tpu_torch.models import (
        get_model)
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        build, front)
    from semanticsegmentationactivelearning_tpu_torch.tools import rigs

    rigs.require_cuda()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    b = build.build()
    lib = build.library()
    print(f"root {root}: build {b.seconds:.1f} s")
    lines = b.log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and any(
                k in ln for k in ("front_kernel", "b10_kernel",
                                  "stage1_kernel")):
            for nxt in lines[i:i + 4]:
                if "registers" in nxt or "spill" in nxt or nxt is ln:
                    print(f"  {nxt.strip()}")
    for fn, count in chip_smoke.hmma_counts(b.path).items():
        if "b10_kernel" in fn or "stage1_kernel" in fn:
            print(f"  SASS: {count} HMMA instructions in {fn}")
    model = get_model("ENet", chip_smoke.CLASSES)
    model.load_state_dict(chip_smoke.seeded_state_dict(model, args.seed))
    model = model.cuda().eval()
    routes = ((False, True) if hasattr(front, "PRECISION") else (False,))
    split = hasattr(lib, "ssal_front_block")
    res = {}
    for label, (n, h, w) in SHAPES.items():
        rng = np.random.default_rng(args.seed + 1)
        image = torch.from_numpy(rng.integers(
            0, 256, (n, h, w, 3), dtype=np.uint8)).cuda().float() / 255.0
        with torch.no_grad():
            x1, _ = front.front_stage1_plain(image, model)
            flops = front_flops(n, h // 4, w // 4)
            for score in routes:
                route = "score" if score else "predict"
                kw = dict(score=True) if score else {}
                err = (front.fused_front_stage1(image, model, **kw)[0]
                       - x1).abs().max().item()
                ms = rigs.cuda_ms(
                    lambda: front.fused_front_stage1(image, model, **kw),
                    args.iters)
                res[f"{label}/front_{route}"] = ms
                print(f"{label} (batch {n}, {h}x{w}) front {route}: "
                      f"{ms:.3f} ms, {flops / ms / 1e9:.1f} TFLOP/s of "
                      f"least work ({flops / 1e9:.2f} GFLOP), max|k-p| "
                      f"{err:.3e} (max {x1.abs().max().item():.3e})")
                if split:
                    sp = front_split(front, model, image, score, args.iters)
                    for k, v in sp.items():
                        res[f"{label}/{route}/{k}"] = v
                    print(f"  split ({route}): " + ", ".join(
                        f"{k} {v:.3e}" if k.endswith("err") else
                        f"{k} {v:.3f}" for k, v in sp.items()))
            del image, x1
            torch.cuda.empty_cache()
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
