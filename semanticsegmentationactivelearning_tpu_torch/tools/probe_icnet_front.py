"""ICNet's front kernels on a CUDA device, their launches and the
designs tried, at ICNet's scoring shape (batch 8, 1024x2048, the score
route) and serving shape (batch 2, 1024x2048, the predict route), with
the seeded ICNet-19 of ``chip_smoke.py`` (classifier x5).

    python semanticsegmentationactivelearning_tpu_torch/tools/probe_icnet_front.py \\
        [--root DIR] [--iters 5] [--seed 0]

``--root`` imports the port (and ``chip_smoke.py``) from another
checkout of the repo, e.g. the parent commit unpacked with ``git
archive``, so that two versions are timed on one card by running this
script once for each. For each route: the front + stem and the front as
their wrappers launch them (ms, TFLOP/s of least work, each output's max
|error| over its maximum against the plain version) and, where the
front has the tensor-core design (``icnet_front.launch_part``), each
launch alone (``PARTS``; the stem's conv1_3 + pool on the plain conv1_2
output) and the sum of the front + stem's (Branch1's and
``STEM_PARTS``). PERF.md keeps the designs of the front + stem that it
compared. Then ICNet
scoring's three routes end to end (``ICNet.fused_score``: the default,
``fuse_cff2=False``, ``fuse_stem=False``) at batch 8. Prints the ptxas
lines and SASS HMMA counts of the front kernels, one line per time (CUDA
events, median of ``--iters`` after a warm-up) and a JSON object of them.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

import torch

SHAPES = {"score": (8, 1024, 2048), "predict": (2, 1024, 2048)}
ROUTES = {"default": {}, "no_cff2": dict(fuse_cff2=False),
          "no_stem": dict(fuse_stem=False)}
# the front kernels' names in the library (the tensor-core design's and
# the fp32 one's)
NAMES = ("branch1_kernel", "stem12_kernel", "stem3_kernel",
         "icnet_front_kernel")


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
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        build, icnet_front)
    from semanticsegmentationactivelearning_tpu_torch.tools import rigs

    rigs.require_cuda()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    b = build.build()
    build.library()
    print(f"root {root}: build {b.seconds:.1f} s")
    lines = b.log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and any(k in ln for k in NAMES):
            for nxt in lines[i:i + 4]:
                if "registers" in nxt or "spill" in nxt or nxt is ln:
                    print(f"  {nxt.strip()}")
    for fn, count in chip_smoke.hmma_counts(b.path).items():
        if any(k in fn for k in NAMES):
            print(f"  SASS: {count} HMMA instructions in {fn}")
    model = chip_smoke.score_model(args.seed, chip_smoke.ICNET_CLS_SCALE,
                                   "ICNet")
    routed = "score" in inspect.signature(
        icnet_front.fused_icnet_front_stem).parameters
    parts = hasattr(icnet_front, "launch_part")
    res = {}
    for route, (n, h, w) in SHAPES.items():
        score = route == "score"
        kw = dict(score=score) if routed else {}
        rng = np.random.default_rng(args.seed + 6)
        image = torch.from_numpy(rng.integers(
            0, 256, (n, h, w, 3), dtype=np.uint8)).cuda().float() / 255.0
        with torch.no_grad():
            f1, x_half = icnet_front.icnet_front_plain(image, model)
            stem = model.SharedStem
            c12 = stem.conv1_2(stem.conv1_1(x_half))
            want = dict(f1=f1, x_half=x_half, stem1=stem.front(x_half))
            # least work: the convs and the downsample's 16 taps x 3
            # channels a half-res pixel
            down = 32.0 * 3 * n * (h // 2) * (w // 2)
            branch1 = chip_smoke.count_flops(lambda im, m: m.branch1(im),
                                             (image, model))
            flops = {"front_stem": chip_smoke.count_flops(
                icnet_front.icnet_front_stem_plain, (image, model)) + down,
                "front": branch1 + down}

            def rel(got, names):
                return ", ".join(
                    f"{k} {(g - want[k]).abs().max() / want[k].abs().max():.2e}"
                    for k, g in zip(names, got))

            for entry, fn, names in (
                    ("front_stem", icnet_front.fused_icnet_front_stem,
                     ("f1", "stem1")),
                    ("front", icnet_front.fused_icnet_front,
                     ("f1", "x_half"))):
                run = lambda: fn(image, model, **kw)
                ms = rigs.cuda_ms(run, args.iters)
                res[f"{route}/{entry}"] = ms
                print(f"{route} (batch {n}, {h}x{w}) {entry}: {ms:.3f} ms, "
                      f"{flops[entry] / ms / 1e9:.1f} TFLOP/s of least work "
                      f"({flops[entry] / 1e9:.2f} GFLOP); max|k-p| / max "
                      f"{rel(run(), names)}")
            if parts:
                ins = {p: (c12 if p == "stem3" else image)
                       for p in icnet_front.PARTS}
                for part in icnet_front.PARTS:
                    go = lambda: icnet_front.launch_part(
                        part, ins[part], model, score, (h, w))
                    ms = rigs.cuda_ms(go, args.iters)
                    res[f"{route}/part/{part}"] = ms
                    print(f"  {part} alone: {ms:.3f} ms")
                seq = ("branch1",) + icnet_front.STEM_PARTS
                ms = sum(res[f"{route}/part/{p}"] for p in seq)
                res[f"{route}/parts_sum"] = ms
                print(f"  front + stem's launches {' + '.join(seq)}: "
                      f"{ms:.3f} ms, {flops['front_stem'] / ms / 1e9:.1f} "
                      f"TFLOP/s of least work")
        del image, f1, x_half, c12, want
        torch.cuda.empty_cache()

    # ICNet scoring's routes end to end, at batch 8
    n, h, w = SHAPES["score"]
    rng = np.random.default_rng(args.seed + 7)
    image = torch.from_numpy(rng.integers(
        0, 256, (n, h, w, 3), dtype=np.uint8)).cuda().float() / 255.0
    with torch.no_grad():
        for name, kw in ROUTES.items():
            ms = rigs.cuda_ms(
                lambda: model.fused_score(image, "entropy", **kw), args.iters)
            res[f"route/{name}"] = ms
            print(f"ICNet scoring route {name} {kw}: {ms:.3f} ms/batch "
                  f"(batch {n}, {h}x{w})")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
