"""The ENet mid's time on a CUDA device and its split by launch, at the
serving shape (batch 2, 1024x2048) and the scoring shape (batch 8,
512x1024), with the seeded ENet-19 of ``chip_smoke.py``.

    python semanticsegmentationactivelearning_tpu_torch/tools/probe_mid.py \\
        [--root DIR] [--iters 5] [--seed 0]

``--root`` imports the port (and ``chip_smoke.py``) from another
checkout of the repo, e.g. the parent commit unpacked with ``git
archive``, so that two versions are timed on one card by running this
script once for each. Times the mid as its wrapper launches it, on each
route where the mid has routes (``mid.PRECISION``), and its max |error|
against the plain version. Where the mid has the tensor-core design
(``ssal_mid_block``), also its split (:func:`mid_split`): B2_0, the
projection launches, the fused and the unfused spatial launches, and
each dilated block both ways up to the largest fusable dilation, which
is what ``mid.FUSE_MAX_DILATION`` is chosen by. Prints the ptxas lines
of the mid's kernels, one line per time (CUDA events, median of
``--iters`` after a warm-up) and a JSON object of them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

SHAPES = {"serve": (2, 1024, 2048), "score": (8, 512, 1024)}
# the dilations of DILATED_SPEC whose halo a fused block can hold
# (csrc/mid.cu MAX_FUSED_HALO)
FUSABLE_DILATIONS = (1, 2, 4)
# multiply-adds per eighth-res position: B2_0 (2x2/s2 projection 256 x
# 32, 3x3 288 x 32, expand 32 x 128) and a stage-2/3 block (projection
# 128 x 32, dilated 3x3 288 x 32 or 5x1 + 1x5 2 x 160 x 32, expand)
B20_MACS = 256 * 32 + 288 * 32 + 32 * 128


def block_macs(asymmetric: bool) -> int:
    return 128 * 32 + (320 if asymmetric else 288) * 32 + 32 * 128


def mid_flops(n: int, h8: int, w8: int) -> float:
    """The mid's least FLOPs: two a multiply-add."""
    from semanticsegmentationactivelearning_tpu_torch.models.enet import (
        DILATED_SPEC)
    per = B20_MACS + 2 * sum(block_macs(a) for _, a in DILATED_SPEC)
    return 2.0 * per * n * h8 * w8


def mid_split(mid, model, x1, y, score: bool, iters: int) -> dict:
    """Each launch of the mid alone on inputs of the main path's shapes
    (x1, and the plain mid's y as every block's input), summed by kind:
    ``b20``, ``proj`` (the unfused blocks' projections), ``fused`` and
    ``unfused`` (the spatial launches), and a dilated block at each
    fusable dilation d, ``d{d}_fused`` and ``d{d}_unfused`` (projection
    + spatial launch)."""
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        build)
    from semanticsegmentationactivelearning_tpu_torch.tools import rigs
    lib = build.library()
    packs = model.packed("mid", x1.device, mid.pack_mid)
    n, h8, w8, _ = y.shape
    out = torch.empty_like(y)
    sw2 = torch.empty((n, h8, w8, 64), dtype=torch.int8, device=y.device)
    proj = torch.empty((n, h8, w8, 32), device=y.device)
    stream = build.stream_of(y)
    s = int(score)

    def b20():
        build.check(lib.ssal_mid_b20(build.ptr(x1), build.ptr(packs[0]),
                                     build.ptr(out), build.ptr(sw2), n, h8,
                                     w8, s, stream), "mid B2_0")

    def project(pack):
        build.check(lib.ssal_mid_proj(build.ptr(y), build.ptr(pack),
                                      build.ptr(proj), n * h8 * w8, s,
                                      stream), "mid projection")

    def block(pack, d, asym, fuse):
        build.check(lib.ssal_mid_block(
            build.ptr(y), None if fuse else build.ptr(proj),
            build.ptr(pack), build.ptr(out), n, h8, w8, d, int(asym), s,
            stream), "mid block")

    res = dict(b20=rigs.cuda_ms(b20, iters), proj=0.0, fused=0.0,
               unfused=0.0)
    for blk, pack in zip(model.blocks(model.stage23), packs[1:]):
        d, asym = blk.dilation, blk.asymmetric
        fuse = mid.fused(d, asym)
        if not fuse:
            res["proj"] += rigs.cuda_ms(lambda: project(pack), iters)
        res["fused" if fuse else "unfused"] += rigs.cuda_ms(
            lambda: block(pack, d, asym, fuse), iters)
    pack = packs[2]  # Bottleneck2_2, a dilated block
    for d in FUSABLE_DILATIONS:
        res[f"d{d}_fused"] = rigs.cuda_ms(
            lambda: block(pack, d, False, True), iters)
        res[f"d{d}_unfused"] = rigs.cuda_ms(
            lambda: (project(pack), block(pack, d, False, False)), iters)
    res["total"] = res["b20"] + res["proj"] + res["fused"] + res["unfused"]
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
        build, front, mid)
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
                k in ln for k in ("b20_kernel", "proj_kernel",
                                  "block_kernel", "conv_kernel")):
            for nxt in lines[i:i + 4]:
                if "registers" in nxt or "spill" in nxt or nxt is ln:
                    print(f"  {nxt.strip()}")
    model = get_model("ENet", chip_smoke.CLASSES)
    model.load_state_dict(chip_smoke.seeded_state_dict(model, args.seed))
    model = model.cuda().eval()
    routes = ((False, True) if hasattr(mid, "PRECISION") else (False,))
    split = hasattr(lib, "ssal_mid_block")
    res = {}
    for label, (n, h, w) in SHAPES.items():
        rng = np.random.default_rng(args.seed + 1)
        image = torch.from_numpy(rng.integers(
            0, 256, (n, h, w, 3), dtype=np.uint8)).cuda().float() / 255.0
        with torch.no_grad():
            x1, _ = front.front_stage1_plain(image, model)
            del image
            y, _ = mid.mid_stage23_plain(x1, model)
            flops = mid_flops(n, h // 8, w // 8)
            for score in routes:
                route = "score" if score else "predict"
                kw = dict(score=True) if score else {}
                err = (mid.fused_mid_stage23(x1, model, **kw)[0] - y).abs()
                ms = rigs.cuda_ms(
                    lambda: mid.fused_mid_stage23(x1, model, **kw),
                    args.iters)
                res[f"{label}/mid_{route}"] = ms
                print(f"{label} (batch {n}, {h}x{w}) mid {route}: {ms:.3f} "
                      f"ms, {flops / ms / 1e9:.1f} TFLOP/s of least work "
                      f"({flops / 1e9:.2f} GFLOP), max|k-p| "
                      f"{err.max().item():.3e} (max "
                      f"{y.abs().max().item():.3e})")
                if split:
                    sp = mid_split(mid, model, x1, y, score, args.iters)
                    for k, v in sp.items():
                        res[f"{label}/{route}/{k}"] = v
                    print(f"  split ({route}): " + ", ".join(
                        f"{k} {v:.3f}" for k, v in sp.items()))
            del x1, y
            torch.cuda.empty_cache()
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
