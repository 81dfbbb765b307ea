"""ICNet's CFF2 + head kernel on a CUDA device and its split, at ICNet's
scoring shape (batch 8, 1024x2048, the score route)
and serving shape (batch 2, 1024x2048, the predict route), with the
seeded ICNet-19 of ``chip_smoke.py`` (classifier x5) on the plain
chain's activations.

    python semanticsegmentationactivelearning_tpu_torch/tools/probe_cff2.py \\
        [--root DIR] [--iters 5] [--seed 0]

``--root`` imports the port (and ``chip_smoke.py``) from another
checkout of the repo, e.g. the parent commit unpacked with ``git
archive``, so that two versions are timed on one card by running this
script once for each. For each route: the kernel as its wrapper
launches it (ms, TFLOP/s of least work, the max |score difference| or
the decided labels that differ from the plain version), the head
kernel (``head8_kernel``) on the plain fused8, and where the kernel has
the tensor-core design (``icnet_head.launch_cff2``) its split: the GEMM
alone (fused8 at the route's precision, its max |error|) and the head
end (the whole less the GEMM). Then ICNet scoring's three routes end
to end (``ICNet.fused_score``: the default, ``fuse_cff2=False``,
``fuse_stem=False``) at batch 8. Prints the ptxas lines and SASS HMMA
counts of the head kernels, one line per time (CUDA events, median of
``--iters`` after a warm-up) and a JSON object of them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

SHAPES = {"score": (8, 1024, 2048), "predict": (2, 1024, 2048)}
ROUTES = {"default": {}, "no_cff2": dict(fuse_cff2=False),
          "no_stem": dict(fuse_stem=False)}


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
    from semanticsegmentationactivelearning_tpu_torch.ops import nn as xops
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        build, icnet_front, icnet_head)
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
        if "Compiling entry" in ln and ("cff2_head" in ln or "head8" in ln):
            for nxt in lines[i:i + 4]:
                if "registers" in nxt or "spill" in nxt or nxt is ln:
                    print(f"  {nxt.strip()}")
    for fn, count in chip_smoke.hmma_counts(b.path).items():
        if "cff2_head" in fn or "head8" in fn:
            print(f"  SASS: {count} HMMA instructions in {fn}")
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
            head = (chip_smoke.icnet_head_flops(n, h8, w8, c) if score else
                    chip_smoke.icnet_head_predict_flops(n, h8, w8, c))
            flops = head + chip_smoke.cff2_flops(n, h8, w8)
            if score:
                want = icnet_head.cff2_head8_entropy_score_plain(
                    fused16, f1, model)
                err = lambda got: (got - want).abs().max().item()
                kernel = lambda: icnet_head.fused_cff2_head8_entropy_score(
                    fused16, f1, model)
                head_kernel = lambda: icnet_head.fused_head8_entropy_score(
                    fused8, wcls, bcls, c)
            else:
                logits = xops.resize_bilinear(model.head_pre_logits(fused8),
                                              (h, w))
                labels, decided = chip_smoke.decided_labels(logits, 1e-3)
                del logits
                err = lambda got: int(((got.long() != labels)
                                       & decided).sum().item())
                kernel = lambda: icnet_head.fused_cff2_head8_predict(
                    fused16, f1, model)
                head_kernel = lambda: icnet_head.fused_head8_predict(
                    fused8, wcls, bcls, c)
            what = "max|k-p| score" if score else "decided labels differ"
            ms = rigs.cuda_ms(kernel, args.iters)
            res[f"{route}/kernel"] = ms
            print(f"{route} (batch {n}, {h}x{w}) CFF2 + head: {ms:.3f} ms, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s of least work "
                  f"({flops / 1e9:.2f} GFLOP), {what} {err(kernel())}")
            ms = rigs.cuda_ms(head_kernel, args.iters)
            res[f"{route}/head8_kernel"] = ms
            print(f"  head8_kernel on the plain fused8: {ms:.3f} ms, {what} "
                  f"{err(head_kernel())}")
            if hasattr(icnet_head, "launch_cff2"):
                gemm = rigs.cuda_ms(
                    lambda: icnet_head.launch_cff2(f"fused8_{route}", fused16,
                                                   f1, model), args.iters)
                f8k = icnet_head.launch_cff2(f"fused8_{route}", fused16, f1,
                                             model)
                res[f"{route}/gemm"] = gemm
                whole = res[f"{route}/kernel"]
                print(f"  split: the GEMM alone {gemm:.3f} ms (fused8 "
                      f"max|k-p| {(f8k - fused8).abs().max().item():.3e}), "
                      f"the head end {whole - gemm:.3f} ms")
                del f8k
        del image, f1, x_half, fused16, fused8
        if not score:
            del labels, decided
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
