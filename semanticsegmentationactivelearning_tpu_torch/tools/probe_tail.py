"""The ENet tail's time on a CUDA device, split into stage 4 and stage 5
+ Final, at the serving shape (batch 2, 1024x2048) and the scoring
shape (batch 8, 512x1024), with the seeded ENet-19 of ``chip_smoke.py``.

    python semanticsegmentationactivelearning_tpu_torch/tools/probe_tail.py \\
        [--root DIR] [--iters 5] [--seed 0]

``--root`` imports the port (and ``chip_smoke.py``) from another
checkout of the repo, e.g. the parent commit unpacked with ``git
archive``, so that two versions are timed on one card by running this
script once for each. Times the tail predict and tail score kernels as
their wrappers launch them, the decoder score route
(``decoder.fused_decoder_entropy_score``: stage 5 + Final + entropy) on
the plain stage 4's output and the deconv score kernel (Final +
entropy) on the plain decoder's, at the same shape; where the tail
module has the two-kernel split (``fused_tail_stage4``,
``fused_tail_decode``), each half alone too, at each route's precision.
Prints the ptxas lines of the tail and decoder kernels, one line per
time (CUDA events, median of ``--iters`` after a warm-up) and a JSON
object of them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

SHAPES = {"serve": (2, 1024, 2048), "score": (8, 512, 1024)}


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
    import torch
    import chip_smoke
    from semanticsegmentationactivelearning_tpu_torch.models import (
        get_model)
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        build, deconv_score, decoder, front, mid, packing, tail)
    from semanticsegmentationactivelearning_tpu_torch.tools import rigs

    rigs.require_cuda()
    import subprocess
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    b = build.build()
    build.library()
    print(f"root {root}: build {b.seconds:.1f} s")
    lines = b.log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and ("tail" in ln or "decoder" in ln):
            for nxt in lines[i:i + 4]:
                if "registers" in nxt or "spill" in nxt or nxt is ln:
                    print(f"  {nxt.strip()}")
    model = get_model("ENet", chip_smoke.CLASSES)
    model.load_state_dict(chip_smoke.seeded_state_dict(model, args.seed))
    model = model.cuda().eval()
    split = hasattr(tail, "fused_tail_stage4")
    res = {}
    for label, (n, h, w) in SHAPES.items():
        rng = np.random.default_rng(args.seed + 1)
        image = torch.from_numpy(rng.integers(
            0, 256, (n, h, w, 3), dtype=np.uint8)).cuda().float() / 255.0
        with torch.no_grad():
            x1, m1 = front.front_stage1_plain(image, model)
            y, sw2 = mid.mid_stage23_plain(x1, model)
            del x1, image
            f4 = model.forward_stage4(y, sw2.reshape(n, h // 8, w // 8 * 64))
            pre = model.decode_from_stage4(f4, tail.mask_to_switches(m1))
            kernel = packing.deconv_hwio(model.Final.deconv).contiguous()
            cases = {
                "tail_predict": lambda: tail.fused_tail_predict(
                    y, sw2, m1, model),
                "tail_score": lambda: tail.fused_tail_entropy_score(
                    y, sw2, m1, model),
                "decoder_score": lambda: decoder.fused_decoder_entropy_score(
                    f4, None, model, mask=m1),
                "deconv_score": lambda:
                    deconv_score.fused_deconv_entropy_score(
                        pre, kernel, chip_smoke.CLASSES),
            }
            if split:  # each half at its route's precision
                x4 = {score: tail.fused_tail_stage4(y, sw2, model, score)
                      for score in (False, True)}
                for route, score in (("predict", False), ("score", True)):
                    cases[f"stage4_{route}"] = (
                        lambda s=score: tail.fused_tail_stage4(y, sw2,
                                                               model, s))
                    cases[f"decode_{route}"] = (
                        lambda s=score: tail.fused_tail_decode(x4[s], m1,
                                                               model, s))
            for name, fn in cases.items():
                ms = rigs.cuda_ms(fn, args.iters)
                res[f"{label}/{name}"] = ms
                print(f"{label} (batch {n}, {h}x{w}) {name}: {ms:.3f} ms")
            del y, sw2, m1, f4, pre, cases
            torch.cuda.empty_cache()
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
