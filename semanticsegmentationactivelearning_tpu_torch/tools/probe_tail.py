"""The ENet tail's time on a CUDA device, split into stage 4 and stage 5
+ Final, at the serving shape (batch 2, 1024x2048) and the scoring
shape (batch 8, 512x1024), with the seeded ENet-19 of ``chip_smoke.py``.

    python semanticsegmentationactivelearning_tpu_torch/tools/probe_tail.py \\
        [--root DIR] [--deconv-tile RxB ...] [--hashes FILE] \\
        [--iters 5] [--seed 0]

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
Each ``--deconv-tile`` (R half-res rows a tile, at least B blocks an
SM) builds ``csrc/tail.cu`` of this checkout with that tile in place of
its own (the line ``constexpr int DECONV_ROWS = .., DECONV_BLOCKS =
..;``) into
``build/probe_tail/`` and times its deconv score kernel the same way.
``--hashes`` writes the SHA-256 of each case's inputs and outputs, so
that two checkouts' outputs can be compared bit for bit.
Prints the card, the ptxas lines and SASS HMMA counts of the tail,
decoder and deconv kernels, one line per time (CUDA events, median of
``--iters`` after a warm-up; the deconv kernels with their max |score
difference| from the plain version) and a JSON object of them.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import runpy
import subprocess
import sys
from pathlib import Path

import torch

SHAPES = {"serve": (2, 1024, 2048), "score": (8, 512, 1024)}
TILE_LINE = r"constexpr int DECONV_ROWS = \d+, DECONV_BLOCKS = \d+;"
DECONV_ENTRIES = ("ssal_deconv_partials", "ssal_deconv_score")


def deconv_launch(lib, build, pre, record, c):
    """One launch of ``lib``'s deconv score kernel: the scores."""
    n, h2, w2, _ = pre.shape
    parts = torch.empty((n, lib.ssal_deconv_partials(h2, w2)),
                        device=pre.device)
    build.check(lib.ssal_deconv_score(build.ptr(pre), build.ptr(record),
                                      build.ptr(parts), n, h2, w2, c,
                                      build.stream_of(pre)), "deconv score")
    return parts.sum(dim=1) / float(4 * h2 * w2)


def sha(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="checkout to import the port from")
    ap.add_argument("--deconv-tile", nargs="*", default=[],
                    metavar="RxB",
                    help="deconv score kernel tiles to build and time "
                         "besides the checkout's own")
    ap.add_argument("--hashes", default=None,
                    help="write each case's input and output hashes here")
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
        build, deconv_score, decoder, front, mid, packing, tail)
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
    keys = ("tail", "decoder", "deconv")
    # this checkout's tile builds, whichever checkout --root names
    tb = runpy.run_path(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tile_builds.py"))
    for ln in tb["ptxas_lines"](b.log, keys):
        print(f"  {ln}")
    for fn, count in chip_smoke.hmma_counts(b.path).items():
        if any(k in fn for k in keys):
            print(f"  SASS: {count} HMMA instructions in {fn}")
    libs = tb["tile_libraries"](
        build, "tail.cu", TILE_LINE,
        lambda tile: "constexpr int DECONV_ROWS = {}, DECONV_BLOCKS = {};"
        .format(*tile.split("x")), DECONV_ENTRIES, args.deconv_tile,
        Path(root) / "build" / "probe_tail")
    for tile, (_, log) in libs.items():
        print(f"deconv tile {tile}:")
        for ln in tb["ptxas_lines"](log, ("deconv",)):
            print(f"  {ln}")
    model = get_model("ENet", chip_smoke.CLASSES)
    model.load_state_dict(chip_smoke.seeded_state_dict(model, args.seed))
    model = model.cuda().eval()
    split = hasattr(tail, "fused_tail_stage4")
    res, hashes = {}, {}
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
            c = chip_smoke.CLASSES
            # the record the route caches, where the kernel reads one
            record = (tail.pack_final(kernel, c)
                      if hasattr(tail, "pack_final") else None)
            deconv_kw = {} if record is None else dict(record=record)
            want = deconv_score.deconv_score_plain(pre, kernel, c)
            for k, t in (("y", y), ("sw2", sw2), ("m1", m1), ("f4", f4),
                         ("pre", pre)):
                hashes[f"{label}/input/{k}"] = sha(t)
            cases = {
                "tail_predict": lambda: tail.fused_tail_predict(
                    y, sw2, m1, model),
                "tail_score": lambda: tail.fused_tail_entropy_score(
                    y, sw2, m1, model),
                "decoder_score": lambda: decoder.fused_decoder_entropy_score(
                    f4, None, model, mask=m1),
                "deconv_score": lambda:
                    deconv_score.fused_deconv_entropy_score(
                        pre, kernel, c, **deconv_kw),
            }
            for tile, (lib, _) in libs.items():
                cases[f"deconv_score {tile}"] = (
                    lambda lib=lib: deconv_launch(lib, build, pre, record, c))
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
                out = fn()
                hashes[f"{label}/output/{name}"] = sha(out)
                err = (f", max|k-p| {(out - want).abs().max().item():.3e}"
                       if name.startswith("deconv") else "")
                print(f"{label} (batch {n}, {h}x{w}) {name}: {ms:.3f} ms"
                      f"{err}")
            del y, sw2, m1, f4, pre, cases
            torch.cuda.empty_cache()
    print(json.dumps(res))
    if args.hashes:
        Path(args.hashes).write_text(json.dumps(hashes, indent=1))
    return res


if __name__ == "__main__":
    main()
