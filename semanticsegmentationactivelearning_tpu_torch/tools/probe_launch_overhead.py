"""The launch rig on a CUDA device: the tail kernel's grid (N, H8/te)
and nine tile streams with a trivial body, without and with the 41
constant operands (the port of ``tools/probe_pallas_overhead.py``; the
kernel is ``csrc/probe_launch.cu``).

    python -m semanticsegmentationactivelearning_tpu_torch.tools.probe_launch_overhead \\
        [--batch 16 --h8 128 --w8 256 --te 16 --nconst 41 --iters 5]

Prints, for each case, the CUDA-event time of one call (median of
``--iters`` after a warm-up) and the rate of the bytes it reads; returns
them from :func:`main`.
"""

from __future__ import annotations

import argparse
import json

from . import rigs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--h8", type=int, default=128)
    ap.add_argument("--w8", type=int, default=256)
    ap.add_argument("--te", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--nconst", type=int, default=41)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = rigs.require_cuda()
    y, sw, m1, consts = rigs.launch_inputs(args.batch, args.h8, args.w8,
                                           args.nconst, args.seed, device)
    results = {}
    for tag, cs in (("no consts", []), (f"{args.nconst} consts", consts)):
        ms = rigs.cuda_ms(lambda: rigs.probe_launch(y, sw, m1, cs, args.te),
                          args.iters)
        nbytes = rigs.launch_read_bytes(y, sw, m1, cs, args.te)
        results[tag] = dict(ms=ms, read_bytes=nbytes,
                            gb_per_s=nbytes / ms / 1e6)
        print(f"launch rig: 9 tile streams, {tag} (batch {args.batch}, "
              f"{args.h8}x{args.w8} at 1/8, te {args.te}): {ms:.4f} ms/call, "
              f"{nbytes / 1e9:.3f} GB read, {nbytes / ms / 1e6:.1f} GB/s")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
