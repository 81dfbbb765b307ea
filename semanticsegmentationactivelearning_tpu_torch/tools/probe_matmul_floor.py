"""The matmul-stream rig on a CUDA device: per tile, m products
``[rows,128] x [128,128]``, independent (``indep``), as a dependent
chain (``chain``) or a chain with PReLU 0.25 between products
(``prelu``), in bf16 on the tensor cores (mma.sync, fp32 accumulate,
bf16 between products) and in fp32 on the CUDA cores (the port of
``tools/probe_mosaic_floor.py``; the kernel is ``csrc/probe_matmul.cu``).

    python -m semanticsegmentationactivelearning_tpu_torch.tools.probe_matmul_floor \\
        [--rows 1536 --m 123 --tiles 64 --iters 10 --modes indep,chain,prelu \\
         --dtypes bf16,fp32]

Prints, for each dtype and mode, the CUDA-event time of one call
(median of ``--iters`` after a warm-up) and the rate on the issued
multiply-adds; returns them from :func:`main`.
"""

from __future__ import annotations

import argparse
import json

from . import rigs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1536)
    ap.add_argument("--m", type=int, default=123,
                    help="products per tile")
    ap.add_argument("--tiles", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--modes", default="indep,chain,prelu")
    ap.add_argument("--dtypes", default="bf16,fp32")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = rigs.require_cuda()
    results = {}
    for dname in rigs.split(args.dtypes):
        a, w = rigs.matmul_inputs(args.tiles, args.rows, 128,
                                  rigs.dtype_named(dname), args.seed, device)
        flops = rigs.matmul_flops(a, w, args.m)
        for mode in rigs.split(args.modes):
            ms = rigs.cuda_ms(lambda: rigs.probe_matmul(a, w, args.m, mode),
                              args.iters)
            results[f"{dname} {mode}"] = dict(ms=ms, flops=flops,
                                              tflops=flops / ms / 1e9)
            print(f"matmul floor: {dname} {mode}: {ms:.4f} ms/call, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s on issued work "
                  f"({args.tiles} tiles x {args.m} x [{args.rows},128]@"
                  f"[128,128])")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
