"""The packing rig on a CUDA device: at equal useful work, the front
kernel's wide structure (``base``: a chain of layers x 9 products
``[rows,128] x [128,128]``, a useful eighth of each) against a narrow
one (``nside``: a chain of ``layers`` products ``[8*rows,128] x
[128,16]``, each output tiled back to 128 columns), in bf16 on the
tensor cores and in fp32 on the CUDA cores (the port of
``tools/probe_front_packing.py``; the kernel is
``csrc/probe_matmul.cu``).

    python -m semanticsegmentationactivelearning_tpu_torch.tools.probe_front_packing \\
        [--rows 512 --m 108 --tiles 64 --iters 8 --modes base,nside \\
         --dtypes bf16,fp32]

Prints, for each dtype and mode, the CUDA-event time of one call
(median of ``--iters`` after a warm-up), the rate on the issued and on
the useful multiply-adds, and the verdict of each dtype (nside at 0.95
of base's time or more closes the packing axis); returns them from
:func:`main`.
"""

from __future__ import annotations

import argparse
import json

from . import rigs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=512,
                    help="rows a tile in base; nside takes 8x")
    ap.add_argument("--m", type=int, default=108,
                    help="products a tile in base (layers x 9); nside "
                         "takes m // 9")
    ap.add_argument("--tiles", type=int, default=64)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--modes", default="base,nside")
    ap.add_argument("--dtypes", default="bf16,fp32")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = rigs.require_cuda()
    layers = max(1, args.m // 9)
    useful = 2.0 * layers * 9 * args.rows * 128 * 128 / 8 * args.tiles
    # mode -> (rows, output columns, products, kernel mode)
    shapes = {"base": (args.rows, 128, 9 * layers, "chain"),
              "nside": (8 * args.rows, 16, layers, "nside")}
    results = {}
    for dname in rigs.split(args.dtypes):
        for mode in rigs.split(args.modes):
            rows, n_cols, m, kmode = shapes[mode]
            a, w = rigs.matmul_inputs(args.tiles, rows, n_cols,
                                      rigs.dtype_named(dname), args.seed,
                                      device)
            ms = rigs.cuda_ms(lambda: rigs.probe_matmul(a, w, m, kmode),
                              args.iters)
            issued = rigs.matmul_flops(a, w, m)
            results[f"{dname} {mode}"] = dict(
                ms=ms, flops=issued, tflops=issued / ms / 1e9,
                useful_tflops=useful / ms / 1e9)
            print(f"front packing: {dname} {mode}: {ms:.4f} ms/call, "
                  f"{issued / ms / 1e9:.1f} TFLOP/s issued, "
                  f"{useful / ms / 1e9:.1f} TFLOP/s useful ({layers} "
                  f"layers, {args.tiles} tiles)")
        base, nside = (results.get(f"{dname} {k}") for k in ("base", "nside"))
        if base and nside:
            closed = nside["ms"] >= 0.95 * base["ms"]
            results[f"{dname} verdict"] = (
                "nside slower or equal: packing axis closed" if closed
                else "nside faster: the narrow packing has headroom")
            print(f"front packing: {dname}: {results[f'{dname} verdict']} "
                  f"(base {base['ms']:.4f} ms, nside {nside['ms']:.4f} ms "
                  f"at equal useful work)")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
