"""Hand-written CUDA kernels of ``csrc/`` run on the CPU, to check a
kernel's index math and fragment layouts before its first run on a
card.

    python -m semanticsegmentationactivelearning_tpu_torch.tools.cpu_emu \\
        H8 W8 [--n 1] [--immediate] [--seed 0]

:func:`build` copies ``csrc/`` into ``build/cpu_emu/``, rewrites what
only nvcc compiles for the stand-in runtime of
``emu_include/cuda_runtime.h`` (each ``extern __shared__`` array, each
``<<<...>>>`` launch, and ``tc.cuh``'s inline PTX: ``cvt.rna.tf32``,
``mma.sync`` m16n8k8 from its fragment layouts, ``cp.async``) and
compiles the sources given with g++ into one shared library with the
same C entries. Every thread of a block is a fiber on one OS thread;
``__syncthreads``, ``mma.sync``'s warp exchange and ``__shfl_xor_sync``
are barriers. A ``cp.async`` copy lands at the ``wait_group`` that
needs it (the latest the hardware may land it), or at once with
``--immediate`` (the earliest). Races that no barrier orders stay
invisible. The stand-in defines no CUDA vector type but ``float2`` and
``float4``, so ``front.cu`` and ``mid.cu`` do not build there.

:func:`main` runs ICNet's CFF2 + head kernel (both routes, and its GEMM
alone at both precisions) and the head kernel on seeded inputs of
``[N, H8, W8]`` eighth-res positions (``--classes`` of them, 19 by
default) and prints each against its plain version: fused8's max
|error|, the scores' and the decided labels that differ (top-2 logit
margin > 1e-3). ``--front`` runs ICNet's front kernels instead,
``--decoder`` ENet's decoder score route (``tail.cu`` on its score
route) on an image of ``8 H8 x 8 W8``, ``--deconv`` ENet's deconv score
kernel (``tail.cu``) on seeded pre-Final features ``[N, H8, W8, 16]``
at 5, 19 and 30 classes.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..ops.kernels import build as kbuild

INCLUDE = Path(__file__).resolve().parent / "emu_include"
OUT = kbuild.PACKAGE.parent / "build" / "cpu_emu"

# tc.cuh's functions that hold inline PTX -> their stand-in bodies
TC_BODIES = {
    "uint32_t to_tf32":
        "uint32_t b = __float_as_uint(x); return (b + 0x1000u) & ~0x1FFFu;",
    "void mma_tf32": r"""
  const int w = emu::fid() / 32, l = emu::fid() % 32;
  float* x = &emu::xch[(size_t)w * 32 * 16];
  for (int i = 0; i < 4; ++i) x[l * 16 + i] = __uint_as_float(a[i]);
  x[l * 16 + 4] = __uint_as_float(b0);
  x[l * 16 + 5] = __uint_as_float(b1);
  emu::sync_warp();
  const int g = l >> 2, q = l & 3;
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * q + (i & 1);
    float s = 0.f;
    for (int k = 0; k < 8; ++k)
      s += x[(row % 8 * 4 + k % 4) * 16 + (row >= 8) + 2 * (k >= 4)] *
           x[(col * 4 + k % 4) * 16 + 4 + (k >= 4)];
    c[i] += s;
  }
  emu::sync_warp();""",
    "void cp_async_floats":
        "for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x) "
        "emu::cp16(dst + i, src + i);",
    "void cp_async16": "emu::cp16(dst, src);",
    "void cp_async4": "emu::cp4(dst, src, valid);",
    "void cp_async_wait_sync": "emu::wait_all(); __syncthreads();",
    "void cp_async_commit": "emu::commit();",
    "void cp_async_wait_group_sync": "emu::wait_group(N); __syncthreads();",
}


def _replace_body(src: str, head: str, body: str) -> str:
    """``src`` with the body of the function whose declaration starts
    with ``head(`` replaced by ``body``."""
    i = src.index(head + "(")
    j = src.index("{", i)
    depth, k = 0, j
    while True:
        depth += {"{": 1, "}": -1}.get(src[k], 0)
        if depth == 0:
            break
        k += 1
    return src[:j] + "{\n" + body + "\n}" + src[k + 1:]


def _launch(m) -> str:
    """A ``k<<<grid, block, smem, stream>>>(args);`` launch as a call of
    the stand-in's ``emu::launch`` (the stream dropped)."""
    config = ", ".join(a.strip() for a in m.group(2).split(",")[:3])
    return f"emu::launch({config}, [&] {{ {m.group(1)}({m.group(3)}); }});"


def build(names=("icnet_head",)) -> Path:
    """The stand-in library of the ``csrc/`` sources ``names``."""
    src = OUT / "src"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(kbuild.CSRC, src)
    tc = (src / "tc.cuh").read_text()
    for head, body in TC_BODIES.items():
        tc = _replace_body(tc, head, body)
    (src / "tc.cuh").write_text(tc)
    for cu in src.glob("*.cu"):
        text = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?float smem\[\];",
                      "float* smem = emu::smem();", cu.read_text())
        text = re.sub(r"([\w:]+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);",
                      _launch, text, flags=re.S)
        cu.write_text(text)
    lib = OUT / "libssal_emu.so"
    res = subprocess.run(
        ["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-x", "c++", "-I",
         str(INCLUDE), "-o", str(lib)] + [str(src / f"{n}.cu") for n in names],
        capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed:\n{res.stderr[-6000:]}")
    return lib


def load(path: Path) -> ctypes.CDLL:
    """The library with the C entries' signatures (build.SIGNATURES)."""
    lib = ctypes.CDLL(str(path))
    for name, (args, res) in kbuild.SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = res
    return lib


def run_front(n: int, h8: int, w8: int, seed: int, parts) -> None:
    """ICNet's front kernels (csrc/icnet_front.cu) on a seeded image of
    ``n x 8h8 x 8w8`` against their plain versions, both routes: each
    output's max |error| over its maximum."""
    from chip_smoke import seeded_state_dict
    from ..models import ICNet
    from ..ops.kernels import icnet_front

    lib = load(build(("icnet_front",)))
    ptr = lambda t: ctypes.c_void_p(t.data_ptr()) if t is not None else None
    h, w = 8 * h8, 8 * w8
    model = ICNet(19)
    model.load_state_dict(seeded_state_dict(model, 1, 5.0, "ICNet"))
    model.eval()
    image = torch.from_numpy(np.random.default_rng(seed).uniform(
        size=(n, h, w, 3)).astype(np.float32))
    pack = icnet_front.pack_icnet_front(model)
    stem = model.SharedStem
    with torch.no_grad():
        f1, x_half = icnet_front.icnet_front_plain(image, model)
        c12 = stem.conv1_2(stem.conv1_1(x_half))
        want = {"f1": f1, "x_half": x_half, "c12": c12,
                "stem1": stem.front(x_half)}
    outs = {"branch1": ("f1",), "front": ("f1", "x_half"), "stem12": ("c12",),
            "stem3": ("stem1",)}
    for score in (1, 0):
        for part in parts:
            got = [torch.full_like(want[k], float("nan")) for k in outs[part]]
            src = c12 if part == "stem3" else image
            t0 = time.time()
            kbuild.check(lib.ssal_icnet_front_part(
                icnet_front.PARTS[part], ptr(src), ptr(pack), ptr(got[0]),
                ptr(got[1] if len(got) > 1 else None), n, h, w, score, None),
                part)
            errs = ", ".join(
                f"{k} {(g - want[k]).abs().max() / want[k].abs().max():.2e}"
                for k, g in zip(outs[part], got))
            print(f"{part} ({'TF32' if score else '3xTF32'}): max|k-p| / max "
                  f"{errs} ({time.time() - t0:.1f} s)")


def run_decoder(n: int, h8: int, w8: int, seed: int) -> None:
    """ENet's decoder score route (``tail5_kernel`` on the score route,
    csrc/tail.cu ``ssal_tail_decode_score``) on the plain chain's stage-4
    features and mask of a seeded image of ``n x 8h8 x 8w8``, against
    ``decoder.decoder_score_plain`` at the Final scales of
    ``chip_smoke.SCORE_SCALES``."""
    from chip_smoke import SCORE_SCALES, seeded_state_dict
    from ..models import ENet
    from ..ops.kernels import decoder, front, mid, tail

    lib = load(build(("tail",)))
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    image = torch.from_numpy(np.random.default_rng(seed).uniform(
        size=(n, 8 * h8, 8 * w8, 3)).astype(np.float32))
    for scale in SCORE_SCALES:
        model = ENet(19)
        model.load_state_dict(seeded_state_dict(model, 1, scale))
        model.eval()
        with torch.no_grad():
            x1, m1 = front.front_stage1_plain(image, model)
            y, sw2 = mid.mid_stage23_plain(x1, model)
            f4 = model.forward_stage4(y, sw2.reshape(n, h8, w8 * 64))
            want = decoder.decoder_score_plain(f4, m1, model)
        pack = tail.pack_tail(model)
        parts = torch.full((n, lib.ssal_tail_partials(h8, w8)), float("nan"))
        t0 = time.time()
        kbuild.check(lib.ssal_tail_decode_score(
            ptr(f4), ptr(m1), ptr(pack), ptr(parts), n, h8, w8, 19, None),
            "decoder route")
        got = parts.sum(1) / (64 * h8 * w8)
        print(f"decoder route (Final x{scale:g}, TF32): scores "
              f"{[round(v, 6) for v in got.tolist()]}, max|k-p| "
              f"{(got - want).abs().max():.3e} ({time.time() - t0:.1f} s)")


def run_deconv(n: int, h2: int, w2: int, seed: int) -> None:
    """ENet's deconv score kernel (csrc/tail.cu ``ssal_deconv_score``)
    on seeded features ``[n, h2, w2, 16]`` against
    ``deconv_score.deconv_score_plain`` (the scores) and
    ``deconv_partials_plain`` (the per-tile sums), at 5, 19 and 30
    classes (one to four n-tiles a chunk) and each Final scale of
    ``chip_smoke.SCORE_SCALES``."""
    from chip_smoke import SCORE_SCALES, seeded_state_dict
    from ..models import ENet
    from ..ops.kernels import deconv_score, packing, tail

    lib = load(build(("tail",)))
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    x = torch.from_numpy(np.maximum(np.random.default_rng(seed).normal(
        size=(n, h2, w2, 16)), 0).astype(np.float32))
    for c in (5, 19, 30):
        for scale in SCORE_SCALES:
            model = ENet(c)
            model.load_state_dict(seeded_state_dict(model, 1, scale))
            kernel = packing.deconv_hwio(model.Final.deconv).contiguous()
            want = deconv_score.deconv_score_plain(x, kernel, c)
            record = tail.pack_final(kernel, c)
            parts = torch.full((n, lib.ssal_deconv_partials(h2, w2)),
                               float("nan"))
            t0 = time.time()
            kbuild.check(lib.ssal_deconv_score(
                ptr(x), ptr(record), ptr(parts), n, h2, w2, c, None),
                "deconv score")
            got = parts.sum(1) / (4 * h2 * w2)
            tiles = (parts - deconv_score.deconv_partials_plain(
                x, kernel, c)).abs().max()
            print(f"deconv ({c} classes, Final x{scale:g}, TF32): scores "
                  f"{[round(v, 6) for v in got.tolist()]}, max|k-p| "
                  f"{(got - want).abs().max():.3e}, tile sums {tiles:.3e} "
                  f"({time.time() - t0:.1f} s)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("h8", type=int)
    ap.add_argument("w8", type=int)
    ap.add_argument("--n", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--immediate", action="store_true",
                    help="cp.async copies land at once")
    ap.add_argument("--classes", type=int, default=19,
                    help="ICNet's classes, for the heads")
    ap.add_argument("--front", nargs="*", default=None, metavar="PART",
                    help="run ICNet's front kernels (these parts of "
                         "icnet_front.PARTS, all by default) on an image of "
                         "8 H8 x 8 W8 in place of the heads")
    ap.add_argument("--decoder", action="store_true",
                    help="run ENet's decoder score route on an image of "
                         "8 H8 x 8 W8 in place of the heads")
    ap.add_argument("--deconv", action="store_true",
                    help="run ENet's deconv score kernel on features of "
                         "H8 x W8 half-res positions in place of the heads")
    args = ap.parse_args(argv)
    if args.immediate:
        os.environ["EMU_IMMEDIATE"] = "1"
    sys.path.insert(0, str(kbuild.PACKAGE.parent))
    if args.front is not None:
        from ..ops.kernels import icnet_front
        run_front(args.n, args.h8, args.w8, args.seed,
                  args.front or list(icnet_front.PARTS))
        return
    if args.decoder:
        run_decoder(args.n, args.h8, args.w8, args.seed)
        return
    if args.deconv:
        run_deconv(args.n, args.h8, args.w8, args.seed)
        return
    from chip_smoke import decided_labels, seeded_state_dict
    from ..models import ICNet
    from ..ops import nn as xops
    from ..ops.kernels import icnet_head

    lib = load(build())
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    n, h8, w8, c = args.n, args.h8, args.w8, args.classes
    model = ICNet(c)
    model.load_state_dict(seeded_state_dict(model, 1, 5.0, "ICNet"))
    model.eval()
    rng = np.random.default_rng(args.seed)
    f16 = torch.from_numpy((0.5 * rng.normal(
        size=(n, h8 // 2, w8 // 2, 128))).astype(np.float32))
    f1 = torch.from_numpy((0.5 * np.maximum(rng.normal(
        size=(n, h8, w8, 64)), 0)).astype(np.float32))
    pack = icnet_head.pack_cff2_head(model)
    wcls, bcls = (t.contiguous() for t in icnet_head.pack_classifier(model))
    with torch.no_grad():
        f8 = model.CFF2(f16, f1)[0]
        want = icnet_head.cff2_head8_entropy_score_plain(f16, f1, model)
        labels, decided = decided_labels(xops.resize_bilinear(
            model.head_pre_logits(f8), (8 * h8, 8 * w8)), 1e-3)
    print(f"fused8 max {f8.abs().max():.3f}, {decided.float().mean():.4f} "
          f"of pixels decided")
    for score in (1, 0):
        out = torch.full((n, h8, w8, 128), float("nan"))
        t0 = time.time()
        kbuild.check(lib.ssal_cff2_fused8(ptr(f16), ptr(f1), ptr(pack),
                                          ptr(out), n, h8, w8, c, score,
                                          None), "cff2 fused8")
        print(f"cff2 GEMM alone ({'TF32' if score else '3xTF32'}): fused8 "
              f"max|k-p| {(out - f8).abs().max():.3e} "
              f"({time.time() - t0:.1f} s)")
    for name, fn, args8 in (
            ("cff2 + head", "ssal_cff2_head", (ptr(f16), ptr(f1),
                                               ptr(pack))),
            ("head8", "ssal_head8", (ptr(f8), ptr(wcls), ptr(bcls)))):
        blocks = (lib.ssal_cff2_head_partials if fn == "ssal_cff2_head"
                  else lib.ssal_head8_partials)(h8, w8)
        parts = torch.full((n, blocks), float("nan"))
        kbuild.check(getattr(lib, fn + "_score")(
            *args8, ptr(parts), n, h8, w8, c, None), name)
        got = parts.sum(1) / (64 * h8 * w8)
        lab = torch.full((n, 8 * h8, 8 * w8), -1, dtype=torch.int8)
        kbuild.check(getattr(lib, fn + "_predict")(
            *args8, ptr(lab), n, h8, w8, c, None), name)
        bad = int(((lab.long() != labels) & decided).sum())
        print(f"{name}: scores max|k-p| {(got - want).abs().max():.3e}; "
              f"{bad} decided labels differ, {int((lab == -1).sum())} unset")


if __name__ == "__main__":
    main()
