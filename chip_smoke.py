#!/usr/bin/env python3
"""Smoke run of the PyTorch port's ENet serving path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises, so the exit code is not 0):
  1. device: the card's name and power limit; CUDA must be present.
  2. build: nvcc compiles the kernels of
     semanticsegmentationactivelearning_tpu_torch/csrc for sm_90a.
  3. kernels: each kernel (front, mid, tail predict) against its plain
     PyTorch version on the same inputs at ENet-19, batch 2, 1024x2048,
     with seeded weights (glorot-uniform convs, noised BN statistics);
     also each one's time beside its plain version's.
  4. serve: a seeded checkpoint saved and restored through the port's
     checkpoint module, then make_predict_fn over uint8 batches fed by
     device_prefetch. The kernels' launch counters are zeroed before this
     run and must show every kernel launched in it; the served maps must
     agree with the plain chain where its top-2 logit margin is decided.
     The inference CLI runs on a few records too when PIL is installed.
Prints the card, a JSON line of per-kernel results, and last
{"ok": true, "device": {...}}. This process imports neither JAX nor the
JAX package (checked at the end). The CLI phase's child processes use
the JAX package's framework-free record codec, as the port's CLI does.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N, H, W, CLASSES = 2, 1024, 2048, 19
# The recipe alone gives logits with a standard deviation of about 0.04,
# and only ~91% of pixels clear the 1e-3 label margin; a trained
# classifier spreads its logits over units. Scaling the Final kernel by
# 25 brings the decided share above 99% (measured on CPU at 256x512).
FINAL_SCALE = 25.0
BATCHES, WARMUP = 10, 2  # served batches; the first WARMUP are not timed
REPS = 5                 # timed runs per kernel and per plain version
_PALLAS = "semanticsegmentationactivelearning_tpu/ops/pallas_kernels.py"
REPLACES = {"front": f"{_PALLAS}:1474", "mid": f"{_PALLAS}:2184",
            "tail": f"{_PALLAS}:2810"}
SOURCES = {k: f"semanticsegmentationactivelearning_tpu_torch/csrc/{k}.cu"
           for k in REPLACES}


def seeded_state_dict(model, seed: int) -> dict:
    """Glorot-uniform conv weights, BN scale 1 / bias 0 with running
    mean |N(0, 0.3)| and var 1 + |N(0, 0.3)|, PReLU 0.25 (the noised-BN
    recipe of the JAX package's kernel tests), from numpy; the Final
    kernel is scaled by FINAL_SCALE."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, v in model.state_dict().items():
        shape = tuple(v.shape)
        if key.endswith(".weight") and len(shape) == 4:
            rf = shape[2] * shape[3]
            lim = np.sqrt(6.0 / (rf * (shape[0] + shape[1])))
            a = rng.uniform(-lim, lim, size=shape)
        elif key.endswith("running_mean"):
            a = np.abs(rng.normal(size=shape, scale=0.3))
        elif key.endswith("running_var"):
            a = 1.0 + np.abs(rng.normal(size=shape, scale=0.3))
        elif key.endswith(".alpha"):
            a = np.full(shape, 0.25)
        elif key.endswith(".weight"):
            a = np.ones(shape)
        else:
            a = np.zeros(shape)
        if key == "Final.deconv.weight":
            a = a * FINAL_SCALE
        out[key] = torch.tensor(a, dtype=torch.float32)
    return out


def cuda_ms(fn) -> float:
    """Median CUDA-event time of ``fn()`` over REPS runs after one."""
    fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def window_gap(x: torch.Tensor) -> torch.Tensor:
    """Top-2 gap of every 2x2 pool window: [N,H,W,C] -> [N,H/2,W/2,C]."""
    n, h, w, c = x.shape
    win = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    top2 = win.reshape(n, h // 2, w // 2, c, 4).topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def decided_labels(logits: torch.Tensor, margin: float):
    """(argmax, mask of pixels whose top-2 margin exceeds ``margin``)."""
    top2 = logits.topk(2, dim=-1).values
    return logits.argmax(dim=-1), (top2[..., 0] - top2[..., 1]) > margin


def check_kernels(model, seed: int) -> dict:
    """Each kernel against its plain version on the same inputs."""
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        front, mid, tail)
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 1)
    stack = torch.from_numpy(
        rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)).to(dev)
    image = stack.float() / 255.0
    res = {}
    with torch.no_grad():
        # front
        x1p, m1p = front.front_stage1_plain(image, model)
        x1k, m1k = front.fused_front_stage1(image, model)
        err = (x1k - x1p).abs().max().item()
        bound = 1e-3 * x1p.abs().max().item()
        if not err <= bound:
            raise AssertionError(f"front x1: max err {err} > {bound}")
        gap = window_gap(model.Initial(image))
        swk = m1k.reshape(N, H // 4, W // 4, 4, 16).argmax(dim=3)
        swp = m1p.reshape(N, H // 4, W // 4, 4, 16).argmax(dim=3)
        onehot = bool((m1k.reshape(N, H // 4, W // 4, 4, 16).sum(3) == 1)
                      .all() and ((m1k == 0) | (m1k == 1)).all())
        bad = ((swk != swp) & (gap > 1e-4)).sum().item()
        print(f"front: x1 max|k-p| {err:.3e} (bound {bound:.3e}); mask1 "
              f"one-hot {onehot}, {bad} decided switches differ "
              f"({(gap > 1e-4).float().mean().item():.5f} decided)")
        if bad or not onehot:
            raise AssertionError("front mask1 disagrees with the plain one")
        res["front"] = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: front.fused_front_stage1(image, model)),
            plain_ms=cuda_ms(lambda: front.front_stage1_plain(image, model)))
        # mid, on the plain front's output
        yp, sw2p = mid.mid_stage23_plain(x1p, model)
        yk, sw2k = mid.fused_mid_stage23(x1p, model)
        err = (yk - yp).abs().max().item()
        bound = 1e-3 * yp.abs().max().item()
        if not err <= bound:
            raise AssertionError(f"mid y: max err {err} > {bound}")
        gap = window_gap(x1p)
        bad = ((sw2k != sw2p) & (gap > 1e-4)).sum().item()
        print(f"mid: y max|k-p| {err:.3e} (bound {bound:.3e}); {bad} "
              f"decided sw2 values differ "
              f"({(gap > 1e-4).float().mean().item():.5f} decided)")
        if bad:
            raise AssertionError("mid sw2 disagrees with the plain one")
        res["mid"] = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: mid.fused_mid_stage23(x1p, model)),
            plain_ms=cuda_ms(lambda: mid.mid_stage23_plain(x1p, model)))
        # tail, on the plain mid's and front's outputs
        lk = tail.fused_tail_predict(yp, sw2p, m1p, model)
        logits = model.forward_tail(yp, sw2p.reshape(N, H // 8, W // 8 * 64),
                                    tail.mask_to_switches(m1p))
        want, decided = decided_labels(logits, 1e-3)
        del logits
        frac = decided.float().mean().item()
        diff = (lk.long() - want).abs()[decided]
        bad = int((diff != 0).sum().item())
        print(f"tail: {bad} decided labels differ ({frac:.5f} of pixels "
              f"decided at margin 1e-3)")
        if bad or frac < 0.99:
            raise AssertionError("tail labels disagree with the plain ones")
        res["tail"] = dict(
            max_abs_err=float(diff.max().item()) if diff.numel() else 0.0,
            ms=cuda_ms(lambda: tail.fused_tail_predict(yp, sw2p, m1p, model)),
            plain_ms=cuda_ms(
                lambda: tail.tail_predict_plain(yp, sw2p, m1p, model)))
    for k, r in res.items():
        print(f"{k}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms "
              f"(batch {N}, {H}x{W})")
    return res


def serve(model_state: dict, seed: int):
    """The main path: checkpoint round trip, make_predict_fn over
    device_prefetch. Returns (launch counts, kernel ms/batch, plain
    ms/batch, the restored model)."""
    from semanticsegmentationactivelearning_tpu_torch.data.device_prefetch \
        import device_prefetch
    from semanticsegmentationactivelearning_tpu_torch.inference import (
        make_predict_fn)
    from semanticsegmentationactivelearning_tpu_torch.models import (
        get_model)
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        front, mid, tail)
    from semanticsegmentationactivelearning_tpu_torch.train import (
        checkpoint)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        src = get_model("ENet", CLASSES)
        src.load_state_dict(model_state)
        path = checkpoint.save_checkpoint(os.path.join(tmp, "model-1.ckpt"),
                                          src)
        model = get_model("ENet", CLASSES)
        checkpoint.restore_checkpoint(path, model)
    lut = torch.arange(256, dtype=torch.uint8)  # raw class ids
    predict = make_predict_fn(model, lut, H, W, 3, dev)
    rng = np.random.default_rng(seed + 2)
    host = [{"stack": rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)}
            for _ in range(BATCHES)]

    wrappers = (front.fused_front_stage1, mid.fused_mid_stage23,
                tail.fused_tail_predict)
    for fn in wrappers:
        fn.launches = 0
    outs, stacks, times = [], [], []
    for b in device_prefetch(iter(host), dev):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs.append(predict(b["stack"]))
        end.record()
        stacks.append(b["stack"])
        times.append((start, end))
    torch.cuda.synchronize()
    launches = [fn.launches for fn in wrappers]
    per_batch = (1, mid.LAUNCHES_PER_CALL, 1)
    print(f"serve: {len(outs)} batches, launches front/mid/tail "
          f"{launches} (expected {[p * len(outs) for p in per_batch]})")
    if len(outs) != BATCHES or launches != [p * BATCHES for p in per_batch]:
        raise AssertionError("the serving run did not launch every kernel "
                             "once per batch")
    kernel_ms = float(np.median([s.elapsed_time(e)
                                 for s, e in times[WARMUP:]]))

    def plain_predict(stack):
        with torch.inference_mode():
            image = stack.float().div_(255.0)
            x1, m1 = front.front_stage1_plain(image, model)
            y, sw2 = mid.mid_stage23_plain(x1, model)
            return lut.to(dev)[tail.tail_predict_plain(y, sw2, m1, model)
                               .long()]

    ptimes = []
    for stack in stacks:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        plain_predict(stack)
        end.record()
        ptimes.append((start, end))
    torch.cuda.synchronize()
    plain_ms = float(np.median([s.elapsed_time(e)
                                for s, e in ptimes[WARMUP:]]))

    # the served maps against the plain chain's logits, first batch
    out = outs[0]
    if out.shape != (N, H, W) or out.dtype != torch.uint8 \
            or out.device.type != "cuda":
        raise AssertionError(f"served maps: {out.shape} {out.dtype}")
    with torch.inference_mode():
        logits = model(stacks[0].float() / 255.0)
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits")
    want, decided = decided_labels(logits, 1e-3)
    bad = int(((out.long() != want) & decided).sum().item())
    frac = decided.float().mean().item()
    print(f"serve: kernel chain {kernel_ms:.3f} ms/batch, plain chain "
          f"{plain_ms:.3f} ms/batch (median of {BATCHES - WARMUP}); "
          f"{bad} decided pixels differ from the plain forward "
          f"({frac:.5f} decided)")
    # Unlike the per-kernel checks, the two chains feed each stage
    # slightly different inputs (fp32 sums in another order), so a pool
    # window whose top two values nearly tie may pick another switch and
    # move an unpooled value; allow such flips on 1e-4 of the pixels.
    if bad > 1e-4 * decided.sum().item() or frac < 0.99:
        raise AssertionError("served maps disagree with the plain forward")
    return launches, kernel_ms, plain_ms, model


def run_cli(model, seed: int) -> None:
    """The port's inference CLI on four 1024x2048 records (needs PIL for
    the record images and the PNGs). The records are written, and read
    by the CLI, with the JAX package's TFRecord and example modules,
    which import no JAX; both run in child processes."""
    from semanticsegmentationactivelearning_tpu_torch.train import (
        checkpoint)
    script = (
        "import sys, numpy as np, io\n"
        "from PIL import Image\n"
        "from semanticsegmentationactivelearning_tpu.data import "
        "example, tfrecord\n"
        "rng = np.random.default_rng(int(sys.argv[2]))\n"
        "def png(a):\n"
        "    b = io.BytesIO(); Image.fromarray(a).save(b, format='PNG')\n"
        "    return b.getvalue()\n"
        "for i in range(4):\n"
        f"    img = rng.integers(0, 256, ({H}, {W}, 3), dtype=np.uint8)\n"
        f"    lbl = np.zeros(({H}, {W}), np.uint8)\n"
        "    ex = example.SegExample(file_id=f'r{i}', height=img.shape[0],"
        " width=img.shape[1], label=png(lbl),"
        " modalities={'image': (png(img), 'png', 3)})\n"
        "    tfrecord.write_record_file(f'{sys.argv[1]}/r{i}.tfrecord',"
        " example.make_example(ex))\n")
    with tempfile.TemporaryDirectory() as tmp:
        rec, out = os.path.join(tmp, "rec"), os.path.join(tmp, "out")
        os.makedirs(rec)
        ck = checkpoint.save_checkpoint(os.path.join(tmp, "m.ckpt"), model)
        subprocess.run([sys.executable, "-c", script, rec, str(seed)],
                       check=True)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m",
             "semanticsegmentationactivelearning_tpu_torch.inference",
             "-c", ck, "-d", rec, "-o", out, "-t", "cityscapes", "-b", "2"],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise AssertionError("inference CLI failed:\n" + res.stdout
                                 + res.stderr[-4000:])
        pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        print(f"cli: {len(pngs)} PNGs in {time.perf_counter() - t0:.1f} s")
        if pngs != [f"r{i}.png" for i in range(4)]:
            raise AssertionError(f"inference CLI wrote {pngs}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and the input batches")
    args = ap.parse_args(argv)

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from semanticsegmentationactivelearning_tpu_torch.models import (
        get_model)
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        build)

    # 2. build
    b = build.build()
    build.library()
    ptxas = [ln.strip() for ln in b.log.splitlines()
             if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    print(f"build: {b.seconds:.1f} s -> {b.path.name}")
    for ln in ptxas:
        print(f"  {ln}")

    # 3. kernels against their plain versions
    state = seeded_state_dict(get_model("ENet", CLASSES), args.seed)
    model = get_model("ENet", CLASSES).cuda()
    model.load_state_dict(state)
    per_kernel = check_kernels(model, args.seed)

    # 4. the serving path
    launches, kernel_ms, plain_ms, served = serve(state, args.seed)
    try:
        import PIL  # noqa: F401
    except ImportError:
        print("cli: PIL is not installed; the CLI phase is skipped")
    else:
        run_cli(served, args.seed)

    jax_side = ("jax", "flax", "semanticsegmentationactivelearning_tpu")
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in jax_side)
    if leaked:
        raise AssertionError(f"imported JAX or the JAX package: {leaked}")

    kernels = [dict(name=k, route="cuda", source=SOURCES[k],
                    replaces=REPLACES[k], launches=n, **per_kernel[k])
               for k, n in zip(("front", "mid", "tail"), launches)]
    print(f"chain: kernel {kernel_ms:.3f} ms/batch, plain {plain_ms:.3f} "
          f"ms/batch (batch {N}, {H}x{W}, ENet-{CLASSES}; {smi})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
