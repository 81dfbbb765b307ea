"""ICNet's head kernel (``head8_kernel``, csrc/icnet_head.cu; wrappers
``icnet_head.fused_head8_entropy_score`` and ``fused_head8_predict``):
its staged classifier, its tiling and its precision, on the CPU.

A block takes a tile of HR x HC eighth-res positions. It stages fused8
over the tile and a one-position halo (each out-of-grid position holding
its clamped neighbour's channels) at the channel stride AS, and the
classifier ``wcls [128, C]`` at the stride of a GEMM record of C padded
to 8s. The classifier runs on the tensor cores in 3xTF32 through
``classify()`` (the CFF2 + head kernel's own), in rounds of m-tiles, and
writes its logits over the staged fused8; then the 8x head blends rows,
then columns, and ends in the entropy or the argmax. These tests hold
the staged record to the CFF2 pack's classifier record, the rounds to
the overlay they allow, the kernel rebuilt tile by tile in torch to the
plain versions at ragged shapes, and the premise of chip_smoke.py's
precision gate on the head's scores; and the wrappers' device rules.
The plain versions themselves are held to the Pallas kernels by
tests/test_torch_icnet_kernels.py.

Tolerances: records exact; the rebuilt kernel against the plain
version: scores 1e-5 (the same products in another order, 3xTF32 about
fp32's accuracy), labels equal where the top-2 logit margin exceeds
1e-3."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from semanticsegmentationactivelearning_tpu_torch.models import ICNet
from semanticsegmentationactivelearning_tpu_torch.ops import nn as xops
from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
    icnet_head, packing)

from chip_smoke import (PRECISION_GATE, head8_scores, round_tf32, rounded,
                        seeded_state_dict)
from _torch_parity import assert_labels_match

C = 19
SOURCE = (Path(icnet_head.__file__).resolve().parents[2] / "csrc"
          / "icnet_head.cu").read_text()
# the kernel's tile and buffers, as the source states them
HR, HC, THREADS, BLOCKS = map(int, re.search(
    r"constexpr int HR = (\d+), HC = (\d+), HEAD8_THREADS = (\d+), "
    r"HEAD8_BLOCKS = (\d+);", SOURCE).groups())
AS = int(re.search(r"constexpr int AS = (\d+);", SOURCE).group(1))
MAX_CLASSES = int(re.search(r"constexpr int MAX_CLASSES = (\d+);",
                            SOURCE).group(1))
NTW = int(re.search(r"constexpr int CLS_NTW = (\d+);", SOURCE).group(1))
PASSES = int(re.search(r"constexpr int kClassifierPasses = (\d+);",
                       SOURCE).group(1))
HM = (HR + 2) * (HC + 2)
SMEM_BLOCK, SMEM_SM = 232448, 233472  # bytes: a block's most, an SM's
# _HEAD8_W (pallas_kernels.py:106): phase t's weights on rows i-1, i, i+1
HEAD8_W = torch.tensor([[14, 18, 0], [10, 22, 0], [7, 24, 1], [5, 24, 3],
                        [3, 24, 5], [1, 24, 7], [0, 22, 10], [0, 18, 14]],
                       dtype=torch.float32) / 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process while the suite's workers share the
    cores: with a thread per core in each worker this file's torch work
    ran tens of times slower than alone. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(seed=1, classes=C):
    m = ICNet(classes)
    m.load_state_dict(seeded_state_dict(m, seed, 5.0, "ICNet"))
    return m.eval()


def _fused8(n, h8, w8, seed):
    """ReLU'd features, as CFF2 writes them."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((0.5 * np.maximum(rng.normal(
        size=(n, h8, w8, 128)), 0)).astype(np.float32))


def _staged(wcls, c):
    """The classifier record as head8_kernel stages it in shared memory:
    ``W[k * ws + cls] = wcls[k][cls]`` for cls < C, else 0."""
    ws = packing.bstride(-(-c // 8) * 8)
    i = torch.arange(128 * ws)
    k, cls = i // ws, i % ws
    w = torch.where(cls < c, wcls[k, cls.clamp(max=c - 1)], 0.0)
    return w.reshape(128, ws)


# -- the staged classifier and the buffers ------------------------------------

@pytest.mark.parametrize("classes", [5, 8, 19, 66, 127, 128])
def test_staged_classifier_is_the_cff2_pack_record(classes):
    """head8_kernel stages wcls as the CFF2 + head pack's classifier
    record, so that classify() reads one layout from both kernels: C
    padded to 8s, a bank-safe and 16-byte aligned stride; and the
    buffers fit: fused8 over the rectangle, then the record (the score's
    reduction slots over it), two blocks an SM at 19 classes."""
    wcls = torch.from_numpy(np.random.default_rng(classes).normal(
        size=(128, classes)).astype(np.float32))
    cp = -(-classes // 8) * 8
    ws = packing.bstride(cp)
    assert ws >= cp and ws % 32 in (8, 24) and ws % 4 == 0
    record = packing.gemm_record(wcls[None], 128, cp)[0][0]
    assert torch.equal(_staged(wcls, classes), record)
    smem = 4 * (HM * AS + 128 * ws)
    assert smem <= SMEM_BLOCK and 128 * ws >= THREADS
    if classes == C:
        assert BLOCKS * (smem + 1024) <= SMEM_SM


def _rounds(m, c, nw):
    """classify()'s schedule for ``m`` positions, ``c`` classes and
    ``nw`` warps: [(round, m-tile, first n-tile, n-tiles)]."""
    nt = -(-c // 8)
    wpm = -(-nt // NTW)
    per_round = nw // wpm
    out = []
    for r, base in enumerate(range(0, -(-m // 16), per_round)):
        for warp in range(nw):
            mt = base + warp // wpm
            part = warp % wpm
            if warp // wpm < per_round and mt < -(-m // 16):
                out.append((r, mt, part * NTW, min(NTW, nt - part * NTW)))
    return out


@pytest.mark.parametrize("nw", [THREADS // 32, 12])
def test_classify_rounds_cover_once_and_allow_the_overlay(nw):
    """For every class count the kernels take and the warps of head8's
    and CFF2's blocks: each (m-tile, n-tile) is computed once, and the
    logits a round writes (position p's at p*C .. p*C + C - 1 from the
    rows' base) reach no row that a later round reads."""
    assert MAX_CLASSES < AS
    for c in range(1, MAX_CLASSES + 1):
        sched = _rounds(HM, c, nw)
        got = sorted((mt, j) for _, mt, j0, n in sched
                     for j in range(j0, j0 + n))
        assert got == [(mt, j) for mt in range(-(-HM // 16))
                       for j in range(-(-c // 8))], c
        for r in range(max(s[0] for s in sched) + 1):
            mts = [mt for rr, mt, _, _ in sched if rr == r]
            later = [mt for rr, mt, _, _ in sched if rr > r]
            last_float = (min(16 * max(mts) + 15, HM - 1) + 1) * c - 1
            if later:
                assert last_float // AS < 16 * min(later), (c, r)


# -- the kernel's arithmetic, tile by tile --------------------------------------

def _product(a, w, passes):
    """a @ w as the tensor cores take it: exact (0), one TF32 pass (1) or
    3xTF32 (3: hi*hi + hi*lo + lo*hi)."""
    if passes == 0:
        return a @ w
    ah, wh = round_tf32(a), round_tf32(w)
    if passes == 1:
        return ah @ wh
    return ah @ wh + ah @ round_tf32(w - wh) + round_tf32(a - ah) @ wh


def head8_tiles(f8, wcls, bcls, passes=3):
    """head8_kernel rebuilt tile by tile: full-res logits [N, 8H8, 8W8,
    C], each pixel from its own tile's rectangle (clamped positions),
    the classifier's products at ``passes``."""
    n, h8, w8, _ = f8.shape
    c = wcls.shape[1]
    logits = torch.full((n, 8 * h8, 8 * w8, c), float("nan"))
    for r0 in range(0, h8, HR):
        for c0 in range(0, w8, HC):
            r = torch.arange(r0 - 1, r0 + HR + 1).clamp(0, h8 - 1)
            cc = torch.arange(c0 - 1, c0 + HC + 1).clamp(0, w8 - 1)
            cl = _product(f8[:, r][:, :, cc], wcls, passes) + bcls
            v = torch.einsum("ta,nrcla->nrtcl", HEAD8_W, cl.unfold(1, 3, 1))
            px = torch.einsum("ub,nrtplb->nrtpul", HEAD8_W, v.unfold(3, 3, 1))
            px = px.reshape(n, 8 * HR, 8 * HC, c)
            rr, ccs = min(r0 + HR, h8), min(c0 + HC, w8)
            logits[:, 8 * r0:8 * rr, 8 * c0:8 * ccs] = \
                px[:, :8 * (rr - r0), :8 * (ccs - c0)]
    return logits


def _entropy_score(logits, c):
    p = torch.softmax(logits, dim=-1)
    h = -(p * torch.log_softmax(logits, dim=-1)).sum(-1)
    return (1 - h / np.log(c)).mean(dim=(1, 2))


# ragged on both axes, a grid under one tile at batch 3, ragged rows
@pytest.mark.parametrize("shape", [(1, HR + 2, HC + 2), (3, 4, 4),
                                   (1, 6, 2 * HC + 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_tiles_match_plain_head(shape):
    """The tile rebuild's scores and decided labels equal the plain
    head's (``head8_entropy_score_plain``, ``head8_predict_plain``)."""
    m = _model(2)
    wcls, bcls = icnet_head.pack_classifier(m)
    f8 = _fused8(*shape, 5)
    n, h8, w8 = shape
    with torch.no_grad():
        logits = head8_tiles(f8, wcls, bcls)
        want = icnet_head.head8_entropy_score_plain(f8, wcls, bcls, C)
        torch.testing.assert_close(_entropy_score(logits, C), want,
                                   rtol=1e-5, atol=1e-5)
        labels = icnet_head.head8_predict_plain(f8, wcls, bcls)
        plain = xops.resize_bilinear(icnet_head.head_pre_logits(
            f8, wcls, bcls), (8 * h8, 8 * w8))
    assert_labels_match(logits.argmax(-1).numpy(), plain.numpy(), 1e-3)
    assert_labels_match(labels.numpy(), plain.numpy(), 1e-3)


# -- the precision gate's premise --------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_precision_gate_premise_on_scores(seed):
    """The plain head with the classifier's operands rounded to TF32
    moves the scores by more than 10x what the kernel's 3xTF32 does (the
    gate PRECISION_GATE["3xTF32"] in chip_smoke.py phases 7a and 8a),
    and a kernel with one TF32 pass would fail that gate. The kernel's
    passes are those that icnet_head.CLASSIFIER_PRECISION, which picks
    the gate, states."""
    assert icnet_head.CLASSIFIER_PRECISION == {1: "TF32", 3: "3xTF32"}[PASSES]
    m = _model(10 + seed)
    wcls, bcls = icnet_head.pack_classifier(m)
    f8 = _fused8(2, 8, 2 * HC, 20 + seed)
    _, rnd, share = PRECISION_GATE["3xTF32"]
    with torch.no_grad():
        want = head8_scores(m, f8)
        torch.testing.assert_close(
            want, icnet_head.head8_entropy_score_plain(f8, wcls, bcls, C),
            rtol=0, atol=0)

        def err(passes):
            return (_entropy_score(head8_tiles(f8, wcls, bcls, passes), C)
                    - want).abs().max().item()

        control = (rounded(m, rnd, lambda mm: head8_scores(mm, f8),
                           ("Classifier",)) - want).abs().max().item()
        tf32x3, tf32 = err(3), err(1)
    assert tf32x3 < share * control, (tf32x3, control)
    assert tf32 > share * control, (tf32, control)


# -- the wrappers on the CPU and elsewhere ------------------------------------------

def test_wrappers_take_the_plain_path_on_the_cpu_and_refuse_others():
    """On the CPU both wrappers return their plain versions and count no
    launch; a tensor on another device raises before any build, as does
    a class count over the kernel's."""
    m = _model(3)
    wcls, bcls = icnet_head.pack_classifier(m)
    f8 = _fused8(1, 4, 6, 7)
    fused = (icnet_head.fused_head8_entropy_score,
             icnet_head.fused_head8_predict)
    before = [fn.launches for fn in fused]
    with torch.no_grad():
        assert torch.equal(
            icnet_head.fused_head8_entropy_score(f8, wcls, bcls, C),
            icnet_head.head8_entropy_score_plain(f8, wcls, bcls, C))
        assert torch.equal(icnet_head.fused_head8_predict(f8, wcls, bcls, C),
                           icnet_head.head8_predict_plain(f8, wcls, bcls))
    assert [fn.launches for fn in fused] == before
    meta = dict(device="meta")
    for fn in fused:
        with pytest.raises(ValueError, match="CUDA"):
            fn(torch.empty(1, 4, 6, 128, **meta), torch.empty(128, C, **meta),
               torch.empty(C, **meta), C)
    with pytest.raises(ValueError, match="at most 128"):
        icnet_head.fused_head8_entropy_score(
            torch.empty(1, 4, 6, 128, **meta), torch.empty(128, 129, **meta),
            torch.empty(129, **meta), 129)
    assert [fn.launches for fn in fused] == before
