"""The PyTorch port's CUDA kernels on the card (marked ``cuda``; every
test skips without a CUDA device). This file imports neither JAX nor
the JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -o addopts="" -m cuda \\
        tests/test_torch_cuda.py -q

Each kernel (ENet's, ICNet's and the rigs') is held against its plain
PyTorch version on the same inputs, with TF32 off on both sides:
features rtol = atol = 1e-4 (ICNet's half-res image 1e-5);
switches exact where the pooled window's top-2 gap exceeds 1e-4;
labels exact where the top-2 logit margin exceeds 1e-3; per-image
scores |difference| <= 1e-4 (means over the pixels, summed in another
order); the rigs' sums within 1e-5 (fp32) or 1e-2 (bf16, rounded
between chained products) of the sum of the magnitudes they add up."""

import numpy as np
import pytest
import torch

from semanticsegmentationactivelearning_tpu_torch.data.device_prefetch \
    import device_prefetch
from semanticsegmentationactivelearning_tpu_torch.inference import (
    make_predict_fn)
from semanticsegmentationactivelearning_tpu_torch.models import ENet, ICNet
from semanticsegmentationactivelearning_tpu_torch.ops import acquisition
from semanticsegmentationactivelearning_tpu_torch.ops import nn as xops
from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
    deconv_score, decoder, front, icnet_front, icnet_head, mid, packing,
    tail)
from semanticsegmentationactivelearning_tpu_torch.tools import rigs
from semanticsegmentationactivelearning_tpu_torch.train.steps import (
    make_score_step)

pytestmark = pytest.mark.cuda
C = 19
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def model():
    return _enet(C)


def _enet(classes):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    m = ENet(classes)
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in m.state_dict().items():
        if k.endswith("running_mean"):
            v = torch.tensor(np.abs(rng.normal(size=v.shape, scale=0.3)))
        elif k.endswith("running_var"):
            v = 1 + torch.tensor(np.abs(rng.normal(size=v.shape, scale=0.3)))
        elif k == "Final.deconv.weight":
            v = v * 25  # spread the logits so most pixels are decided
        sd[k] = v.float()
    m.load_state_dict(sd)
    return m.cuda()


def _image(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        size=shape).astype(np.float32)).cuda()


def _gap(x):
    n, h, w, c = x.shape
    win = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    top2 = win.reshape(n, h // 2, w // 2, c, 4).topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def _decided(logits, margin=1e-3):
    top2 = logits.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) > margin


# ragged tiles in every kernel, one tile, and batch 3
SHAPES = [(2, 72, 88, 3), (1, 8, 8, 3), (3, 64, 96, 3), (1, 136, 40, 3)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernels_match_plain_versions(model, shape):
    image = _image(shape, 1)
    n, h, w, _ = shape
    with torch.no_grad():
        x1p, m1p = front.front_stage1_plain(image, model)
        x1, m1 = front.fused_front_stage1(image, model)
        torch.testing.assert_close(x1, x1p, **TOL)
        gap = _gap(model.Initial(image))
        sw = m1.reshape(n, h // 4, w // 4, 4, 16).argmax(3)
        swp = m1p.reshape(n, h // 4, w // 4, 4, 16).argmax(3)
        assert torch.equal(sw[gap > 1e-4], swp[gap > 1e-4])

        yp, sw2p = mid.mid_stage23_plain(x1p, model)
        y, sw2 = mid.fused_mid_stage23(x1p, model)
        torch.testing.assert_close(y, yp, **TOL)
        gap = _gap(x1p)
        assert torch.equal(sw2[gap > 1e-4], sw2p[gap > 1e-4])

        labels = tail.fused_tail_predict(yp, sw2p, m1p, model)
        logits = model.forward_tail(yp, sw2p.reshape(n, h // 8, w // 8 * 64),
                                    tail.mask_to_switches(m1p))
    decided = _decided(logits)
    # not vacuous; 0.95, not 0.99, since the smallest shape has 64 pixels
    assert decided.float().mean() > 0.95
    assert torch.equal(labels.long()[decided], logits.argmax(-1)[decided])


def test_fused_predict_counts_its_launches(model):
    image = _image((2, 64, 64, 3), 2)
    # the tail's halves' own wrappers count only their own calls
    wrappers = (front.fused_front_stage1, mid.fused_mid_stage23,
                tail.fused_tail_predict, tail.fused_tail_stage4,
                tail.fused_tail_decode)
    before = [fn.launches for fn in wrappers]
    labels = model.fused_predict(image)
    torch.cuda.synchronize()
    after = [fn.launches for fn in wrappers]
    assert [a - b for a, b in zip(after, before)] == \
        [front.LAUNCHES_PER_CALL, mid.LAUNCHES_PER_CALL,
         tail.LAUNCHES_PER_CALL, 0, 0]
    assert labels.dtype == torch.int32 and labels.is_cuda
    with torch.no_grad():
        logits = model(image)
    decided = _decided(logits)
    # the chain feeds each stage slightly different fp32 inputs than
    # the plain forward, so a near-tied pool switch may flip
    agree = (labels.long() == logits.argmax(-1))[decided].float().mean()
    assert agree > 0.999


def test_wrappers_validate_their_inputs(model):
    image = _image((1, 16, 16, 3), 3)
    with pytest.raises(ValueError, match="contiguous"):
        front.fused_front_stage1(image.transpose(1, 2), model)
    with pytest.raises(TypeError):
        front.fused_front_stage1(image.double(), model)
    with pytest.raises(ValueError):
        front.fused_front_stage1(_image((1, 12, 16, 3), 3), model)
    with pytest.raises(ValueError):
        tail.fused_tail_predict(
            torch.zeros(1, 2, 2, 128, device="cuda"),
            torch.zeros(1, 2, 2, 64, dtype=torch.int8, device="cuda"),
            torch.zeros(1, 2, 2, 64, device="cuda"), model)


def test_serving_through_device_prefetch(model):
    lut = torch.arange(256, dtype=torch.uint8)
    predict = make_predict_fn(model, lut, 60, 90, 3, "cuda")
    rng = np.random.default_rng(4)
    host = [{"stack": rng.integers(0, 256, (2, 64, 96, 3), dtype=np.uint8)}
            for _ in range(3)]
    for b, src in zip(device_prefetch(iter(host), "cuda"), host):
        assert b["stack"].is_cuda
        out = predict(b["stack"])
        assert out.dtype == torch.uint8 and out.shape == (2, 60, 90)
        want = model.fused_predict(
            torch.from_numpy(src["stack"]).cuda().float() / 255.0)
        assert torch.equal(out.long(), want[:, :60, :90].long())


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_score_kernels_match_plain_versions(model, shape):
    """The tail, decoder and deconv score kernels on the plain chain's
    activations: within 1e-4 of their plain versions, and bit-equal
    from one run to the next (no atomics)."""
    image = _image(shape, 5)
    n, h, w, _ = shape
    with torch.no_grad():
        x1, m1 = front.front_stage1_plain(image, model)
        y, sw2 = mid.mid_stage23_plain(x1, model)
        f4 = model.forward_stage4(y, sw2.reshape(n, h // 8, w // 8 * 64))
        pre = model.decode_from_stage4(f4, tail.mask_to_switches(m1))
        kernel = packing.deconv_hwio(model.Final.deconv).contiguous()
        cases = [
            (lambda: tail.fused_tail_entropy_score(y, sw2, m1, model),
             tail.tail_score_plain(y, sw2, m1, model)),
            (lambda: decoder.fused_decoder_entropy_score(f4, None, model,
                                                         mask=m1),
             decoder.decoder_score_plain(f4, m1, model)),
            (lambda: deconv_score.fused_deconv_entropy_score(pre, kernel, C),
             deconv_score.deconv_score_plain(pre, kernel, C)),
        ]
        for run, want in cases:
            got = run()
            assert got.dtype == torch.float32 and got.shape == (n,)
            assert (got - want).abs().max().item() <= 1e-4
            assert torch.equal(got, run())


# the tail kernels' tiles: 16x16 quarter-res positions (stage 4) and
# 16x16 half-res positions (stage 5 + Final). Ragged on both axes in
# both kernels, one tile of each, H/8 = 6 (the least height of the score
# route) with a ragged width, and batch 3.
TAIL_SHAPES = [(1, 200, 136, 3), (1, 8, 8, 3), (2, 48, 200, 3),
               (3, 72, 88, 3)]
# (classes, score): predict pads 19, 3 and 127 classes to whole n-tiles
TAIL_CASES = [(19, False), (3, False), (127, False), (19, True), (3, True)]


@pytest.fixture(scope="module")
def tail_models():
    return {}


@pytest.mark.parametrize("classes, score", TAIL_CASES,
                         ids=lambda v: str(v))
@pytest.mark.parametrize("shape", TAIL_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_tail_kernels_match_plain_versions(tail_models, classes, score,
                                           shape):
    """The two tail kernels against the plain tail on the plain chain's
    activations: labels on decided pixels, scores within 1e-4 and
    bit-equal from one run to the next."""
    if classes not in tail_models:
        tail_models[classes] = _enet(classes)
    m = tail_models[classes]
    image = _image(shape, 9)
    n, h, w, _ = shape
    with torch.no_grad():
        x1, m1 = front.front_stage1_plain(image, m)
        y, sw2 = mid.mid_stage23_plain(x1, m)
        if score:
            got = tail.fused_tail_entropy_score(y, sw2, m1, m)
            want = tail.tail_score_plain(y, sw2, m1, m)
            assert got.dtype == torch.float32 and got.shape == (n,)
            assert (got - want).abs().max().item() <= 1e-4
            assert torch.equal(got, tail.fused_tail_entropy_score(y, sw2, m1,
                                                                  m))
            return
        labels = tail.fused_tail_predict(y, sw2, m1, m)
        logits = m.forward_tail(y, sw2.reshape(n, h // 8, w // 8 * 64),
                                tail.mask_to_switches(m1))
    assert labels.dtype == torch.int8 and labels.shape == (n, h, w)
    decided = _decided(logits)
    # not vacuous; 0.9, since 127 classes crowd the top two logits
    assert decided.float().mean() > 0.9
    assert torch.equal(labels.long()[decided], logits.argmax(-1)[decided])


@pytest.mark.parametrize("score", [False, True], ids=["predict", "score"])
def test_tail_halves_run_at_their_routes_precision(model, score):
    """``fused_tail_stage4`` and ``fused_tail_decode`` each launch one
    kernel, counted once, at the precision of their route: chained, they
    give the route wrapper's result bit for bit; x4 is within 1e-3 of
    the plain stage 4's maximum."""
    image = _image((2, 64, 96, 3), 10)
    with torch.no_grad():
        x1, m1 = front.front_stage1_plain(image, model)
        y, sw2 = mid.mid_stage23_plain(x1, model)
        f4 = model.forward_stage4(y, sw2.reshape(2, 8, 12 * 64))
        before = (tail.fused_tail_stage4.launches,
                  tail.fused_tail_decode.launches)
        x4 = tail.fused_tail_stage4(y, sw2, model, score)
        got = tail.fused_tail_decode(x4, m1, model, score)
        torch.cuda.synchronize()
        assert (tail.fused_tail_stage4.launches,
                tail.fused_tail_decode.launches) == \
            (before[0] + 1, before[1] + 1)
        route = (tail.fused_tail_entropy_score if score
                 else tail.fused_tail_predict)
        assert torch.equal(got, route(y, sw2, m1, model))
    assert (x4 - f4).abs().max() <= 1e-3 * f4.abs().max()


# the front's 16x16 quarter-res tiles: ragged on both axes, one whole
# tile, a grid smaller than one tile, batch 3
FRONT_SHAPES = [(2, 72, 136, 3), (1, 64, 64, 3), (1, 8, 8, 3),
                (3, 64, 96, 3)]


def _check_front(model, image, x1, m1, score):
    """x1 within 1e-3 of the plain maximum and under chip_smoke's
    precision gate; mask1 one-hot, exact where the pooled window of
    Initial's output is decided."""
    from chip_smoke import precision_gate  # the repo root, on sys.path
    x1p, m1p = front.front_stage1_plain(image, model)
    n, h, w, _ = image.shape
    err = (x1 - x1p).abs().max().item()
    assert x1.shape == x1p.shape and err <= 1e-3 * x1p.abs().max().item()
    precision_gate("front x1", front.PRECISION["score" if score
                                               else "predict"],
                   err, model, lambda m: front.front_stage1_plain(image, m)[0],
                   x1p, front.TC_BLOCKS)
    win = m1.reshape(n, h // 4, w // 4, 4, 16)
    assert ((m1 == 0) | (m1 == 1)).all() and (win.sum(3) == 1).all()
    gap = _gap(model.Initial(image))
    swp = m1p.reshape(n, h // 4, w // 4, 4, 16).argmax(3)
    assert torch.equal(win.argmax(3)[gap > 1e-4], swp[gap > 1e-4])


@pytest.mark.parametrize("score", [False, True], ids=["predict", "score"])
@pytest.mark.parametrize("shape", FRONT_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_front_kernels_match_plain_version_per_route(model, shape, score):
    """The front's kernels on each route against the plain front;
    LAUNCHES_PER_CALL launches a call."""
    image = _image(shape, 12)
    with torch.no_grad():
        before = front.fused_front_stage1.launches
        x1, m1 = front.fused_front_stage1(image, model, score=score)
        torch.cuda.synchronize()
        assert front.fused_front_stage1.launches - before == \
            front.LAUNCHES_PER_CALL
        _check_front(model, image, x1, m1, score)


@pytest.mark.parametrize("score", [False, True], ids=["predict", "score"])
@pytest.mark.parametrize("shape", [(2, 72, 136, 3), (1, 8, 8, 3),
                                   (3, 64, 96, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_front_launches_match_their_plain_halves(model, shape, score):
    """``ssal_front_b10`` against Initial + B1_0, and each stage-1
    bottleneck's launch against the model's block on the same input."""
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        build)
    image = _image(shape, 13)
    lib = build.library()
    pack = model.packed("front", image.device, front.pack_front)
    n, h, w, _ = image.shape
    stream = build.stream_of(image)
    with torch.no_grad():
        want, _ = front.b10_plain(image, model)
        x = torch.empty_like(want)
        m1 = torch.empty_like(want)
        build.check(lib.ssal_front_b10(
            build.ptr(image), build.ptr(pack), build.ptr(x), build.ptr(m1),
            n, h, w, int(score), stream), "front B1_0")
        torch.testing.assert_close(x, want, rtol=1e-3, atol=1e-3)
        for index in range(front.STAGE1_BLOCKS):
            y = torch.empty_like(want)
            build.check(lib.ssal_front_block(
                build.ptr(want), build.ptr(pack), build.ptr(y), n, h // 4,
                w // 4, index, int(score), stream), "front stage-1")
            want = front.block_plain(want, model, index)
            err = (y - want).abs().max().item()
            assert err <= 1e-3 * want.abs().max().item()
        torch.cuda.synchronize()


# ragged tiles, one tile, a grid narrower than dilation 16, batch 3
MID_SHAPES = [(2, 72, 280, 3), (1, 128, 128, 3), (1, 136, 40, 3),
              (3, 64, 96, 3)]


@pytest.mark.parametrize("score", [False, True], ids=["predict", "score"])
@pytest.mark.parametrize("shape", MID_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_mid_kernels_match_plain_version_per_route(model, shape, score):
    """The mid's kernels on each route against the plain mid on the
    plain front's output: y within 1e-3 of the plain maximum and under
    chip_smoke's precision gate (a share of the error of the plain mid
    with every product rounded one precision below the route's), sw2
    exact where the pooled window is decided; LAUNCHES_PER_CALL
    launches a call."""
    from chip_smoke import precision_gate  # the repo root, on sys.path
    image = _image(shape, 11)
    with torch.no_grad():
        x1, _ = front.front_stage1_plain(image, model)
        yp, sw2p = mid.mid_stage23_plain(x1, model)
        before = mid.fused_mid_stage23.launches
        y, sw2 = mid.fused_mid_stage23(x1, model, score=score)
        torch.cuda.synchronize()
    assert mid.fused_mid_stage23.launches - before == mid.LAUNCHES_PER_CALL
    assert y.shape == yp.shape and sw2.dtype == torch.int8
    err = (y - yp).abs().max().item()
    assert err <= 1e-3 * yp.abs().max().item()
    precision_gate("mid y", mid.PRECISION["score" if score else "predict"],
                   err, model, lambda m: mid.mid_stage23_plain(x1, m)[0], yp)
    gap = _gap(x1)
    assert torch.equal(sw2[gap > 1e-4], sw2p[gap > 1e-4])


def test_decoder_takes_switches_or_mask(model):
    image = _image((2, 16, 32, 3), 6)
    with torch.no_grad():
        f4, switches1 = model(image, return_stage4=True)
        by_sw = decoder.fused_decoder_entropy_score(f4, switches1, model)
        by_mask = decoder.fused_decoder_entropy_score(
            f4, None, model, mask=front.switches_to_mask(switches1))
    assert torch.equal(by_sw, by_mask)


# (fused_score flags, image shape, the wrapper the route launches)
SCORE_ROUTES = [
    ({}, (2, 48, 64, 3), "tail"),
    ({}, (2, 40, 64, 3), "decoder"),          # H/8 < 6
    (dict(fuse_tail=False), (2, 48, 64, 3), "decoder"),
    ({}, (2, 16, 32, 3), "decoder"),          # H < 24: plain encoder
    (dict(fuse_decoder=False), (2, 48, 64, 3), "deconv"),
]


@pytest.mark.parametrize("flags, shape, route", SCORE_ROUTES,
                         ids=lambda v: str(v))
def test_fused_score_routes_count_their_launches(model, flags, shape,
                                                 route):
    image = _image(shape, 7)
    wrappers = {"front": front.fused_front_stage1,
                "tail": tail.fused_tail_entropy_score,
                "decoder": decoder.fused_decoder_entropy_score,
                "deconv": deconv_score.fused_deconv_entropy_score,
                "tail_stage4": tail.fused_tail_stage4,
                "tail_decode": tail.fused_tail_decode}
    before = {k: fn.launches for k, fn in wrappers.items()}
    got = model.fused_score(image, "entropy", **flags)
    torch.cuda.synchronize()
    rose = {k: fn.launches - before[k] for k, fn in wrappers.items()}
    per_call = {"tail": tail.LAUNCHES_PER_CALL, "decoder": 1, "deconv": 1,
                "tail_stage4": 0, "tail_decode": 0}
    # the entropy routes on the decoder score kernel's side run the front
    # on inputs at least 24 rows tall
    front_calls = int(flags.get("fuse_decoder", True) and shape[1] >= 24)
    want = {k: per_call[k] * int(k == route) for k in per_call}
    want["front"] = front.LAUNCHES_PER_CALL * front_calls
    assert rose == want
    with torch.no_grad():
        want = acquisition.mean_confidence(model(image), "entropy", C)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("shape", sorted({r[1] for r in SCORE_ROUTES}),
                         ids=lambda s: "x".join(map(str, s)))
def test_decoder_route_matches_plain_version(model, shape):
    """The decoder score route (the tail's stage-5 kernel on its score
    route) on the plain chain's stage-4 features and mask at every
    SCORE_ROUTES shape (H/4 = 4: one ragged tile): within 1e-4 of
    decoder_score_plain per image, bit-equal from run to run, and
    counted by its own wrapper alone."""
    image = _image(shape, 17)
    n, h, w, _ = shape
    with torch.no_grad():
        x1, m1 = front.front_stage1_plain(image, model)
        y, sw2 = mid.mid_stage23_plain(x1, model)
        f4 = model.forward_stage4(y, sw2.reshape(n, h // 8, w // 8 * 64))
        want = decoder.decoder_score_plain(f4, m1, model)
        before = (decoder.fused_decoder_entropy_score.launches,
                  tail.fused_tail_decode.launches,
                  tail.fused_tail_entropy_score.launches)
        got = decoder.fused_decoder_entropy_score(f4, None, model, mask=m1)
        again = decoder.fused_decoder_entropy_score(f4, None, model, mask=m1)
    torch.cuda.synchronize()
    assert (decoder.fused_decoder_entropy_score.launches - before[0],
            tail.fused_tail_decode.launches - before[1],
            tail.fused_tail_entropy_score.launches - before[2]) == (2, 0, 0)
    assert got.shape == (n,) and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4
    assert torch.equal(got, again)


# (N, H2, W2) of pre-Final features against the deconv kernel's tiles
# of 16x16 half-res positions: ragged on both axes, one tile, a grid
# under one tile, batch 3 with ragged rows, more ragged rows of tiles
DECONV_SHAPES = [(2, 20, 36), (1, 16, 16), (1, 8, 20), (3, 33, 17),
                 (1, 70, 40)]


@pytest.mark.parametrize("classes", [5, 19, 30])
@pytest.mark.parametrize("shape", DECONV_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_deconv_kernel_matches_plain_version(tail_models, shape, classes):
    """The deconv score kernel (the tail's Final in one TF32 pass, one
    to four n-tiles a chunk of classes) on seeded features: within 1e-4
    of deconv_score_plain per image, bit-equal from run to run and with
    the record passed or packed by the wrapper, one launch a call; its
    per-tile sums (deconv_partials) within 1e-4 a pixel of
    deconv_partials_plain."""
    if classes not in tail_models:
        tail_models[classes] = _enet(classes)
    kernel = packing.deconv_hwio(
        tail_models[classes].Final.deconv).contiguous()
    rng = np.random.default_rng(19)
    pre = torch.from_numpy(np.maximum(rng.normal(size=(*shape, 16)), 0)
                           .astype(np.float32)).cuda()
    record = tail.pack_final(kernel, classes)
    before = deconv_score.fused_deconv_entropy_score.launches
    with torch.no_grad():
        got = deconv_score.fused_deconv_entropy_score(pre, kernel, classes)
        again = deconv_score.fused_deconv_entropy_score(pre, kernel, classes,
                                                        record=record)
        want = deconv_score.deconv_score_plain(pre, kernel, classes)
        parts = deconv_score.deconv_partials(pre, kernel, classes,
                                             record=record)
        want_t = deconv_score.deconv_partials_plain(pre, kernel, classes)
    assert deconv_score.fused_deconv_entropy_score.launches - before == 3
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    assert (got - want).abs().max().item() <= 1e-4
    assert torch.equal(got, again)
    assert parts.shape == want_t.shape
    assert (parts - want_t).abs().max().item() <= 1e-4 * 32 * 32


def test_deconv_kernel_on_the_tensor_cores_without_spills():
    """ptxas: no deconv score kernel instance (1-4 n-tiles a chunk)
    spills; SASS: each has HMMA (tensor-core) instructions, its
    Final's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from chip_smoke import DECONV_INSTANCES, hmma_counts, ptxas_spills
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        build)
    b = build.build()
    spills = {fn: n for fn, n in ptxas_spills(b.log).items()
              if "deconv_score_kernel" in fn}
    assert len(spills) == DECONV_INSTANCES and not any(spills.values()), \
        spills
    counts = hmma_counts(b.path)
    if not counts:
        pytest.skip("the toolkit has no cuobjdump: SASS not read")
    hmma = {fn: n for fn, n in counts.items() if "deconv_score_kernel" in fn}
    assert len(hmma) == DECONV_INSTANCES and all(hmma.values()), hmma


def test_score_step_through_device_prefetch(model):
    score = make_score_step(model, C, "entropy")
    plain = make_score_step(model, C, "entropy", fused=False)
    rng = np.random.default_rng(8)
    host = [{"stack": rng.integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)}
            for _ in range(2)]
    launches = tail.fused_tail_entropy_score.launches
    for b in device_prefetch(iter(host), "cuda"):
        image = b["stack"].float() / 255.0
        got, want = score({"image": image}), plain({"image": image})
        assert got.is_cuda and got.shape == (2,)
        assert (got - want).abs().max().item() <= 1e-4
    assert tail.fused_tail_entropy_score.launches == \
        launches + 2 * tail.LAUNCHES_PER_CALL


# -- ICNet -------------------------------------------------------------------

@pytest.fixture(scope="module")
def icnet():
    """ICNet-19 with chip_smoke.py's seeded ICNet weights and the
    classifier x5, so that the scores sit inside (0, 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from chip_smoke import seeded_state_dict  # the repo root, on sys.path
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    m = ICNet(C)
    m.load_state_dict(seeded_state_dict(m, 1, 5.0, "ICNet"))
    return m.cuda().eval()


# multi-tile; ragged front and head tiles (W/8 = 20, H/8 = 12); one tile
# at batch 3; a wide ragged grid (W/8 = 44, H/8 = 20)
ICNET_SHAPES = [(2, 64, 96, 3), (1, 96, 160, 3), (3, 32, 32, 3),
                (1, 160, 352, 3)]


@pytest.mark.parametrize("shape", ICNET_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_icnet_kernels_match_plain_versions(icnet, shape):
    """The front, front+stem, CFF2 + head and head kernels on the plain
    chain's activations: features within 1e-4, scores within 1e-4 and
    bit-equal from one run to the next."""
    image = _image(shape, 9)
    n = shape[0]
    with torch.no_grad():
        f1p, xhp = icnet_front.icnet_front_plain(image, icnet)
        f1, xh = icnet_front.fused_icnet_front(image, icnet)
        torch.testing.assert_close(f1, f1p, **TOL)
        torch.testing.assert_close(xh, xhp, rtol=1e-5, atol=1e-5)
        stp = icnet.SharedStem.front(xhp)
        f1s, st = icnet_front.fused_icnet_front_stem(image, icnet)
        assert torch.equal(f1s, f1)
        torch.testing.assert_close(st, stp, **TOL)
        fused16 = icnet.fuse_to_cff1(stp)
        fused8 = icnet.CFF2(fused16, f1p)[0]
        wcls, bcls = icnet.packed("classifier", image.device,
                                  icnet_head.pack_classifier)
        cases = [
            (lambda: icnet_head.fused_cff2_head8_entropy_score(
                fused16, f1p, icnet),
             icnet_head.cff2_head8_entropy_score_plain(fused16, f1p, icnet)),
            (lambda: icnet_head.fused_head8_entropy_score(fused8, wcls, bcls,
                                                          C),
             icnet_head.head8_entropy_score_plain(fused8, wcls, bcls, C)),
        ]
        for run, want in cases:
            got = run()
            assert got.dtype == torch.float32 and got.shape == (n,)
            assert ((0.05 < got) & (got < 0.95)).all()
            assert (got - want).abs().max().item() <= 1e-4
            assert torch.equal(got, run())


# launches a call of a wrapper that launches more than one kernel
PER_CALL = {"front_stem": icnet_front.LAUNCHES_PER_CALL}
@pytest.mark.parametrize("score", [False, True], ids=["predict", "score"])
@pytest.mark.parametrize("shape", ICNET_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_icnet_fronts_on_both_routes(icnet, shape, score):
    """Both front entries on each route against their plain versions: f1
    and stem1 within 1e-4 of their maxima in 3xTF32 (predict), 1e-3 in
    one TF32 pass (score); x_half within 1e-5; f1 bit-equal between the
    entries; each route's error under a tenth (3xTF32) or a half (TF32)
    of its plain version's with all six convs' products one precision
    below (chip_smoke.py PRECISION_GATE); one launch for the front,
    LAUNCHES_PER_CALL for the front + stem."""
    from chip_smoke import PRECISION_GATE, rounded
    image = _image(shape, 17)
    precision = icnet_front.PRECISION["score" if score else "predict"]
    tol = 1e-3 if score else 1e-4
    before = (icnet_front.fused_icnet_front.launches,
              icnet_front.fused_icnet_front_stem.launches)
    with torch.no_grad():
        f1p, xhp = icnet_front.icnet_front_plain(image, icnet)
        stp = icnet.SharedStem.front(xhp)
        f1, xh = icnet_front.fused_icnet_front(image, icnet, score=score)
        f1s, st = icnet_front.fused_icnet_front_stem(image, icnet,
                                                     score=score)
        torch.cuda.synchronize()
        assert (icnet_front.fused_icnet_front.launches - before[0],
                icnet_front.fused_icnet_front_stem.launches - before[1]) \
            == (1, icnet_front.LAUNCHES_PER_CALL)
        assert torch.equal(f1, f1s)
        assert (xh - xhp).abs().max().item() <= 1e-5
        _, rnd, share = PRECISION_GATE[precision]
        lower = rounded(icnet, rnd, lambda m: icnet_front.icnet_front_stem_plain(
            image, m), icnet_front.TC_CONVS)
        for got, want, low in ((f1, f1p, lower[0]), (st, stp, lower[1])):
            err = (got - want).abs().max().item()
            assert err <= tol * want.abs().max().item()
            assert err <= share * (low - want).abs().max().item()


@pytest.mark.parametrize("score", [False, True], ids=["predict", "score"])
def test_icnet_front_launches_alone(icnet, score):
    """Each launch of icnet_front.PARTS against its plain part (stem3 on
    the plain conv1_2 output), ragged against every tile (96x160)."""
    image = _image((2, 96, 160, 3), 18)
    tol = 1e-3 if score else 1e-4
    stem = icnet.SharedStem
    with torch.no_grad():
        f1, x_half = icnet_front.icnet_front_plain(image, icnet)
        c12 = stem.conv1_2(stem.conv1_1(x_half))
        want = dict(f1=f1, x_half=x_half, c12=c12, stem1=stem.front(x_half))
        outs = {"branch1": ("f1",), "front": ("f1", "x_half"),
                "stem12": ("c12",), "stem3": ("stem1",)}
        assert set(outs) == set(icnet_front.PARTS)
        for part, names in outs.items():
            got = icnet_front.launch_part(part, c12 if part == "stem3"
                                          else image, icnet, score, (96, 160))
            for g, k in zip(got, names):
                bound = 1e-5 if k == "x_half" else \
                    tol * want[k].abs().max().item()
                assert (g - want[k]).abs().max().item() <= bound, (part, k)


def test_icnet_front_kernels_on_the_tensor_cores_without_spills():
    """ptxas: no ICNet front kernel instance spills; SASS: each has HMMA
    (tensor-core) instructions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from chip_smoke import ICNET_FRONT, hmma_counts, ptxas_spills
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        build)
    b = build.build()
    spills = {fn: n for fn, n in ptxas_spills(b.log).items()
              if any(k in fn for k in ICNET_FRONT)}
    # a kernel a part (the front's: branch1_kernel<true>), two routes
    instances = 2 * len(icnet_front.PARTS)
    assert len(spills) == instances and not any(spills.values()), spills
    counts = hmma_counts(b.path)
    if not counts:
        pytest.skip("the toolkit has no cuobjdump: SASS not read")
    hmma = {fn: n for fn, n in counts.items()
            if any(k in fn for k in ICNET_FRONT)}
    assert len(hmma) == instances and all(hmma.values()), hmma


# (route, fused_score flags, the wrappers the route launches)
ICNET_ROUTES = [
    ("default", {}, ("front_stem", "cff2_head")),
    ("no_cff2", dict(fuse_cff2=False), ("front_stem", "head8")),
    ("no_stem", dict(fuse_stem=False), ("front", "head8")),
]


@pytest.mark.parametrize("name, flags, route", ICNET_ROUTES,
                         ids=[r[0] for r in ICNET_ROUTES])
def test_icnet_fused_score_routes_count_their_launches(icnet, name, flags,
                                                       route):
    image = _image((2, 64, 96, 3), 10)
    wrappers = {"front": icnet_front.fused_icnet_front,
                "front_stem": icnet_front.fused_icnet_front_stem,
                "cff2_head": icnet_head.fused_cff2_head8_entropy_score,
                "head8": icnet_head.fused_head8_entropy_score}
    before = {k: fn.launches for k, fn in wrappers.items()}
    got = icnet.fused_score(image, "entropy", **flags)
    torch.cuda.synchronize()
    rose = {k: fn.launches - before[k] for k, fn in wrappers.items()}
    assert rose == {k: int(k in route) * PER_CALL.get(k, 1)
                    for k in wrappers}
    with torch.no_grad():
        want = acquisition.mean_confidence(icnet(image), "entropy", C)
    assert (got - want).abs().max().item() <= 1e-4


def test_icnet_wrappers_validate_their_inputs(icnet):
    image = _image((1, 32, 64, 3), 11)
    with pytest.raises(TypeError):
        icnet_front.fused_icnet_front(image.double(), icnet)
    with pytest.raises(ValueError, match="multiples of 32"):
        icnet_front.fused_icnet_front_stem(_image((1, 48, 64, 3), 11), icnet)
    with pytest.raises(ValueError, match="contiguous"):
        icnet_front.fused_icnet_front(image.transpose(1, 2), icnet)
    f16 = torch.zeros(1, 2, 4, 128, device="cuda")
    with pytest.raises(ValueError, match="f1"):
        icnet_head.fused_cff2_head8_entropy_score(
            f16, torch.zeros(1, 4, 4, 64, device="cuda"), icnet)
    with pytest.raises(ValueError, match="CUDA"):
        icnet_head.fused_head8_entropy_score(
            torch.zeros(1, 4, 8, 128, device="cuda"), torch.zeros(128, C),
            torch.zeros(C), C)
    with pytest.raises(ValueError, match="features8"):
        icnet_head.fused_head8_entropy_score(
            torch.zeros(1, 4, 8, 64, device="cuda"),
            torch.zeros(128, C, device="cuda"), torch.zeros(C, device="cuda"),
            C)


def test_icnet_score_step_through_device_prefetch(icnet):
    score = make_score_step(icnet, C, "entropy")
    plain = make_score_step(icnet, C, "entropy", fused=False)
    rng = np.random.default_rng(12)
    host = [{"stack": rng.integers(0, 256, (2, 64, 96, 3), dtype=np.uint8)}
            for _ in range(2)]
    launches = icnet_head.fused_cff2_head8_entropy_score.launches
    for b in device_prefetch(iter(host), "cuda"):
        image = b["stack"].float() / 255.0
        got, want = score({"image": image}), plain({"image": image})
        assert got.is_cuda and got.shape == (2,)
        assert (got - want).abs().max().item() <= 1e-4
    assert icnet_head.fused_cff2_head8_entropy_score.launches == launches + 2


# -- ICNet serving ---------------------------------------------------------

def _labels_agree(labels, logits):
    """Labels equal the argmax where the top-2 margin exceeds 1e-3, and
    that is most pixels."""
    decided = _decided(logits)
    assert decided.float().mean() > 0.99
    assert torch.equal(labels.long()[decided], logits.argmax(-1)[decided])


@pytest.mark.parametrize("shape", ICNET_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_icnet_predict_kernels_match_plain_versions(icnet, shape):
    """The CFF2 + head and head predict kernels on the plain chain's
    fused16 / fused8, on random inputs (a transposed phase would pass on
    a constant image), ragged tiles (W/8 = 20, 44) and one tile."""
    image = _image(shape, 13)
    n, h, w, _ = shape
    with torch.no_grad():
        f1, x_half = icnet_front.icnet_front_plain(image, icnet)
        fused16 = icnet.fuse_to_cff1(icnet.SharedStem.front(x_half))
        fused8 = icnet.CFF2(fused16, f1)[0]
        logits = xops.resize_bilinear(icnet.head_pre_logits(fused8), (h, w))
        wcls, bcls = icnet.packed("classifier", image.device,
                                  icnet_head.pack_classifier)
        for labels in (icnet_head.fused_cff2_head8_predict(fused16, f1, icnet),
                       icnet_head.fused_head8_predict(fused8, wcls, bcls, C)):
            assert labels.dtype == torch.int8 and labels.shape == (n, h, w)
            _labels_agree(labels, logits)


# H8 x W8 = 12 x 20, 20 x 44 and 28 x 12: no multiple of either tile shape
CFF2_SHAPES = [(1, 96, 160, 3), (2, 160, 352, 3), (1, 224, 96, 3)]


@pytest.mark.parametrize("shape", CFF2_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_cff2_tiles_match_plain_versions(icnet, shape):
    """The CFF2 + head kernel's ragged tiles on both routes, against
    the plain CFF2 + head: the GEMM alone (fused8 within 1e-3 of its
    maximum in one TF32 pass, 1e-4 in 3xTF32), the scores within 1e-4
    and bit-equal from run to run, the labels on decided pixels."""
    image = _image(shape, 16)
    n, h, w, _ = shape
    with torch.no_grad():
        f1, x_half = icnet_front.icnet_front_plain(image, icnet)
        fused16 = icnet.fuse_to_cff1(icnet.SharedStem.front(x_half))
        fused8 = icnet.CFF2(fused16, f1)[0]
        top = fused8.abs().max().item()
        for route, tol in (("score", 1e-3), ("predict", 1e-4)):
            f8 = icnet_head.launch_cff2(f"fused8_{route}", fused16, f1,
                                        icnet)
            assert (f8 - fused8).abs().max().item() <= tol * top
        run = lambda: icnet_head.launch_cff2("score", fused16, f1,
                                             icnet).sum(1) / (h * w)
        got = run()
        want = icnet_head.cff2_head8_entropy_score_plain(fused16, f1, icnet)
        assert got.shape == (n,) and ((0.05 < got) & (got < 0.95)).all()
        assert (got - want).abs().max().item() <= 1e-4
        assert torch.equal(got, run())
        labels = icnet_head.launch_cff2("predict", fused16, f1, icnet)
        logits = xops.resize_bilinear(icnet.head_pre_logits(fused8), (h, w))
        assert labels.dtype == torch.int8 and labels.shape == (n, h, w)
        _labels_agree(labels, logits)


ICNET_PREDICT_ROUTES = [
    ("default", {}, ("front_stem", "cff2_head")),
    ("no_cff2", dict(fuse_cff2=False), ("front_stem", "head8")),
    ("no_stem", dict(fuse_stem=False), ("front", "head8")),
]


@pytest.mark.parametrize("name, flags, route", ICNET_PREDICT_ROUTES,
                         ids=[r[0] for r in ICNET_PREDICT_ROUTES])
def test_icnet_fused_predict_routes_count_their_launches(icnet, name, flags,
                                                         route):
    image = _image((2, 64, 96, 3), 14)
    wrappers = {"front": icnet_front.fused_icnet_front,
                "front_stem": icnet_front.fused_icnet_front_stem,
                "cff2_head": icnet_head.fused_cff2_head8_predict,
                "head8": icnet_head.fused_head8_predict}
    before = {k: fn.launches for k, fn in wrappers.items()}
    labels = icnet.fused_predict(image, **flags)
    torch.cuda.synchronize()
    rose = {k: fn.launches - before[k] for k, fn in wrappers.items()}
    assert rose == {k: int(k in route) * PER_CALL.get(k, 1)
                    for k in wrappers}
    assert labels.dtype == torch.int32 and labels.shape == (2, 64, 96)
    with torch.no_grad():
        logits = icnet(image)
    decided = _decided(logits)
    # the chain feeds each stage slightly different fp32 inputs than the
    # plain forward, so a near-tied max-pool window may flip
    agree = (labels.long() == logits.argmax(-1))[decided].float().mean()
    assert agree > 0.999


def test_icnet_serving_through_device_prefetch(icnet):
    lut = torch.arange(256, dtype=torch.uint8)
    predict = make_predict_fn(icnet, lut, 60, 90, 3, "cuda")
    rng = np.random.default_rng(15)
    host = [{"stack": rng.integers(0, 256, (2, 64, 96, 3), dtype=np.uint8)}
            for _ in range(2)]
    launches = icnet_head.fused_cff2_head8_predict.launches
    for b, src in zip(device_prefetch(iter(host), "cuda"), host):
        out = predict(b["stack"])
        assert out.dtype == torch.uint8 and out.shape == (2, 60, 90)
        want = icnet.fused_predict(
            torch.from_numpy(src["stack"]).cuda().float() / 255.0)
        assert torch.equal(out.long(), want[:, :60, :90].long())
    assert icnet_head.fused_cff2_head8_predict.launches == launches + 4


# (N, H8, W8) of fused8 against the head kernel's 16x8 tiles: ragged on
# both axes, one tile, a grid under one tile, batch 3 with ragged rows
HEAD8_SHAPES = [(1, 18, 10), (1, 16, 8), (1, 4, 4), (3, 20, 12)]


@pytest.mark.parametrize("shape", HEAD8_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_head8_kernel_matches_plain_versions(icnet, shape):
    """The head kernel on both routes against its plain versions on a
    fused8 from the plain CFF2 of seeded inputs: scores within 1e-4 and
    bit-equal from run to run, labels equal where the plain logits'
    top-2 margin exceeds 1e-3 (most pixels)."""
    n, h8, w8 = shape
    rng = np.random.default_rng(18)
    f16 = torch.from_numpy((0.5 * rng.normal(
        size=(n, h8 // 2, w8 // 2, 128))).astype(np.float32)).cuda()
    f1 = torch.from_numpy((0.5 * np.maximum(rng.normal(
        size=(n, h8, w8, 64)), 0)).astype(np.float32)).cuda()
    with torch.no_grad():
        fused8 = icnet.CFF2(f16, f1)[0]
        wcls, bcls = icnet.packed("classifier", fused8.device,
                                  icnet_head.pack_classifier)
        run = lambda: icnet_head.fused_head8_entropy_score(fused8, wcls,
                                                           bcls, C)
        got = run()
        want = icnet_head.head8_entropy_score_plain(fused8, wcls, bcls, C)
        labels = icnet_head.fused_head8_predict(fused8, wcls, bcls, C)
        logits = xops.resize_bilinear(icnet.head_pre_logits(fused8),
                                      (8 * h8, 8 * w8))
    assert got.shape == (n,) and ((0.05 < got) & (got < 0.95)).all()
    assert (got - want).abs().max().item() <= 1e-4
    assert torch.equal(got, run())
    assert labels.dtype == torch.int8 and labels.shape == (n, 8 * h8, 8 * w8)
    decided = _decided(logits)
    # 0.95, not 0.99: the smallest grid has 1024 pixels
    assert decided.float().mean() > 0.95
    assert torch.equal(labels.long()[decided], logits.argmax(-1)[decided])


def test_head8_kernel_on_the_tensor_cores_without_spills():
    """ptxas: neither head kernel instance spills; SASS: each has HMMA
    (tensor-core) instructions, its classifier's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from chip_smoke import hmma_counts, ptxas_spills
    from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
        build)
    b = build.build()
    spills = {fn: n for fn, n in ptxas_spills(b.log).items()
              if "head8_kernel" in fn}
    assert len(spills) == 2 and not any(spills.values()), spills
    counts = hmma_counts(b.path)
    if not counts:
        pytest.skip("the toolkit has no cuobjdump: SASS not read")
    hmma = {fn: n for fn, n in counts.items() if "head8_kernel" in fn}
    assert len(hmma) == 2 and all(hmma.values()), hmma


def test_predict_kernels_reject_more_than_127_classes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    big = ICNet(128).cuda().eval()
    with pytest.raises(ValueError, match="int8"):
        icnet_head.fused_cff2_head8_predict(
            torch.zeros(1, 2, 2, 128, device="cuda"),
            torch.zeros(1, 4, 4, 64, device="cuda"), big)
    with pytest.raises(ValueError, match="int8"):
        icnet_head.fused_head8_predict(
            torch.zeros(1, 4, 4, 128, device="cuda"),
            torch.zeros(128, 128, device="cuda"),
            torch.zeros(128, device="cuda"), 128)


# -- the rigs --------------------------------------------------------------

def test_launch_rig_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    y, sw, m1, consts = rigs.launch_inputs(2, 16, 24, 5, 0, "cuda")
    launches = rigs.probe_launch.launches
    for cs in ([], consts):
        got = rigs.probe_launch(y, sw, m1, cs, 4)
        want = rigs.probe_launch_plain(y, sw, m1, cs, 4)
        scale = rigs.probe_launch_plain(y.abs(), sw.abs(), m1.abs(),
                                        [c.abs() for c in cs], 4)
        for g, w_, s in zip(got, want, scale):
            assert g.shape == (2, 4)
            assert ((g - w_).abs() <= 1e-5 * s).all()
    assert rigs.probe_launch.launches == launches + 2


# (mode, output columns, dtype, rows, products, relative tolerance)
RIG_CASES = [(mode, 128, dt, 256, 7, tol)
             for mode in ("indep", "chain", "prelu")
             for dt, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5))]
RIG_CASES += [("nside", 16, torch.bfloat16, 256, 3, 1e-2),
              ("nside", 16, torch.float32, 1024, 3, 1e-5)]


@pytest.mark.parametrize("mode, n_cols, dtype, rows, m, tol", RIG_CASES,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_matmul_rig_matches_plain_version(mode, n_cols, dtype, rows, m, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    a, w = rigs.matmul_inputs(3, rows, n_cols, dtype, 1, "cuda")
    got = rigs.probe_matmul(a, w, m, mode)
    final = rigs.matmul_final_plain(a, w, m, mode)
    assert got.shape == (3,)
    assert ((got - final.sum(dim=1)).abs() <= tol * final.abs().sum(dim=1)
            ).all()


# -- the training slice (no kernel: plain PyTorch with cuDNN) ------------

def _train_pair(multiscale):
    """(state on the card, state on the CPU): the same seeded ENet-19
    with dropout rates 0 and SGD, TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from semanticsegmentationactivelearning_tpu_torch.train import (optim,
                                                                     steps)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    hp = {"learning_rate": 5e-4, "optimizer": {"type": "SGD"},
          "weight_reg": {"L2": 2e-4},
          "softmax": {"multiscale": multiscale,
                      "loginverse_scaling": 0.0 if multiscale else 1.02}}
    states = []
    for dev in ("cuda", "cpu"):
        m = ENet(C, drop_rates=(0.0,) * 5, multiscale_heads=multiscale)
        m = m.to(dev)
        opt, sched = optim.make_optimizer(m.parameters(), hp)
        states.append(steps.create_train_state(m, opt, sched, seed=0))
    return states, steps.make_train_step(states[0].model, C, hp)


@pytest.mark.parametrize("multiscale", [True, False])
def test_train_step_on_the_card_matches_the_cpu(multiscale):
    """One train step at 2x64x128 on the card and on the CPU from the
    same weights and batch, fp32: loss to 1e-4 relative, each parameter
    after the step to 1e-5 absolute, the running statistics to 1e-4."""
    from semanticsegmentationactivelearning_tpu_torch.data import pipeline
    (gpu, cpu), step = _train_pair(multiscale)
    rng = np.random.default_rng(1)
    stack = np.concatenate([rng.integers(0, 256, (2, 64, 128, 3)),
                            rng.integers(0, C, (2, 64, 128, 1))], -1)
    outs = []
    for state in (gpu, cpu):
        dev = next(state.model.parameters()).device
        t = torch.from_numpy(stack.astype(np.uint8)).to(dev)
        draws = (torch.zeros(2), torch.zeros(2),
                 torch.tensor([False, True]), torch.full((2, 1, 1, 3), 0.9))
        _, image, label, mask = pipeline.crop_flip_scale(
            t, *[d.to(dev) for d in draws], crop_hw=(64, 128))
        outs.append(step(state, {"image": image, "label": label,
                                 "mask": mask,
                                 "valid": torch.ones(2, device=dev)}))
    np.testing.assert_allclose(outs[0]["loss"].item(), outs[1]["loss"].item(),
                               rtol=1e-4)
    want = cpu.model.state_dict()
    for k, v in gpu.model.state_dict().items():
        atol = 1e-4 if "running" in k else 1e-5
        np.testing.assert_allclose(v.cpu().numpy(), want[k].numpy(),
                                   rtol=0, atol=atol, err_msg=k)


def test_augment_core_on_the_card_equals_the_cpu():
    """The same draws give the same crops, labels and masks bit for bit
    and the same scaled images to one float32 rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from semanticsegmentationactivelearning_tpu_torch.data import pipeline
    rng = np.random.default_rng(2)
    stack = torch.from_numpy(rng.integers(0, 256, (4, 80, 120, 4))
                             .astype(np.uint8))
    heights, widths = [80, 70, 64, 50], [120, 100, 96, 90]
    draws = pipeline.draw_augmentation(heights, widths, (64, 96), 3,
                                       torch.Generator().manual_seed(0))
    cpu = pipeline.crop_flip_scale(stack, *draws, crop_hw=(64, 96))
    gpu = pipeline.crop_flip_scale(stack.cuda(),
                                   *[d.cuda() for d in draws],
                                   crop_hw=(64, 96))
    for name, a, b in zip(("raw", "image", "label", "mask"), cpu, gpu):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=2e-7,
                                   atol=0, err_msg=name)
    gen = torch.Generator("cuda").manual_seed(0)
    out = pipeline.augment_batch(stack.cuda(), heights, widths, gen,
                                 (64, 96))
    assert out[0].device.type == "cuda" and out[0].shape == (4, 64, 96, 3)
