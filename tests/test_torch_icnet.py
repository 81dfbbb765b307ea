"""The PyTorch port's ICNet against the JAX package's, fp32 on the CPU:
the weight bridge and checkpoints, the rules that the port must follow
to match XLA (stride-2 SAME padding, the -inf max pool, the antialiased
downsample, the pyramid pooling windows), the whole forward, the kernel
seams, ``ICNet.fused_score`` on every route and measure,
``make_score_step``, ``ICNet.fused_predict`` on every route, and serving
(``make_predict_fn``, ``--output-size`` and the inference CLI). Weights
come from one jitted ``ICNet.init`` in JAX at ``tests/test_icnet.py``'s
64x96 (a 2-tile grid of every ICNet kernel), with noised BatchNorm
statistics, through ``train/bridge.py``; the
classifier kernel is scaled by 25 on both sides so that the scores sit
well away from 0.

On the CPU each kernel wrapper runs its plain version, so the
``fused_score`` routes here are the plain chains that the CUDA kernels
are held against on the card (chip_smoke.py phases 7 and 8 and the
``cuda``-marked tests of test_torch_cuda.py).

Tolerances: features rtol 1e-4 / atol 1e-5 and scores rtol 1e-4 / atol
1e-5, as tests/test_icnet.py holds the Pallas kernels (fp32 sums in
another order through ~60 conv layers); logits atol 1e-5 times the
classifier's scale of 25, which multiplies the features' differences;
labels equal wherever the JAX logits' top-2 margin exceeds 1e-3 (or the
resized probabilities' 1e-5), on at least 99% of the pixels."""

import io
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

import inference as jax_inference
from semanticsegmentationactivelearning_tpu import datasets as jax_datasets
from semanticsegmentationactivelearning_tpu.data import (
    example as jax_example)
from semanticsegmentationactivelearning_tpu.data import (
    tfrecord as jax_tfrecord)
from semanticsegmentationactivelearning_tpu.models.icnet import (
    ICNet as JaxICNet, PyramidPooling as JaxPyramidPooling)
from semanticsegmentationactivelearning_tpu.train import (
    checkpoint as jax_checkpoint)
from semanticsegmentationactivelearning_tpu.train import steps as jax_steps
from semanticsegmentationactivelearning_tpu_torch import inference
from semanticsegmentationactivelearning_tpu_torch.models import (
    ICNet, get_model)
from semanticsegmentationactivelearning_tpu_torch.models.icnet import (
    PyramidPooling)
from semanticsegmentationactivelearning_tpu_torch.ops import nn as xops
from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
    icnet_front, icnet_head)
from semanticsegmentationactivelearning_tpu_torch.train import (
    bridge, checkpoint, steps)

from _torch_parity import (assert_labels_match, decided, fast_jit,
                           icnet_variables, port_icnet, to_numpy_tree)

HW = (64, 96)
C = 5
CLS_SCALE = 25.0
FEATURE_TOL = dict(rtol=1e-4, atol=1e-5)
# the scaled classifier multiplies the features' differences by its scale
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5 * CLS_SCALE)
SCORE_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process while the suite's workers share the
    cores: with a thread per core in each worker this file's torch work
    ran tens of times slower than alone. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    jm, v = icnet_variables(C, HW, 0)
    params = dict(v["params"])
    cls = params["Classifier"]
    params["Classifier"] = {"kernel": cls["kernel"] * CLS_SCALE,
                            "bias": cls["bias"]}
    variables = {"params": params, "batch_stats": v["batch_stats"]}
    return jm, variables, port_icnet(variables, C)


def _image(shape, seed):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _close(got, want, tol=FEATURE_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# -- weights --------------------------------------------------------------

def test_bridge_maps_every_icnet_weight(setup):
    """Every flax leaf has a port key and back (strict load), the cascade
    classifiers included; kernels are transposed, biases kept."""
    _, variables, tm = setup
    converted = bridge.state_dict_from_flax(to_numpy_tree(variables))
    assert converted.keys() == tm.state_dict().keys()
    assert {"CFF1.aux_cls.weight", "CFF2.aux_cls.bias", "Classifier.bias",
            "LowResTail.res5_3.expand.bn.running_var"} <= converted.keys()
    p = variables["params"]
    np.testing.assert_array_equal(
        tm.SharedStem.res3_1.conv.conv.weight.detach().numpy(),
        np.transpose(np.asarray(p["SharedStem"]["res3_1"]["conv"]["conv"]
                                ["kernel"]), (3, 2, 0, 1)))
    np.testing.assert_array_equal(tm.Classifier.bias.detach().numpy(),
                                  np.asarray(p["Classifier"]["bias"]))
    n_params = sum(np.prod(a.shape) for a in jax.tree.leaves(p))
    assert n_params == sum(t.numel() for t in tm.parameters())


def test_jax_checkpoint_restores_icnet(setup, tmp_path):
    """A JAX ICNet TrainState written by the JAX package's checkpoint
    module loads strictly into the port's ICNet."""
    _, variables, tm = setup
    path = jax_checkpoint.save_checkpoint(str(tmp_path / "model-1.ckpt"),
                                          _train_state(variables))
    model = ICNet(C)
    restored = checkpoint.restore_checkpoint(str(tmp_path), model)
    want = tm.state_dict()
    assert bridge.is_jax_checkpoint(path) and restored.keys() == want.keys()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)


# -- the rules that keep the port on XLA's numbers ------------------------

# (module, getter on the port, JAX method, input shape)
STRIDE2 = [
    ("Branch1_1", lambda m: m.Branch1_1, lambda m, x: m.branch1_1(x, False),
     (1, 32, 48, 3)),
    ("conv1_1", lambda m: m.SharedStem.conv1_1,
     lambda m, x: m.stem.conv1_1(x, False), (1, 32, 48, 3)),
    ("res3_1", lambda m: m.SharedStem.res3_1,
     lambda m, x: m.stem.res3_1(x, False), (1, 8, 12, 128)),
]


@pytest.mark.parametrize("name, getter, jax_fn, shape", STRIDE2,
                         ids=[s[0] for s in STRIDE2])
def test_stride2_convs_pad_low_zero(setup, name, getter, jax_fn, shape):
    """Stride-2 3x3 SAME convs pad (0, 1); torch's symmetric padding=1
    would not match."""
    jm, variables, tm = setup
    x = _image(shape, 1)
    want = jm.apply(variables, jnp.asarray(x), method=jax_fn)
    with torch.no_grad():
        got = getter(tm)(torch.from_numpy(x))
        _close(got, want)
        if name == "res3_1":
            return
        # not vacuous: the symmetric padding differs
        xc, weight = torch.from_numpy(x).permute(0, 3, 1, 2), \
            getter(tm).conv.weight
        sym = F.conv2d(xc, weight, stride=2, padding=1)
        low = F.conv2d(F.pad(xc, (0, 1, 0, 1)), weight, stride=2)
        assert (sym - low).abs().max() > 1e-2


def test_max_pool_pads_with_minus_inf():
    """The SAME 3x3/s2 max pool pads (0, 1) with -inf, so negative inputs
    at the high edge keep their own maximum."""
    x = _image((2, 8, 12, 4), 2) - 2.0
    want = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                        padding="SAME")
    got = xops.max_pool_3x3_same(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got < 0).all()


@pytest.mark.parametrize("shape", [(1, 64, 96, 3), (2, 8, 12, 256)])
def test_downsample_is_antialiased(shape):
    """A jax.image.resize bilinear 2x downsample is antialiased (taps
    (1, 3, 3, 1)/8, (3, 3, 1)/7 at the edges); without antialiasing the
    port would be far off."""
    x = _image(shape, 3)
    n, h, w, c = shape
    want = np.asarray(jax.image.resize(jnp.asarray(x), (n, h // 2, w // 2, c),
                                       method="bilinear"))
    got = xops.resize_bilinear(torch.from_numpy(x), (h // 2, w // 2))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    plain = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                          size=(h // 2, w // 2), mode="bilinear",
                          align_corners=False).permute(0, 2, 3, 1)
    assert np.abs(plain.numpy() - want).max() > 1e-2


@pytest.mark.parametrize("hw", [(32, 64), (5, 11), (2, 3)],
                         ids=["cell_1_32_grid", "remainders", "tiny"])
def test_pyramid_pooling_windows(hw):
    """avg_pool with window = stride = max(h // b, 1), the remainder
    dropped (not adaptive pooling), then a bilinear upsample with
    non-integer ratios; 32x64 is the cell's 1/32 grid."""
    x = _image((2, *hw, 8), 4)
    want = JaxPyramidPooling().apply({}, jnp.asarray(x), False)
    got = PyramidPooling()(torch.from_numpy(x))
    _close(got, want)


# -- the forward and the seams ---------------------------------------------

@pytest.mark.parametrize("shape", [(1, 64, 96, 3), (1, 160, 352, 3)],
                         ids=["1x64x96", "1x160x352"])
def test_forward_matches_apply(setup, shape):
    """Logits and the cascade heads; at 160x352 the 1/32 grid is 5x11,
    so the pyramid windows leave remainders and upsample by non-integer
    ratios."""
    jm, variables, tm = setup
    x = _image(shape, 5)
    # jitted: eager flax dispatch compiles every primitive anew (~10 s)
    logits, heads = jax.jit(lambda v, x: jm.apply(
        v, x, training=False, multiscale=True))(variables, jnp.asarray(x))
    with torch.no_grad():
        got, got_heads = tm(torch.from_numpy(x), multiscale=True)
    assert got.shape == shape[:3] + (C,)
    assert np.abs(np.asarray(logits)).max() > 1.0  # not vacuous
    _close(got, logits, LOGIT_TOL)
    _close(got_heads[0], heads[0], LOGIT_TOL)  # cls4
    for g, w in zip(got_heads[1:], heads[1:]):  # aux8, aux16
        _close(g, w)


def test_seams_match_jax(setup):
    """return_features8, return_pre_logits, fuse_from_front,
    fuse_to_cff1, fuse_from_stem1 and head_pre_logits against the JAX
    seams, on the port's own intermediates (one jitted reference: eager
    flax dispatch compiles every op alone)."""
    jm, variables, tm = setup
    x = _image((1, *HW, 3), 6)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        fused8 = tm(tx, return_features8=True)
        f1, x_half = icnet_front.icnet_front_plain(tx, tm)
        stem1 = tm.SharedStem.front(x_half)
        got = (fused8, tm(tx, return_pre_logits=True),
               tm.fuse_from_front(f1, x_half), tm.fuse_to_cff1(stem1),
               tm.fuse_from_stem1(f1, stem1), tm.head_pre_logits(fused8))

    def seams(v, x, f1, x_half, stem1, fused8):
        apply = lambda *a, **k: jm.apply(v, *a, **k)  # noqa: E731
        return (apply(x, training=False, return_features8=True),
                apply(x, training=False, return_pre_logits=True),
                apply(f1, x_half, method=JaxICNet.fuse_from_front),
                apply(stem1, method=JaxICNet.fuse_to_cff1),
                apply(f1, stem1, method=JaxICNet.fuse_from_stem1),
                apply(fused8, method=JaxICNet.head_pre_logits))

    args = (variables, x, *(t.numpy() for t in (f1, x_half, stem1, fused8)))
    want = fast_jit(seams, *args)(*args)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, LOGIT_TOL if i in (1, 5) else FEATURE_TOL)


# -- fused_score and the score step ------------------------------------------

# (route, fused_score flags, the port wrappers the route takes)
ROUTES = [
    ("front_stem_cff2_head", {},
     ["fused_icnet_front_stem", "fused_cff2_head8_entropy_score"]),
    ("front_stem_head", dict(fuse_cff2=False),
     ["fused_icnet_front_stem", "fused_head8_entropy_score"]),
    ("front_head", dict(fuse_stem=False),
     ["fused_icnet_front", "fused_head8_entropy_score"]),
]


@pytest.fixture(scope="module")
def jax_entropy(setup):
    """An image batch and the JAX reference score of every route,
    fused_score(use_pallas=False), jitted once."""
    jm, variables, _ = setup
    x = _image((2, *HW, 3), 7)
    return x, jax.jit(lambda v, x: jm.fused_score(v, x, "entropy"))(
        variables, jnp.asarray(x))


@pytest.mark.parametrize("route, flags, wrappers", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_fused_score_route_matches_jax(setup, jax_entropy, monkeypatch,
                                       route, flags, wrappers):
    """Each entropy route (the wrappers' plain versions on the CPU)
    against the JAX reference score, fused_score(use_pallas=False)."""
    tm = setup[2]
    x, want = jax_entropy
    calls = []
    for mod in (icnet_front, icnet_head):
        for name in wrappers:
            if hasattr(mod, name):
                real = getattr(mod, name)
                monkeypatch.setattr(
                    mod, name, lambda *a, _r=real, _n=name, **k:
                    calls.append(_n) or _r(*a, **k))
    got = tm.fused_score(torch.from_numpy(x), "entropy", **flags)
    assert calls == wrappers
    assert got.dtype == torch.float32 and got.shape == (2,)
    assert (0.05 < got).all() and (got < 0.95).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)


@pytest.fixture(scope="module")
def measure_scores(setup):
    """The JAX package's margin and confidence scores of one image, in
    one jitted call (eager flax dispatch compiles every op alone)."""
    jm, variables, _ = setup
    x = _image((1, *HW, 3), 8)
    want = fast_jit(lambda v, x: {m: jm.fused_score(v, x, m) for m in
                                  ("margin", "confidence")},
                    variables, x)(variables, x)
    return x, want


@pytest.mark.parametrize("measure", ["margin", "confidence"])
def test_fused_score_other_measures_match_jax(setup, measure_scores,
                                              measure):
    tm = setup[2]
    x, want = measure_scores
    want = want[measure]
    got = tm.fused_score(torch.from_numpy(x), measure)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)


def test_fused_score_rejects_bad_shapes(setup):
    tm = setup[2]
    with pytest.raises(ValueError, match="divisible by 32"):
        tm.fused_score(torch.zeros(1, 48, 96, 3), "entropy")
    with pytest.raises(ValueError, match="divisible by 32"):
        tm(torch.zeros(1, 64, 80, 3))


@pytest.mark.parametrize("fused", [True, False])
def test_make_score_step_matches_jax(setup, fused):
    jm, variables, tm = setup
    state = jax_steps.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=None, step=jnp.zeros((), jnp.int32),
        epoch=jnp.zeros((), jnp.int32))
    x = _image((2, *HW, 3), 9)
    want = jax_steps.make_score_step(jm, C, "entropy", fused=fused)(
        state, {"image": jnp.asarray(x)})
    got = steps.make_score_step(tm, C, "entropy", fused=fused)(
        {"image": torch.from_numpy(x)})
    assert got.dtype == torch.float32 and got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)


# -- registry and the CLI ----------------------------------------------------

def test_get_model_builds_icnet():
    m = get_model("ICNet", 19)
    assert isinstance(m, ICNet) and m.num_classes == 19
    assert m.supports_fused_scoring and not m.uses_dropout
    assert m.input_divisor == 32 and m.ms_loss_weights == (1.0, 0.4, 0.4)
    n = sum(p.numel() for p in m.parameters())
    assert 5.0e6 < n < 1.0e7, n  # as tests/test_icnet.py bounds the JAX one


# jitted: eagerly, each of the ~350 leaves' zeros compiles on its own
_ADAM_INIT = jax.jit(optax.adam(1e-3).init)


def _train_state(variables):
    return jax_steps.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=_ADAM_INIT(variables["params"]),
        step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32))


# -- fused_predict and serving ---------------------------------------------

@pytest.fixture(scope="module")
def jax_labels(setup):
    """An image batch, the JAX logits and the JAX reference labels,
    ``fused_predict(use_pallas=False)`` (jitted: the plain forward's
    argmax)."""
    jm, variables, _ = setup
    x = _image((2, *HW, 3), 10)
    labels, logits = jax.jit(lambda v, x: (
        jm.fused_predict(v, x), jm.apply(v, x, training=False)))(
            variables, jnp.asarray(x))
    return x, np.asarray(logits), np.asarray(labels)


# (route, fused_predict flags, the port wrappers the route takes)
PREDICT_ROUTES = [
    ("front_stem_cff2_head", {},
     ["fused_icnet_front_stem", "fused_cff2_head8_predict"]),
    ("front_stem_head", dict(fuse_cff2=False),
     ["fused_icnet_front_stem", "fused_head8_predict"]),
    ("front_head", dict(fuse_stem=False),
     ["fused_icnet_front", "fused_head8_predict"]),
]


@pytest.mark.parametrize("route, flags, wrappers", PREDICT_ROUTES,
                         ids=[r[0] for r in PREDICT_ROUTES])
def test_fused_predict_route_matches_jax(setup, jax_labels, monkeypatch,
                                         route, flags, wrappers):
    """Each route (the wrappers' plain versions on the CPU) against the
    JAX reference labels, fused_predict(use_pallas=False)."""
    tm = setup[2]
    x, logits, want = jax_labels
    calls = []
    for mod in (icnet_front, icnet_head):
        for name in wrappers:
            if hasattr(mod, name):
                real = getattr(mod, name)
                monkeypatch.setattr(
                    mod, name, lambda *a, _r=real, _n=name, **k:
                    calls.append(_n) or _r(*a, **k))
    got = tm.fused_predict(torch.from_numpy(x), **flags)
    assert calls == wrappers
    assert got.dtype == torch.int32 and got.shape == (2, *HW)
    np.testing.assert_array_equal(want, np.argmax(logits, axis=-1))
    assert_labels_match(got.numpy(), logits, margin=1e-3)


def test_fused_predict_matches_the_pallas_chain(setup):
    """The default route against JAX fused_predict(use_pallas=True) with
    the front+stem and CFF2 + head predict kernels in interpret mode."""
    jm, variables, tm = setup
    x = _image((1, 32, 64, 3), 11)
    want = jax.jit(lambda v, x: jm.fused_predict(
        v, x, use_pallas=True, interpret=True))(variables, jnp.asarray(x))
    got = tm.fused_predict(torch.from_numpy(x))
    with torch.no_grad():
        logits = tm(torch.from_numpy(x)).numpy()
    assert np.asarray(want).dtype == np.int32
    mask = decided(logits, 1e-3)
    assert mask.mean() > 0.99
    np.testing.assert_array_equal(got.numpy()[mask], np.asarray(want)[mask])


def test_fused_predict_rejects_bad_shapes(setup):
    tm = setup[2]
    with pytest.raises(ValueError, match="divisible by 32"):
        tm.fused_predict(torch.zeros(1, 48, 96, 3))
    with pytest.raises(ValueError, match=r"\[N,H,W,3\]"):
        tm.fused_predict(torch.zeros(1, 32, 32, 4))


def _prob_decided(logits, out_hw, margin=1e-5):
    """Pixels whose resized probabilities' top-2 gap exceeds ``margin``
    (``logits`` from the port's forward)."""
    prob = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    prob = np.asarray(jax.image.resize(
        prob, (prob.shape[0], *out_hw, prob.shape[-1]), "bilinear"))
    top2 = np.sort(prob, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > margin


@pytest.mark.parametrize("out_hw", [(40, 60), (96, 128)],
                         ids=["down", "up"])
def test_output_size_matches_jax(setup, monkeypatch, out_hw):
    """--output-size on ICNet: the plain forward cropped to the record
    (60x90 of the 64x96 storage), softmax, a bilinear resize of the
    probabilities (antialiased down), argmax, against root
    inference.make_predict_fn(out_hw=...)."""
    monkeypatch.delenv("SSAL_FUSED_PREDICT", raising=False)
    jm, variables, tm = setup
    h, w = 60, 90
    lut = np.arange(256, dtype=np.uint8)
    predict, use_fused = jax_inference.make_predict_fn(
        jm, _train_state(variables), jnp.asarray(lut), h, w, 3, out_hw)
    assert not use_fused
    stack = np.random.default_rng(12).integers(0, 256, (2, *HW, 3),
                                               dtype=np.uint8)
    want = np.asarray(predict(jnp.asarray(stack)))
    got = inference.make_predict_fn(tm, torch.from_numpy(lut), h, w, 3,
                                    "cpu", out_hw)(torch.from_numpy(stack))
    assert got.dtype == torch.uint8 and got.shape == (2, *out_hw)
    with torch.no_grad():
        logits = tm(torch.from_numpy(stack).float() / 255.0)[:, :h, :w]
    mask = _prob_decided(logits.numpy(), out_hw)
    assert mask.mean() > 0.99
    np.testing.assert_array_equal(got.numpy()[mask], want[mask])


def _with_classes(variables, c, seed=0):
    """The variables with classifier columns appended up to ``c`` classes
    (normal, at the existing columns' spread): the three classifier
    heads are the only weights that depend on the class count."""
    rng = np.random.default_rng(seed)
    params = dict(variables["params"])
    for name in ("Classifier", "CFF1", "CFF2"):
        head = params[name] if name == "Classifier" else \
            params[name]["aux_cls"]
        k, b = np.asarray(head["kernel"]), np.asarray(head["bias"])
        extra = c - k.shape[-1]
        new = {"kernel": jnp.asarray(np.concatenate(
                   [k, rng.normal(size=(*k.shape[:-1], extra)) * k.std()],
                   axis=-1).astype(np.float32)),
               "bias": jnp.asarray(np.concatenate(
                   [b, np.zeros(extra, np.float32)]))}
        if name == "Classifier":
            params[name] = new
        else:
            params[name] = {**params[name], "aux_cls": new}
    return {"params": params, "batch_stats": variables["batch_stats"]}


def test_inference_cli_serves_icnet(setup, tmp_path, caplog):
    """The port's CLI (--device cpu) on ICNet Freiburg records with a
    JAX-written ICNet checkpoint whose config.json names ICNet, against
    the JAX make_predict_fn on the same weights: the Freiburg colormap
    of the labels on decided pixels. Freiburg has 6 classes, so the
    5-class weights gain a classifier column."""
    variables = _with_classes(setup[1], 6)
    jm = JaxICNet(num_classes=6)
    run = tmp_path / "run"
    run.mkdir()
    (run / "config.json").write_text(json.dumps(
        {"network": {"model": "ICNet"}}))
    jax_checkpoint.save_checkpoint(str(run / "model-1.ckpt"),
                                   _train_state(variables))
    rec = tmp_path / "rec"
    rec.mkdir()
    rng = np.random.default_rng(13)
    images = rng.integers(0, 256, (2, *HW, 3), dtype=np.uint8)
    for i, img in enumerate(images):
        ex = jax_example.SegExample(
            file_id=f"r{i}", height=HW[0], width=HW[1],
            label=_png(np.zeros(HW, np.uint8)),
            modalities={"image": (_png(img), "png", 3)})
        jax_tfrecord.write_record_file(str(rec / f"r{i}.tfrecord"),
                                       jax_example.make_example(ex))
    caplog.set_level("INFO")
    args = inference.parse_arguments(
        ["-c", str(run / "model-1.ckpt"), "-d", str(rec), "-o",
         str(tmp_path / "out"), "-t", "freiburg", "-b", "2", "--device",
         "cpu"])
    assert inference.main(args) == 0
    assert "Model: ICNet" in caplog.text
    colormap = np.asarray(jax_datasets.Freiburg().colormap)
    predict, _ = jax_inference.make_predict_fn(
        jm, _train_state(variables), jnp.asarray(colormap), *HW, 3)
    want = np.asarray(predict(jnp.asarray(images)))
    with torch.no_grad():
        logits = port_icnet(variables, 6)(
            torch.from_numpy(images).float() / 255.0).numpy()
    mask = decided(logits, 1e-3)
    assert mask.mean() > 0.99
    for i in range(2):
        got = np.asarray(Image.open(tmp_path / "out" / f"r{i}.png"))
        assert got.shape == (*HW, 3)
        np.testing.assert_array_equal(got[mask[i]], want[i][mask[i]])


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()
