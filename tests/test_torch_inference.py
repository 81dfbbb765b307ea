"""The PyTorch port's serving path against the JAX package's: the
``make_predict_fn`` hot path (and its ``--output-size`` route), the
inference CLI on a JAX-written checkpoint (the drop-in), the checkpoint
module, ``device_prefetch``, and that no port module imports JAX.

Labels are compared where the JAX logits' top-2 margin exceeds 1e-4, or
with ``--output-size`` where the resized probabilities' exceeds 1e-6
(random-init logits have near-ties that either side may break)."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from semanticsegmentationactivelearning_tpu import datasets
from semanticsegmentationactivelearning_tpu.models import ENet as JaxENet
from semanticsegmentationactivelearning_tpu.train import (
    checkpoint as jax_checkpoint)
from semanticsegmentationactivelearning_tpu.train import optim
from semanticsegmentationactivelearning_tpu.train.steps import TrainState
from semanticsegmentationactivelearning_tpu_torch import inference
from semanticsegmentationactivelearning_tpu_torch.data.device_prefetch \
    import device_prefetch
from semanticsegmentationactivelearning_tpu_torch.models import get_model
from semanticsegmentationactivelearning_tpu_torch.train import (bridge,
                                                                checkpoint)

from _torch_parity import (decided, fast_jit, noised_stats, port_model,
                           to_numpy_tree)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, C = 32, 64, 19


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
def jax_state():
    """A JAX TrainState for ENet-19 with noised BatchNorm statistics:
    ``train.create_train_state``'s init compiled with ``FAST_COMPILE``
    (the same weights bit for bit, in about 10 s of its 17), and the
    CLI's optimizer state (its init jitted: eagerly each leaf's zeros
    compile alone)."""
    model = JaxENet(num_classes=C)
    key = jax.random.PRNGKey(0)
    v = fast_jit(lambda k: model.init(
        {"params": k, "dropout": jax.random.PRNGKey(0)},
        jnp.zeros((1, H, W, 3), jnp.float32), training=True,
        multiscale=False), key)(key)
    state = TrainState(params=v["params"], batch_stats=v["batch_stats"],
                       opt_state=jax.jit(optim.make_optimizer({}).init)(
                           v["params"]),
                       step=jnp.zeros((), jnp.int32),
                       epoch=jnp.zeros((), jnp.int32))
    return model, state.replace(batch_stats=noised_stats(state.batch_stats,
                                                         0))


@pytest.fixture(scope="module")
def jax_logits(jax_state):
    """``images -> the JAX model's logits``, eval mode, jitted (eager
    flax dispatch compiles every primitive of ENet anew)."""
    model, state = jax_state
    apply = jax.jit(lambda v, x: model.apply(v, x))
    return lambda images: np.asarray(apply(
        _variables(state), jnp.asarray(images, jnp.float32) / 255.0))


def _variables(state):
    return {"params": state.params, "batch_stats": state.batch_stats}


@pytest.fixture(scope="module")
def jax_ckpt(jax_state, tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_run") / "model-1.ckpt"
    jax_checkpoint.save_checkpoint(str(path), jax_state[1])
    return path


def test_make_predict_fn_matches_jax(jax_state, jax_logits, monkeypatch):
    monkeypatch.delenv("SSAL_FUSED_PREDICT", raising=False)
    import inference as jax_inference
    model, state = jax_state
    h, w = 45, 60       # record dims inside the 48x64 storage window
    lut = np.arange(256, dtype=np.uint8)
    predict, use_fused = jax_inference.make_predict_fn(
        model, state, jnp.asarray(lut), h, w, 3)
    assert not use_fused  # the plain XLA forward on the CPU
    stack = np.random.default_rng(1).integers(0, 256, (2, 48, 64, 3),
                                              dtype=np.uint8)
    want = np.asarray(predict(jnp.asarray(stack)))

    port = inference.make_predict_fn(
        port_model(_variables(state), C), torch.from_numpy(lut), h, w, 3,
        "cpu")
    got = port(torch.from_numpy(stack))
    assert got.dtype == torch.uint8 and got.shape == (2, h, w)
    mask = decided(jax_logits(stack)[:, :h, :w])
    assert mask.mean() > 0.99
    np.testing.assert_array_equal(got.numpy()[mask], want[mask])


@pytest.mark.parametrize("out_hw", [(20, 30), (90, 120)],
                         ids=["down", "up"])
def test_output_size_matches_jax(jax_state, monkeypatch, out_hw):
    """--output-size: the plain forward cropped to the record, softmax, a
    bilinear resize of the probabilities (antialiased on the way down),
    argmax."""
    monkeypatch.delenv("SSAL_FUSED_PREDICT", raising=False)
    import inference as jax_inference
    model, state = jax_state
    h, w = 45, 60
    lut = np.arange(256, dtype=np.uint8)
    predict, use_fused = jax_inference.make_predict_fn(
        model, state, jnp.asarray(lut), h, w, 3, out_hw)
    assert not use_fused
    stack = np.random.default_rng(2).integers(0, 256, (2, 48, 64, 3),
                                              dtype=np.uint8)
    want = np.asarray(predict(jnp.asarray(stack)))
    port_net = port_model(_variables(state), C)
    got = inference.make_predict_fn(port_net, torch.from_numpy(lut), h, w,
                                    3, "cpu", out_hw)(torch.from_numpy(stack))
    assert got.dtype == torch.uint8 and got.shape == (2, *out_hw)
    with torch.no_grad():
        logits = port_net(torch.from_numpy(stack).float() / 255.0)
    prob = jax.nn.softmax(jnp.asarray(logits.numpy()[:, :h, :w]), axis=-1)
    prob = np.asarray(jax.image.resize(prob, (2, *out_hw, C), "bilinear"))
    top2 = np.sort(prob, axis=-1)[..., -2:]
    mask = (top2[..., 1] - top2[..., 0]) > 1e-6
    assert mask.mean() > 0.99
    np.testing.assert_array_equal(got.numpy()[mask], want[mask])


def test_jax_checkpoint_restores_in_the_port(jax_state, jax_ckpt):
    assert bridge.is_jax_checkpoint(str(jax_ckpt))
    state = checkpoint.restore_checkpoint(str(jax_ckpt))
    want = bridge.state_dict_from_flax(to_numpy_tree(_variables(
        jax_state[1])))
    assert state.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(state[k], want[k], rtol=0, atol=0)


def test_port_checkpoint_round_trip(tmp_path):
    model = get_model("ENet", 4)
    path = checkpoint.save_checkpoint(str(tmp_path / "model-3.ckpt"), model)
    assert os.listdir(tmp_path) == ["model-3.ckpt"]  # no .part left
    assert not bridge.is_jax_checkpoint(path)
    other = get_model("ENet", 4)
    # a directory resolves to its newest checkpoint
    checkpoint.restore_checkpoint(str(tmp_path), other)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(other.state_dict()[k], v, rtol=0, atol=0)


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Three cityscapes-style records, as tests/test_inference_cli.py
    writes them; returns (dir, images)."""
    from semanticsegmentationactivelearning_tpu.data import (example,
                                                             tfrecord)
    out = tmp_path_factory.mktemp("records")
    rng = np.random.default_rng(0)
    images = []
    for i in range(3):
        img = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
        lbl = rng.integers(0, C, (H, W)).astype(np.uint8)
        ex = example.SegExample(
            file_id=f"sample{i:02d}", height=H, width=W, label=_png(lbl),
            modalities={"image": (_png(img), "png", 3)})
        tfrecord.write_record_file(str(out / f"sample{i:02d}.tfrecord"),
                                   example.make_example(ex))
        images.append(img)
    return out, np.stack(images)


def test_cli_on_a_jax_checkpoint(jax_logits, jax_ckpt, records, tmp_path):
    """The port's CLI serves a JAX-written checkpoint; its PNGs hold the
    JAX model's reverse-embedded labels on decided pixels."""
    rec_dir, images = records
    out = tmp_path / "pred"
    res = subprocess.run(
        [sys.executable, "-m",
         "semanticsegmentationactivelearning_tpu_torch.inference",
         "-c", str(jax_ckpt), "-d", str(rec_dir), "-o", str(out),
         "-t", "cityscapes", "-b", "2", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "Model: ENet" in res.stderr
    pngs = sorted(out.glob("*.png"))
    assert [p.name for p in pngs] == [f"sample{i:02d}.png"
                                      for i in range(3)]
    logits = jax_logits(images)
    lut = np.asarray(datasets.Cityscapes().embedding_reversed)
    want = lut[np.argmax(logits, axis=-1)]
    mask = decided(logits)
    assert mask.mean() > 0.99
    for i, p in enumerate(pngs):
        got = np.asarray(Image.open(p))
        assert got.shape == (H, W)
        np.testing.assert_array_equal(got[mask[i]], want[i][mask[i]])


@pytest.mark.parametrize("flag,error,match", [
    # --modalities stacks the records' extra modalities, for either
    # model: RGB records have no 'nir'
    (["-m", "ICNet", "--modalities", "nir"], ValueError,
     "has no 'nir' modality"),
    (["--modalities", "nir"], ValueError, "has no 'nir' modality"),
    (["--view"], NotImplementedError, "ROADMAP")])
def test_deferred_flags_name_their_roadmap_item(records, flag, error, match,
                                                tmp_path):
    args = inference.parse_arguments(
        ["-c", "x", "-d", str(records[0]), "-o", str(tmp_path / "o"),
         "-t", "cityscapes", "--device", "cpu", *flag])
    with pytest.raises(error, match=match):
        inference.main(args)


def test_cli_without_device_cpu_needs_cuda(records, tmp_path, monkeypatch):
    """``--device`` defaults to ``cuda``: with no CUDA device the CLI
    raises and names the flag instead of serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = inference.parse_arguments(
        ["-c", "x", "-d", str(records[0]), "-o", str(tmp_path / "o"),
         "-t", "cityscapes"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        inference.main(args)
    assert not (tmp_path / "o").exists()


def test_device_prefetch_on_cpu():
    closed = []

    def batches():
        try:
            for i in range(5):
                yield {"stack": np.full((2, 4, 4, 3), i, np.uint8),
                       "index": np.array([i])}
        finally:
            closed.append(True)

    got = [b for b in device_prefetch(batches(), "cpu", depth=2)]
    assert [int(b["stack"][0, 0, 0, 0]) for b in got] == list(range(5))
    assert all(isinstance(b["stack"], torch.Tensor) for b in got)
    assert isinstance(got[0]["index"], np.ndarray)  # metadata stays host
    it = device_prefetch(batches(), "cpu")
    next(it)
    it.close()                 # abandoning early closes the source
    assert closed == [True, True]
    with pytest.raises(ValueError):
        next(device_prefetch(batches(), "cpu", depth=0))


def test_port_imports_no_jax():
    """Every module of the port imports in a fresh process without
    pulling in JAX, flax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import semanticsegmentationactivelearning_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,"
        " pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'flax', 'semanticsegmentationactivelearning_tpu'))\n"
        "assert len(names) >= 15 and not bad, (names, bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
