"""Multi-modal input (RGB + Freiburg's NIR plane) through the PyTorch
port, against the JAX package:

- ENet and ICNet with 4 input planes against JAX ``apply`` and
  ``fused_score(use_pallas=False)`` (ENet's pool score takes the plain
  encoder and the decoder score route's plain version, ICNet's its plain
  forward), as tests/test_modalities.py holds the JAX models;
- one float64 SGD step of the 4-plane ENet against the JAX
  ``make_train_step`` (``_torch_parity.check_sgd_step``);
- the port's ``generate_dataset`` against the root script on one
  synthetic Freiburg tree (``rgb``, ``nir_gray``, ``GT_color``), each
  ``main`` in this process: the records byte for byte;
- a CPU round trip of the CLIs with ``-m nir_gray`` on those records:
  the train CLI (4-plane checkpoints), the inference CLI (the plain
  route, maps equal to the model's own forward; the checkpoint refused
  by a 3-plane model with a shape error) and one AL round (its pool
  ranked, its labelled set grown).

Four tests: ``--dist loadfile`` queues files with more tests first, and
a file with more than tests/test_multihost.py's 4 would delay it.
Measured: about 37 s on one process (16 s of it the JAX step's compile).
"""

import functools
import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from semanticsegmentationactivelearning_tpu.models import ENet as JaxENet
from semanticsegmentationactivelearning_tpu_torch import active_learning as al
from semanticsegmentationactivelearning_tpu_torch import datasets, inference
from semanticsegmentationactivelearning_tpu_torch import (
    generate_dataset as port_generate)
from semanticsegmentationactivelearning_tpu_torch.data import loader
from semanticsegmentationactivelearning_tpu_torch.models import ENet, ICNet
from semanticsegmentationactivelearning_tpu_torch.train import (
    __main__ as train_cli)
from semanticsegmentationactivelearning_tpu_torch.train import (bridge,
                                                                checkpoint)

from _torch_parity import (check_sgd_step, fast_jit, icnet_variables,
                           noised_variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (32, 48)
C = 6  # Freiburg's classes
COLORS = np.array([(170, 170, 170), (0, 255, 0), (102, 102, 51),
                   (0, 120, 255), (0, 0, 0)], np.uint8)
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _generate(module, root, out, monkeypatch):
    """``module``'s generate_dataset ``main`` (the root script's or the
    port's) in this process, its ETL on one worker: the records do not
    depend on the worker count, and a pool of a worker a core would
    compete with the suite's other test processes."""
    monkeypatch.setattr(module.etl, "generate_split", functools.partial(
        module.etl.generate_split, num_workers=1))
    os.makedirs(out)
    assert module.main(module.parse_arguments(
        ["-d", str(root), "-t", "freiburg", "-o", str(out),
         "--modalities", "rgb", "nir_gray"])) == 0


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A Freiburg tree: 12 train and 4 test examples of 32x48 colour
    blocks, the NIR plane carrying the class too; then the port's
    records of it."""
    root = tmp_path_factory.mktemp("freiburg")
    rng = np.random.default_rng(5)
    for split, n in (("train", 12), ("test", 4)):
        for sub in ("GT_color", "rgb", "nir_gray"):
            (root / split / sub).mkdir(parents=True)
        for i in range(n):
            idx = rng.integers(0, len(COLORS), (HW[0] // 8, HW[1] // 8))
            big = np.kron(idx, np.ones((8, 8), np.int64))
            name = f"{split[0]}{i:03d}"
            Image.fromarray(COLORS[big]).save(
                root / split / "GT_color" / f"{name}_mask.png")
            Image.fromarray(rng.integers(0, 255, (*HW, 3)).astype(
                np.uint8)).save(root / split / "rgb" / f"{name}.png")
            Image.fromarray((big * 50 + 10).astype(np.uint8), mode="L").save(
                root / split / "nir_gray" / f"{name}.png")
    out = tmp_path_factory.mktemp("records") / "port"
    with pytest.MonkeyPatch.context() as mp:
        _generate(port_generate, root, out, mp)
    return root, out


def _icnet_pair(seed):
    """A JAX ICNet of 4 input planes, its variables (the recipe of
    ``_torch_parity.icnet_variables``) and the port's ICNet holding
    them."""
    jm, v = icnet_variables(C, (64, 64), seed, channels=4)
    tm = ICNet(C, in_channels=4)
    tm.load_state_dict(bridge.state_dict_from_flax(v))
    return jm, v, tm.eval()


def test_four_plane_models_match_jax():
    """Logits and the entropy pool score: ENet's on the plain encoder and
    the decoder route (the JAX ``fused_score`` skips the front kernel for
    C != 3), ICNet's on its plain forward."""
    for name in ("ENet", "ICNet"):
        _check_model(name)


def _check_model(name):
    if name == "ENet":
        x = np.random.default_rng(1).uniform(
            size=(2, *HW, 4)).astype(np.float32)
        jm = JaxENet(num_classes=C)
        v = noised_variables(jm, x, 2)
        tm = ENet(C, in_channels=4)
        tm.load_state_dict(bridge.state_dict_from_flax(v))
        tm.eval()
    else:
        x = np.random.default_rng(1).uniform(
            size=(2, 64, 64, 4)).astype(np.float32)
        jm, v, tm = _icnet_pair(3)
    assert tm.state_dict()[
        "Initial.conv.weight" if name == "ENet"
        else "Branch1_1.conv.weight"].shape[1] == 4
    want_logits, want_score = fast_jit(
        lambda v, x: (jm.apply(v, x, training=False),
                      jm.fused_score(v, x, "entropy")), v, x)(
        v, jnp.asarray(x))
    tx = torch.from_numpy(x)
    with torch.no_grad():
        logits = tm(tx)
    score = tm.fused_score(tx, "entropy")
    assert np.abs(np.asarray(want_logits)).max() > 0.1  # not vacuous
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               **TOL)
    np.testing.assert_allclose(score.numpy(), np.asarray(want_score), **TOL)
    with pytest.raises(ValueError, match="fused_predict"):
        tm.fused_predict(tx)


def test_four_plane_train_step_matches_jax():
    """One float64 SGD step of the 4-plane ENet (the AL conf's loss):
    loss, cost, confusion and every weight after the step."""
    check_sgd_step(False, channels=4)


def test_generate_dataset_matches_the_root_script(tree, tmp_path,
                                                  monkeypatch):
    root, port_out = tree
    spec = importlib.util.spec_from_file_location(
        "root_generate_dataset", os.path.join(REPO, "generate_dataset.py"))
    root_generate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_generate)
    _generate(root_generate, root, tmp_path / "root", monkeypatch)

    def files(top):
        return sorted(os.path.relpath(os.path.join(d, f), top)
                      for d, _, fs in os.walk(top) for f in fs)

    got, want = files(port_out), files(tmp_path / "root")
    assert got == want and len(got) == 16
    for rel in got:
        with open(port_out / rel, "rb") as a, \
                open(tmp_path / "root" / rel, "rb") as b:
            assert a.read() == b.read(), rel
    ld = loader.RecordLoader([str(port_out / p) for p in got if
                              p.startswith("test")], 4,
                             modalities=("nir_gray",))
    stack = next(iter(ld.batches()))["stack"]
    assert ld.channels == 4 and stack.shape[-1] == 5
    assert set(np.unique(stack[..., 3])) <= {10, 60, 110, 160, 210}


def _conf(tmp_path, name, base, **over):
    with open(os.path.join(REPO, "conf", base)) as fp:
        conf = json.load(fp)
    conf.update(batch_size=4, epochs=1)
    conf["hyperparams"]["learning_rate"] = 1e-4
    conf["network"]["input"] = {"height": HW[0], "width": HW[1]}
    for key, value in over.items():
        conf["active_learning"][key] = value
    path = str(tmp_path / f"{name}.json")
    with open(path, "w") as fp:
        json.dump(conf, fp)
    return path


def test_cli_round_trip(tree, tmp_path, caplog):
    """train -> serve -> one AL round with ``-m nir_gray`` on the CPU."""
    _, rec = tree
    log = tmp_path / "train"
    mods = ["-m", "rgb", "nir_gray"]
    with caplog.at_level("INFO"):
        assert train_cli.main(train_cli.parse_args(
            ["freiburg", "-d", str(rec), "-l", str(log), "-p",
             _conf(tmp_path, "t", "freiburg_forest.json"), "--device",
             "cpu", *mods])) == 0
    assert "Stacking modalities ['nir_gray'] -> 4 input channels" \
        in caplog.text
    state = checkpoint.restore_checkpoint(str(log))
    assert state["Initial.conv.weight"].shape == (12, 4, 3, 3)
    assert checkpoint.input_planes(state) == 4
    with pytest.raises(ValueError, match="takes 4 input planes"):
        checkpoint.restore_checkpoint(str(log), ENet(C))

    out = tmp_path / "pred"
    caplog.clear()
    with caplog.at_level("INFO"):
        assert inference.main(inference.parse_arguments(
            ["-c", str(log), "-d", str(rec / "test"), "-o", str(out), "-t",
             "freiburg", "--modalities", "nir_gray", "-b", "3", "--device",
             "cpu"])) == 0
    assert "through the plain forward: the kernel chain takes RGB, the " \
        "model 4 input planes" in caplog.text
    files = sorted(str(rec / "test" / f) for f in os.listdir(rec / "test"))
    model = ENet(C, in_channels=4)
    checkpoint.restore_checkpoint(str(log), model)
    ld = loader.RecordLoader(files, 4, modalities=("nir_gray",),
                             with_label=False)
    stack = torch.from_numpy(next(iter(ld.batches()))["stack"])
    with torch.no_grad():
        labels = model.eval()(stack.float() / 255.0).argmax(dim=-1)
    cmap = datasets.Freiburg().colormap
    for i, f in enumerate(files):
        png = out / os.path.basename(f).replace(".tfrecord", ".png")
        np.testing.assert_array_equal(np.asarray(Image.open(png)),
                                      cmap[labels[i].numpy()])

    al_log = tmp_path / "al"
    conf = _conf(tmp_path, "al", "enet_cityscapes_active_learning.json",
                 iterations=1, num_initially_labelled=4, num_validation=0,
                 selection_size=3, **{"epochs/warm_up": 0})
    caplog.clear()
    with caplog.at_level("INFO"):
        assert al.main(al.parse_args(
            ["freiburg", "-d", str(rec), "-l", str(al_log), "-p", conf,
             "--device", "cpu", *mods])) == 0
    assert "Stacking modalities ['nir_gray'] -> 4 input channels" \
        in caplog.text
    with open(al_log / "state.json") as fp:
        st = json.load(fp)
    assert st["iteration"] == 1
    assert len(st["dataset"]["train"]["labelled"]) == 7
    with open(al_log / "metrics.jsonl") as fp:
        splits = [json.loads(line)["split"] for line in fp]
    assert splits.count("al_confidence") == 1
    best = checkpoint.latest_checkpoint(str(al_log / "pretrain"))
    assert torch.load(best, weights_only=True)["model"][
        "Initial.conv.weight"].shape[1] == 4
