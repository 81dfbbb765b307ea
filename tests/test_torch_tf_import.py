"""The port's migration entries against the JAX package's:
``train/tf_import.py`` and ``tools/import_reference_checkpoint.py`` (a
reference TensorFlow checkpoint -> a port checkpoint) and
``tools/export_tb_events.py`` (``metrics.jsonl`` -> a TensorBoard event
file).

The reference checkpoint is written with ``tf.train.Checkpoint`` from a
seeded port ENet with the multiscale heads, laid out as the reference
lays it out by ``chip_smoke.reference_variables`` (the inverse of the
importer's mapping, which phase 14d of ``chip_smoke.py`` uses on the
card, where there is no TensorFlow), as tests/test_tf_import.py writes
one from a flax ENet:

- the port's ``convert_reference_checkpoint`` against the JAX one and
  its ``to_train_state``: the same ``state_dict`` (bit for bit, and the
  original model's), the same epoch and step, forwards within 1e-5;
- the port's tool: it writes a checkpoint the port restores (epoch,
  step, the reference's save counter), refuses a conf that cannot take
  the weights, and with ``--allow-partial`` writes all the same;
  ``--modality-channels 4`` imports a 4-plane checkpoint that a 3-plane
  model refuses;
- ``export_tb_events`` writes the scalars the JAX tool writes.

Four tests (tests/test_torch_modalities.py says why). Measured: about
15 s on one process, most of it TensorFlow's import.
"""

import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from semanticsegmentationactivelearning_tpu.models import (  # noqa: E402
    ENet as JaxENet)
from semanticsegmentationactivelearning_tpu.train import (  # noqa: E402
    tf_import as jax_tf_import)
from semanticsegmentationactivelearning_tpu.train.steps import (  # noqa: E402
    TrainState as JaxTrainState)
from semanticsegmentationactivelearning_tpu_torch.models import (  # noqa: E402
    ENet)
from semanticsegmentationactivelearning_tpu_torch.tools import (  # noqa: E402
    export_tb_events, import_reference_checkpoint)
from semanticsegmentationactivelearning_tpu_torch.train import (  # noqa: E402
    bridge, checkpoint, optim, steps, tf_import)
from semanticsegmentationactivelearning_tpu_torch.utils import (  # noqa: E402
    tb_events)

from _torch_parity import fast_jit, flax_variables, seeded_port_enet  # noqa: E402,E501

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import reference_variables  # noqa: E402

C = 5
HW = (32, 48)
RATES = (0.01, 0.1, 0.1, 0.1, 0.1)
SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _save_reference(named, directory):
    """A TF checkpoint of ``named`` (reference key -> array) under the
    reference's object paths: ``model/...`` as nested ``tf.Module``s
    (a list where the path's parts are indices), with epoch 7 and step
    123 beside the model."""
    tree = {}
    for key, value in named.items():
        *parts, leaf = key[:-len(SUFFIX)].split("/")
        node = tree
        for part in parts:
            node = node.setdefault(part, {})
        node[leaf] = value

    def build(node):
        if not isinstance(node, dict):
            return tf.Variable(node)
        if all(k.isdigit() for k in node):
            return [build(node[str(i)]) for i in range(len(node))]
        module = tf.Module()
        for k, v in node.items():
            setattr(module, k, build(v))
        return module

    ckpt = tf.train.Checkpoint(
        model=build(tree["model"]), epoch=tf.Variable(7, dtype=tf.int64),
        step=tf.Variable(123, dtype=tf.int64))
    return ckpt.save(os.path.join(str(directory), "model"))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    model = seeded_port_enet(C, 4, drop_rates=RATES).eval()
    prefix = _save_reference(reference_variables(model.state_dict()),
                             tmp_path_factory.mktemp("ref"))
    return model, prefix


def _conf(tmp_path, multiscale=True):
    path = tmp_path / f"conf{int(multiscale)}.json"
    path.write_text("""{
        "batch_size": 4, "epochs": 1,
        "hyperparams": {
            "dropout_rates": [0.01, 0.1, 0.1, 0.1, 0.1],
            "learning_rate": 1e-3,
            "optimizer": {"type": "Adam", "kwargs": {}},
            "weight_reg": {"L2": 0.0, "L1": 0.0},
            "softmax": {"multiscale": %s}},
        "network": {"model": "ENet",
                    "input": {"height": 32, "width": 48}}}"""
                    % str(multiscale).lower())
    return str(path)


def test_import_matches_jax(saved):
    model, prefix = saved
    got = tf_import.convert_reference_checkpoint(prefix)
    want = jax_tf_import.convert_reference_checkpoint(prefix)
    assert (got["epoch"], got["step"]) == (want["epoch"], want["step"]) \
        == (7, 123)
    assert got["save_counter"] == want["save_counter"] == 1
    assert sorted(got["skipped"]) == sorted(want["skipped"])
    jax_sd = bridge.state_dict_from_flax(want)
    sd = model.state_dict()
    assert got["state_dict"].keys() == jax_sd.keys() == sd.keys()
    for k, v in got["state_dict"].items():
        assert torch.equal(v, jax_sd[k]) and torch.equal(v, sd[k]), k
    assert tf_import.convert_reference_checkpoint(
        os.path.dirname(prefix))["step"] == 123

    # the JAX template: another seed's weights, the same structure
    other = flax_variables(seeded_port_enet(C, 9, drop_rates=RATES))
    template = JaxTrainState(
        params=other["params"], batch_stats=other["batch_stats"],
        opt_state=optax.sgd(1e-3).init(other["params"]),
        step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32))
    assert not jax_tf_import.merge_report(template, want)["missing"]
    state = jax_tf_import.to_train_state(want, template)
    assert (int(state.epoch), int(state.step)) == (7, 123)
    port = seeded_port_enet(C, 9, drop_rates=RATES)
    report = tf_import.load_into(port, got)
    assert report["merged"] == len(sd) and not report["missing"] \
        and not report["mismatched"]
    x = np.random.default_rng(2).uniform(size=(1, *HW, 3)).astype(np.float32)
    jm = JaxENet(num_classes=C, drop_rates=RATES)
    v = {"params": state.params, "batch_stats": state.batch_stats}
    want_logits = fast_jit(lambda v, x: jm.apply(v, x, training=False),
                           v, x)(v, x)
    with torch.no_grad():
        logits = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=1e-5)


def test_tool_writes_refuses_and_allows_partial(saved, tmp_path, capsys,
                                                caplog):
    model, prefix = saved
    tool = import_reference_checkpoint.main
    out = tmp_path / "imported"
    assert tool(["--tf-checkpoint", prefix, "-t", "generic", "--num-classes",
                 str(C), "-p", _conf(tmp_path), "-o", str(out)]) == 0
    path = capsys.readouterr().out.strip().splitlines()[-1]
    assert os.path.basename(path) == "model-1.ckpt"
    restored = ENet(C, drop_rates=RATES, multiscale_heads=True)
    opt, sched = optim.make_optimizer(restored.parameters(), {})
    state = checkpoint.restore_training_state(
        str(out), steps.create_train_state(restored, opt, sched))
    assert (state.step, state.epoch) == (123, 7)
    for k, v in model.state_dict().items():
        assert torch.equal(restored.state_dict()[k], v), k

    # no multiscale heads and another class count: refused
    bad = ["--tf-checkpoint", prefix, "-t", "generic", "--num-classes",
           str(C + 2), "-p", _conf(tmp_path, False), "-o",
           str(tmp_path / "bad")]
    with pytest.raises(SystemExit) as e:
        tool(bad)
    assert e.value.code == 2
    assert "no destination in the target model" in capsys.readouterr().err
    assert not (tmp_path / "bad").exists()
    with caplog.at_level("WARNING"):
        assert tool(bad + ["--allow-partial"]) == 0
    assert "keep fresh initialization" in caplog.text
    assert (tmp_path / "bad" / "model-1.ckpt").exists()


def test_tool_imports_four_planes(tmp_path, caplog):
    """``--modality-channels 4``: a 4-plane reference checkpoint imports
    into a 4-plane model, bit for bit; a 3-plane model refuses it, at
    import and at restore."""
    model = seeded_port_enet(C, 6, drop_rates=RATES, in_channels=4)
    prefix = _save_reference(reference_variables(model.state_dict()),
                             tmp_path / "ref4")
    argv = ["--tf-checkpoint", prefix, "-t", "freiburg", "--num-classes",
            str(C), "-p", _conf(tmp_path)]
    with pytest.raises(SystemExit):
        import_reference_checkpoint.main(argv + ["-o", str(tmp_path / "x")])
    assert "unmergeable converted weight: Initial.conv.weight" in caplog.text
    out = tmp_path / "four"
    assert import_reference_checkpoint.main(
        argv + ["-o", str(out), "--modality-channels", "4"]) == 0
    four = ENet(C, multiscale_heads=True, in_channels=4)
    checkpoint.restore_checkpoint(str(out), four)
    for k, v in model.state_dict().items():
        assert torch.equal(four.state_dict()[k], v), k
    with pytest.raises(ValueError, match="takes 4 input planes"):
        checkpoint.restore_checkpoint(str(out),
                                      ENet(C, multiscale_heads=True))


def test_export_tb_events_matches_jax(tmp_path, capsys, monkeypatch):
    log = tmp_path / "log"
    log.mkdir()
    records = [
        {"split": "train_iter", "step": 1, "epoch": 1, "loss": 1.5,
         "cost": 1.75, "learning_rate": 5e-4, "wall_time": 10.0},
        {"split": "train", "epoch": 1, "step": 2, "loss": 1.25,
         "cost": 1.5, "learning_rate": 5e-4, "mean_iou": 0.25,
         "pixel_accuracy": 0.5, "confusion": [[3, 1], [0, 4]],
         "wall_time": 11.0},
        {"split": "val", "epoch": 1, "step": 2, "mean_iou": 0.5,
         "pixel_accuracy": 0.75, "class_iou": [0.25, 0.75],
         "confusion": [[2, 0], [1, 3]], "wall_time": 12.0},
        {"split": "al_confidence", "round": 0, "histogram": [1, 2, 3],
         "bin_edges": [0.0, 0.25, 0.5, 1.0], "mean": 0.4,
         "wall_time": 13.0}]
    with open(log / "metrics.jsonl", "w") as fp:
        for r in records:
            fp.write(json.dumps(r) + "\n")

    assert export_tb_events.main([str(log), "-o", str(tmp_path / "port")]) \
        == 0
    port = capsys.readouterr().out.strip()
    monkeypatch.setattr(sys, "argv", ["export_tb_events.py", str(log), "-o",
                                      str(tmp_path / "jax")])
    with pytest.raises(SystemExit) as e:
        runpy.run_path(os.path.join(REPO, "tools", "export_tb_events.py"),
                       run_name="__main__")
    assert not e.value.code
    want = capsys.readouterr().out.strip()

    def scalars(path):
        return [(v["tag"], ev["step"], v["simple_value"])
                for ev in tb_events.iter_events(path)
                for v in ev["values"] if "simple_value" in v]

    got = scalars(port)
    assert got == scalars(want)
    assert ("train/loss", 2, 1.25) in got and ("val/class_iou/1", 2,
                                                0.75) in got
