"""The port's ``train`` CLI (``python -m
semanticsegmentationactivelearning_tpu_torch.train``) end to end on the
CPU: 12 synthetic 32x48 Cityscapes-layout records written with the
port's ``example``/``tfrecord`` (colour blocks that predict the class),
2 epochs at batch 4 with ``--device cpu``. It checks the
``metrics.jsonl`` records' splits and keys against those the JAX CLI
(the root ``train.py``) writes, read from its source; the numbered
checkpoints, ``checkpoint.json``, ``config.json`` and image summaries;
the trace and event files of ``--trace`` and ``--tensorboard``; a
resume for a third epoch from the log directory; ICNet from
``conf/icnet_cityscapes.json`` (its cascade loss and Momentum) for one
step at batch 8 on 32x32 crops, its checkpoint then served by the
``inference`` CLI on the CPU; that the default ``--device cuda`` raises
without a card, that a bf16 conf raises and names its ROADMAP item and
that ``-m nir`` on RGB records raises the loader's missing-modality
``ValueError``. Also the port's ``tb_events`` copy: a DT_STRING that is not UTF-8
decodes with replacement characters. Measured: about 16 s on one
process.
"""

import ast
import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from semanticsegmentationactivelearning_tpu_torch import inference
from semanticsegmentationactivelearning_tpu_torch.data import (example,
                                                               tfrecord)
from semanticsegmentationactivelearning_tpu_torch.train import __main__ as cli
from semanticsegmentationactivelearning_tpu_torch.utils import tb_events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (32, 48)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _png(a):
    b = io.BytesIO()
    Image.fromarray(a).save(b, format="PNG")
    return b.getvalue()


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """8 train and 4 val records; each 8x8 block's colour (with noise)
    gives its class (trainIds 0-4), so the model can learn it."""
    root = tmp_path_factory.mktemp("records")
    rng = np.random.default_rng(0)
    colors = np.array([(200, 40, 40), (40, 200, 40), (40, 40, 200),
                       (200, 200, 40), (40, 200, 200)], np.uint8)
    for split, n in (("train", 8), ("val", 4)):
        os.makedirs(root / split)
        for i in range(n):
            idx = rng.integers(0, len(colors), (4, 6))
            label = np.kron(idx, np.ones((8, 8), np.int64)).astype(np.uint8)
            img = colors[label].astype(int) + rng.integers(-20, 20,
                                                           (*HW, 3))
            ex = example.SegExample(
                file_id=f"{split}{i}", height=HW[0], width=HW[1],
                label=_png(label),
                modalities={"image": (_png(np.clip(img, 0, 255)
                                           .astype(np.uint8)), "png", 3)})
            tfrecord.write_record_file(str(root / split / f"{i}.tfrecord"),
                                       example.make_example(ex))
    return root


def _conf(tmp, epochs, **network):
    path = os.path.join(tmp, f"conf{epochs}.json")
    with open(path, "w") as fp:
        json.dump({"batch_size": 4, "epochs": epochs,
                   "hyperparams": {"learning_rate": 5e-3,
                                   "softmax": {"multiscale": True}},
                   "network": {"model": "ENet",
                               "input": {"height": HW[0], "width": HW[1]},
                               **network},
                   "train_group": 8}, fp)
    return path


def _run(argv):
    return cli.main(cli.parse_args(argv))


def _jax_cli_records():
    """split -> the keys of the record the JAX CLI writes for it
    (``writer.write({...})`` calls in the root train.py)."""
    with open(os.path.join(REPO, "train.py")) as fp:
        tree = ast.parse(fp.read())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "write"
                and node.args and isinstance(node.args[0], ast.Dict)):
            d = node.args[0]
            keys = {k.value for k in d.keys}
            split = d.values[[k.value for k in d.keys].index("split")].value
            out[split] = keys | {"wall_time"}
    return out


@pytest.fixture(scope="module")
def run(records, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("run"))
    log = os.path.join(tmp, "log")
    args = ["cityscapes", "-d", str(records), "-l", log, "-p",
            _conf(tmp, 2), "--device", "cpu"]
    trace = os.path.join(tmp, "trace")
    assert _run(args + ["--trace", trace, "--tensorboard"]) == 0
    with open(os.path.join(log, "metrics.jsonl")) as fp:
        first = [json.loads(line) for line in fp]
    args[6] = _conf(tmp, 3)
    assert _run(args) == 0          # resumes from the log dir's latest
    with open(os.path.join(log, "metrics.jsonl")) as fp:
        both = [json.loads(line) for line in fp]
    return log, first, both[len(first):]


def test_records_match_the_jax_cli(run):
    _, first, _ = run
    want = _jax_cli_records()
    assert set(want) == {"train_iter", "train", "val", "final_val"}
    splits = [r["split"] for r in first]
    assert splits == (["train_iter"] * 2 + ["train", "val"]) * 2 \
        + ["final_val"]
    for r in first:
        assert set(r) == want[r["split"]], r["split"]
    steps = [(r["epoch"], r["step"]) for r in first
             if r["split"] == "train_iter"]
    assert steps == [(1, 1), (1, 2), (2, 3), (2, 4)]
    train = [r for r in first if r["split"] == "train"]
    assert train[1]["loss"] < train[0]["loss"]
    assert all(np.isfinite(r["loss"]) for r in train)
    conf = np.asarray(train[0]["confusion"])
    assert conf.shape == (19, 19) and conf.sum() == 8 * HW[0] * HW[1]


def test_files_of_the_run(run):
    log, _, _ = run
    names = set(os.listdir(log))
    assert {"model-1.ckpt", "model-2.ckpt", "model-3.ckpt", "config.json",
            "checkpoint.json", "metrics.jsonl", "images"} <= names
    with open(os.path.join(log, "checkpoint.json")) as fp:
        assert json.load(fp)["latest"] == "model-3.ckpt"
    with open(os.path.join(log, "config.json")) as fp:
        config = json.load(fp)
    assert config["epochs"] == 2 and config["network"]["model"] == "ENet"
    assert "val-00001-0-pred.png" in os.listdir(os.path.join(log, "images"))
    payload = torch.load(os.path.join(log, "model-2.ckpt"),
                         weights_only=True)
    assert (payload["step"], payload["epoch"]) == (4, 2)


def test_trace_and_tensorboard_files(run):
    """``--trace`` wrote a torch.profiler Chrome trace, ``--tensorboard``
    an event file that the port's reader reads back."""
    log, first, _ = run
    with open(os.path.join(os.path.dirname(log), "trace",
                           "trace.json")) as fp:
        assert json.load(fp)["traceEvents"]
    files = tb_events.find_event_files(log)
    assert len(files) == 1
    events = list(tb_events.iter_events(files[0]))
    tags = {v["tag"] for e in events for v in e["values"]}
    assert {"train/loss", "val/mean_iou"} <= tags, sorted(tags)[:20]


def test_resume_starts_at_epoch_three(run):
    _, _, resumed = run
    iters = [(r["epoch"], r["step"]) for r in resumed
             if r["split"] == "train_iter"]
    assert iters == [(3, 5), (3, 6)]
    assert [r["split"] for r in resumed][-1] == "final_val"


def test_default_device_needs_a_card(records, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    args = ["cityscapes", "-d", str(records), "-l", str(tmp_path / "l"),
            "-p", _conf(str(tmp_path), 1)]
    with pytest.raises(RuntimeError, match="--device cpu"):
        _run(args)


def test_trains_icnet_and_serves_it(records, tmp_path, caplog):
    """ICNet's conf as it stands but for the run's size: one epoch of
    the 8 records at batch 8 is one step; then the inference CLI serves
    the checkpoint (``-m ICNet``), padding the 32x48 records to 32x64."""
    with open(os.path.join(REPO, "conf", "icnet_cityscapes.json")) as fp:
        conf = json.load(fp)
    conf.update(epochs=1)
    conf["network"]["input"] = {"height": 32, "width": 32}
    path = str(tmp_path / "icnet.json")
    with open(path, "w") as fp:
        json.dump(conf, fp)
    log = str(tmp_path / "log")
    assert _run(["cityscapes", "-d", str(records), "-l", log, "-p", path,
                 "--device", "cpu"]) == 0
    with open(os.path.join(log, "metrics.jsonl")) as fp:
        first = [json.loads(line) for line in fp]
    want = _jax_cli_records()
    assert [r["split"] for r in first] == ["train_iter", "train", "val",
                                           "final_val"]
    for r in first:
        assert set(r) == want[r["split"]], r["split"]
    assert np.isfinite(first[0]["loss"]) and first[0]["cost"] > \
        first[0]["loss"]
    payload = torch.load(os.path.join(log, "model-1.ckpt"),
                         weights_only=True)
    assert (payload["step"], payload["epoch"]) == (1, 1)
    assert "Classifier.weight" in payload["model"]
    out = tmp_path / "out"
    with caplog.at_level("INFO"):
        assert inference.main(inference.parse_arguments(
            ["-c", log, "-d", str(records / "val"), "-o", str(out), "-t",
             "cityscapes", "-m", "ICNet", "-b", "2", "--device",
             "cpu"])) == 0
    assert "Model: ICNet" in caplog.text
    pngs = sorted(os.listdir(out))
    assert pngs == [f"{i}.png" for i in range(4)]
    assert np.asarray(Image.open(out / pngs[0])).shape == HW


@pytest.mark.parametrize("network,extra,error,match", [
    ({"dtype": "bfloat16"}, [], NotImplementedError, "item 2"),
    # -m stacks the records' extra modalities: RGB records have no 'nir'
    ({}, ["-m", "rgb", "nir"], ValueError, "has no 'nir' modality")])
def test_not_ported_raises(records, tmp_path, network, extra, error, match):
    dataset = "freiburg" if extra else "cityscapes"
    args = [dataset, "-d", str(records), "-l", str(tmp_path / "l"), "-p",
            _conf(str(tmp_path), 1, **network), "--device", "cpu", *extra]
    with pytest.raises(error, match=match):
        _run(args)


def test_tb_events_decodes_invalid_utf8():
    """A DT_STRING tensor (dtype 7) with a string that is not UTF-8."""
    buf = bytearray()
    tb_events._write_int(buf, 1, 7)
    tb_events._write_len_delimited(buf, 8, b"ok \xff\xfe")
    strings, shape = tb_events._decode_string_tensor(bytes(buf))
    assert strings == ["ok ��"] and shape == [1]
