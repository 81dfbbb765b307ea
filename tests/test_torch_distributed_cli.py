"""The port's ``train`` and ``active_learning`` CLIs with two ranks on the
CPU: each rank a ``python -m`` child on a free port with torchrun's
variables (Gloo, ``--device cpu``), as ``tests/test_multihost.py`` runs
the JAX CLIs, against one process in this one. A wrapper
(``RANK_RUNNER``) counts the files each rank opens for writing under
the log directory.

- (a) The train CLI, ENet at 32x48 from 8 + 4 records, global batch 4,
  dropout on, SGD at 1e-3, 2 epochs: rank 0 alone wrote (rank 1 opened
  nothing for writing there), the records and checkpoints are one
  process's, and the final weights agree with its within 1e-5 (a BN
  running statistic, up to ~7 here, within 1e-5 of its tensor's largest
  value: they are float32 sums in another order).
- (b) One AL round (the AL conf, 11 records, 4 labelled, 3 picked, no
  validation set): the picks equal one process's, rank 0 alone wrote
  ``state.json`` (once a round and once at the start), the metrics and
  the checkpoints.
- (c) A batch size that does not divide by the world size raises the
  JAX CLIs' message, in both CLIs, before any rank joins.

Measured: about 30 s on one process.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from semanticsegmentationactivelearning_tpu_torch import active_learning as al
from semanticsegmentationactivelearning_tpu_torch.train import __main__ as cli
from semanticsegmentationactivelearning_tpu_torch.train import checkpoint

from test_torch_al_cli import _write

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "semanticsegmentationactivelearning_tpu_torch"
TRAIN_HW, AL_HW = (32, 48), (32, 64)
# runs a CLI module as a rank and prints how many files it opened for
# writing under the log directory (its first argument)
RANK_RUNNER = r"""
import builtins, os, runpy, sys
log, module = os.path.abspath(sys.argv[1]), sys.argv[2]
writes = []
_open = builtins.open
def counted(file, mode="r", *args, **kwargs):
    if isinstance(file, (str, bytes, os.PathLike)) and set(mode) & set("wax+") \
            and os.path.abspath(os.fsdecode(file)).startswith(log):
        writes.append(os.fsdecode(file))
    return _open(file, mode, *args, **kwargs)
builtins.open = counted
sys.argv = [module] + sys.argv[3:]
try:
    runpy.run_module(module, run_name="__main__")
except SystemExit as e:
    if e.code:
        raise
print("log-writes:", len(writes), sorted(set(os.path.basename(w) for w in writes)))
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _records(root, hw, **splits):
    rng = np.random.default_rng(0)
    for split, n in splits.items():
        os.makedirs(root / split)
        for i in range(n):
            _write(root / split / f"{i:02d}.tfrecord", rng, hw,
                   f"{split}{i}")
    return str(root)


def _two_ranks(module, log, argv):
    """``module`` with ``argv`` as two ranks; returns each rank's count
    of files opened for writing under ``log``."""
    port = _free_port()
    base = {k: v for k, v in os.environ.items()
            if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    procs = []
    for rank in range(2):
        env = dict(base, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE="2", OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_RUNNER, log, module, *argv], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    writes = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, out[-2000:] + err[-4000:]
        # the CLIs log to standard output (util/logging.json)
        assert "backend gloo on cpu" in out and "Data-parallel over 2 " \
            "ranks" in out, out[-2000:]
        writes.append(int(out.split("log-writes:")[1].split()[0]))
    return writes


def _metrics(log):
    with open(os.path.join(log, "metrics.jsonl")) as fp:
        return [json.loads(line) for line in fp]


def test_train_cli_two_ranks(tmp_path):
    """(a): rank 0 alone writes, and the two ranks train as one
    process."""
    rec = _records(tmp_path / "rec", TRAIN_HW, train=8, val=4)
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({
        "batch_size": 4, "epochs": 2,
        "hyperparams": {"learning_rate": 1e-3, "optimizer": {"type": "SGD"},
                        "dropout_rates": [0.01, 0.1, 0.1, 0.1, 0.1]},
        "network": {"model": "ENet",
                    "input": {"height": TRAIN_HW[0], "width": TRAIN_HW[1]}},
        "image_summaries": {"cadence": 1, "count": 1}}))
    logs = {name: str(tmp_path / name) for name in ("one", "two")}
    argv = ["cityscapes", "-d", rec, "-p", str(conf), "--device", "cpu"]
    assert cli.main(cli.parse_args(argv + ["-l", logs["one"]])) == 0
    writes = _two_ranks(f"{PORT}.train", logs["two"],
                        argv + ["-l", logs["two"]])
    assert writes[0] > 0 and writes[1] == 0, writes
    one, two = _metrics(logs["one"]), _metrics(logs["two"])
    assert [r["split"] for r in two] == [r["split"] for r in one]
    assert [r.get("step") for r in two] == [r.get("step") for r in one]
    for name in ("config.json", "checkpoint.json", "model-1.ckpt",
                 "model-2.ckpt", "images"):
        assert os.path.exists(os.path.join(logs["two"], name)), name
    assert sorted(os.listdir(logs["two"])) == sorted(os.listdir(logs["one"]))
    want = checkpoint.restore_checkpoint(logs["one"])
    got = checkpoint.restore_checkpoint(logs["two"])
    assert got.keys() == want.keys()
    for k, v in want.items():
        scale = float(v.abs().max()) if "running" in k else 1.0
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=k)


def _al_conf(path, batch_size=4):
    with open(os.path.join(REPO, "conf",
                           "enet_cityscapes_active_learning.json")) as fp:
        conf = json.load(fp)
    conf["batch_size"] = batch_size
    conf["epochs"] = 1
    conf["hyperparams"]["learning_rate"] = 1e-7
    conf["network"]["input"] = {"height": AL_HW[0], "width": AL_HW[1]}
    conf["active_learning"].update(
        iterations=1, num_initially_labelled=4, num_validation=0,
        selection_size=3, **{"epochs/warm_up": 0})
    path.write_text(json.dumps(conf))
    return str(path)


def test_al_round_two_ranks(tmp_path):
    """(b): the two ranks pick what one process picks, and rank 0 alone
    writes."""
    rec = _records(tmp_path / "rec", AL_HW, train=11, val=2)
    conf = _al_conf(tmp_path / "conf.json")
    logs = {name: str(tmp_path / name) for name in ("one", "two")}
    argv = ["cityscapes", "-d", rec, "-p", conf, "--device", "cpu"]
    assert al.main(al.parse_args(argv + ["-l", logs["one"]])) == 0
    writes = _two_ranks(f"{PORT}.active_learning", logs["two"],
                        argv + ["-l", logs["two"]])
    assert writes[0] > 0 and writes[1] == 0, writes
    states = {}
    for name, log in logs.items():
        with open(os.path.join(log, "state.json")) as fp:
            states[name] = json.load(fp)
    one, two = states["one"], states["two"]
    assert two["iteration"] == 1
    assert len(two["dataset"]["train"]["labelled"]) == 7
    assert two["dataset"] == one["dataset"]
    splits = [r["split"] for r in _metrics(logs["two"])]
    assert splits == [r["split"] for r in _metrics(logs["one"])]
    assert splits.count("al_test") == splits.count("al_timing") == 1
    conf_one, conf_two = (
        [r for r in _metrics(log) if r["split"] == "al_confidence"][0]
        for log in (logs["one"], logs["two"]))
    assert conf_two["histogram"] == conf_one["histogram"]
    np.testing.assert_allclose(conf_two["mean"], conf_one["mean"], rtol=0,
                               atol=1e-6)
    assert os.path.basename(os.path.dirname(two["checkpoint"])) == "pretrain"
    assert os.path.exists(two["checkpoint"] + checkpoint.CKPT_EXT) \
        or os.path.exists(two["checkpoint"])


def test_batch_must_divide_by_the_world(tmp_path, monkeypatch):
    """(c): both CLIs raise the JAX CLIs' message (root
    train.py:170-178) before joining a world of 3 ranks."""
    rec = _records(tmp_path / "rec", AL_HW, train=4, val=1)
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "0")
    message = "batch_size divisible by the global device count 3"
    argv = ["cityscapes", "-d", rec, "-l", str(tmp_path / "log"), "-p",
            _al_conf(tmp_path / "conf.json"), "--device", "cpu"]
    with pytest.raises(ValueError, match=message):
        cli.main(cli.parse_args(argv))
    with pytest.raises(ValueError, match=message):
        al.main(al.parse_args(argv))
    assert not os.path.exists(tmp_path / "log" / "state.json")
