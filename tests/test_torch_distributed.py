"""The port's multi-process slice on the CPU (``parallel.distributed``):
two Gloo ranks, spawned as subprocesses on a free port as
``tests/test_multihost.py`` spawns its JAX processes, but with torch
only (``tests/_torch_dist_worker.py``), each on its rows of every
global batch; the one-process references run here.

- (a) One ENet-19 train step at 4x32x64 in float64, dropout on (the
  masks keyed by the global row, ``train.steps.dropout_masks``), the
  pretrain conf's multiscale loss, SGD, L1 and L2, one padding row:
  both ranks against one process on the global batch. The weights and
  the BN running statistics (the biased variance) within 1e-9 of their
  magnitude; the update itself within 1e-6 of one process's, the loss
  to float32's rounding: the CE is float32 on both sides, as in the
  JAX package, and the ranks sum their shares in another order. A lone
  BatchNorm's running statistics: the global batch's mean and biased
  variance.
- (b) The same step with dropout 0 and SGD at 8x32x48, 4 classes, in
  float32, against the JAX package's data-parallel step over a 2-device
  CPU mesh (``make_train_step(..., mesh=make_mesh(2))``) on the
  converted weights: the weights and statistics within 1e-4, the loss
  within 1e-4 relative (``tests/test_parallel.py``'s tolerances).
- (c) The eval step's confusion matrix, and ENet's entropy and BALD
  pool scores and core-set embeddings through the AL CLI's pool pass
  (``active_learning.score_pool``, ``embed_pool``) over 7 records at
  global batch 4, gathered in pool order: equal on both ranks and to
  one process's (the counts exactly, the scores and embeddings within
  1e-6).
- (d) ``inference.make_predict_fn`` over the devices ``[cpu, cpu]``
  against one device: the same maps, a batch that does not divide by
  the device count served on the first.

Measured: about 40 s on one process (the JAX step's compile ~12 s, the
two ranks ~10 s).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

import jax

from semanticsegmentationactivelearning_tpu.models import ENet as JaxENet
from semanticsegmentationactivelearning_tpu.parallel import make_mesh
from semanticsegmentationactivelearning_tpu.train import (
    make_train_step as jax_make_train_step)
from semanticsegmentationactivelearning_tpu.train.steps import (
    TrainState as JaxTrainState)
from semanticsegmentationactivelearning_tpu_torch import inference
from semanticsegmentationactivelearning_tpu_torch.models import ENet
from semanticsegmentationactivelearning_tpu_torch.models.blocks import (
    BatchNorm)
from semanticsegmentationactivelearning_tpu_torch.train import bridge, steps

from _torch_dist_worker import bn_step, pool_scores, train_step
from _torch_parity import (FAST_COMPILE, TRAIN_C, TRAIN_HW, noised_variables,
                           seeded_port_enet, to_numpy_tree, train_hyperparams)
from test_torch_al_cli import _write

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")
RATES = (0.01, 0.1, 0.1, 0.1, 0.1)
G = 4                     # (a), (c): the global batch
JAX_C, JAX_HW, JAX_G = 4, (32, 48), 8   # (b): test_parallel.py's shape
JAX_HP = {"learning_rate": 1e-3, "learning_rate_decay": 0.0,
          "optimizer": {"type": "SGD"},
          "weight_reg": {"L2": 2e-4, "L1": 0.0, "glorot_scaling": False},
          "softmax": {"label_smoothing": 0.0, "loginverse_scaling": 0.0,
                      "multiscale": False}}
POOL = 7                  # (c): records in the pool


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _noised_enet(dtype=torch.float64):
    """The seeded ENet-19 with dropout and the multiscale heads, its BN
    biases drawn N(0, 0.1) (a trained model's are not 0, and a weight
    that starts at 0 holds only its update)."""
    model = seeded_port_enet(TRAIN_C, 0, drop_rates=RATES)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.bias += torch.from_numpy(rng.normal(
                    size=m.bias.shape, scale=0.1).astype(np.float32))
    return model.to(dtype)


def _train_batch(rng, n, hw, classes, dtype):
    return {"image": torch.from_numpy(rng.uniform(size=(n, *hw, 3))).to(dtype),
            "label": torch.from_numpy(rng.integers(0, classes, (n, *hw))),
            "mask": torch.from_numpy(
                (rng.uniform(size=(n, *hw)) > 0.1).astype(np.float64))
            .to(dtype),
            "valid": torch.ones(n, dtype=dtype)}


def _jax_case():
    """(b)'s JAX model, its flax variables (numpy draws, the BN
    statistics noised) and batch."""
    jm = JaxENet(num_classes=JAX_C, drop_rates=(0.0,) * 5)
    variables = noised_variables(
        jm, np.zeros((1, *JAX_HW, 3), np.float32), 2)
    rng = np.random.default_rng(0)
    batch = {"image": rng.uniform(size=(JAX_G, *JAX_HW, 3)).astype(np.float32),
             "label": rng.integers(0, JAX_C, (JAX_G, *JAX_HW)).astype(np.int32),
             "mask": np.ones((JAX_G, *JAX_HW), np.float32),
             "valid": np.ones((JAX_G,), np.float32)}
    return jm, variables, batch


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """The inputs of (a)-(c), and what each rank got from them."""
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("ranks")
    batch_a = _train_batch(np.random.default_rng(3), G, TRAIN_HW, TRAIN_C,
                           torch.float64)
    batch_a["valid"][-1] = 0.0   # a padding row, on the second rank
    a = {"model": _noised_enet(), "batch": batch_a, "classes": TRAIN_C,
         "hp": train_hyperparams(True)}
    jm, variables, jbatch = _jax_case()
    port = ENet(JAX_C, drop_rates=(0.0,) * 5)
    port.load_state_dict(bridge.state_dict_from_flax(to_numpy_tree(
        variables)))
    b = {"model": port, "classes": JAX_C, "hp": JAX_HP,
         "batch": {"image": torch.from_numpy(jbatch["image"]),
                   "label": torch.from_numpy(jbatch["label"]).long(),
                   "mask": torch.from_numpy(jbatch["mask"]),
                   "valid": torch.from_numpy(jbatch["valid"])}}
    rng = np.random.default_rng(4)
    os.makedirs(tmp / "pool")
    files = []
    for i in range(POOL):
        files.append(str(tmp / "pool" / f"{i}.tfrecord"))
        _write(files[-1], rng, TRAIN_HW, f"pool{i}")
    c = {"model": _noised_enet(torch.float32).eval(), "classes": TRAIN_C,
         "files": files, "hw": TRAIN_HW,
         "batch": _train_batch(rng, G, TRAIN_HW, TRAIN_C, torch.float32),
         "bn_input": torch.from_numpy(rng.normal(
             loc=2.0, size=(G, 5, 7, 6)))}
    inputs = {"a": a, "b": b, "c": c}
    torch.save(inputs, tmp / "inputs.pt")

    port_no = _free_port()
    base = {k: v for k, v in os.environ.items()
            if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    procs = []
    for rank in range(2):
        env = dict(base, MASTER_ADDR="localhost", MASTER_PORT=str(port_no),
                   WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE="2", OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(tmp)], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, out + err[-4000:]
        assert "backend gloo on cpu (ranks on the CPU)" in err, err[-2000:]
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    # a fresh copy of each input: the ranks stepped their own
    return torch.load(tmp / "inputs.pt", weights_only=False), ranks, \
        (jm, variables, jbatch)


def _rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


def test_two_rank_step_equals_one_process(cases):
    """(a): the two ranks' step equals one process's on the global batch,
    in float64 with dropout on."""
    inputs, ranks, _ = cases
    x = inputs["a"]
    before = {k: v.clone() for k, v in x["model"].state_dict().items()}
    want, want_sd = train_step(x, slice(None))
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        got, got_sd = r["a"]
        np.testing.assert_allclose(got["loss"].item(), want["loss"].item(),
                                   rtol=2.0 ** -22)
        np.testing.assert_allclose(got["cost"].item(), want["cost"].item(),
                                   rtol=2.0 ** -22)
        assert torch.equal(got["confusion"], want["confusion"])
        assert got_sd.keys() == want_sd.keys()
        for k, v in want_sd.items():
            assert _rel(got_sd[k], v) <= 1e-9, k
            if "running" not in k:
                assert _rel(got_sd[k] - before[k], v - before[k]) <= 1e-6, k
    # the ranks' replicas stay bit-equal
    for k, v in ranks[0]["a"][1].items():
        assert torch.equal(v, ranks[1]["a"][1][k]), k
    # one BN layer alone: the global batch's mean and biased variance
    bn_input = inputs["c"]["bn_input"]
    flat = bn_input.reshape(-1, bn_input.shape[-1])
    want_stats = (0.1 * flat.mean(0),
                  0.9 + 0.1 * flat.var(0, unbiased=False))
    for r in ranks:
        for got, w in zip(r["bn"], want_stats):
            assert _rel(got, w) <= 1e-12
        for got, w in zip(r["bn"], bn_step(bn_input, slice(None))):
            assert _rel(got, w) <= 1e-12


def test_two_rank_step_equals_jax_dp_step(cases):
    """(b): the ranks' float32 step against the JAX step over a 2-device
    mesh on the same converted weights."""
    _, ranks, (jm, variables, jbatch) = cases
    tx = optax.sgd(JAX_HP["learning_rate"])
    step = jax_make_train_step(jm, tx, JAX_C, JAX_HP, mesh=make_mesh(2))
    state = JaxTrainState(params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]),
                          step=np.zeros((), np.int32),
                          epoch=np.zeros((), np.int32))
    key = jax.random.PRNGKey(5)
    compiled = step.lower(state, jbatch, key).compile(
        compiler_options=FAST_COMPILE)
    new, m = compiled(state, jbatch, key)
    want = bridge.state_dict_from_flax(to_numpy_tree(
        {"params": new.params, "batch_stats": new.batch_stats}))
    for r in ranks:
        got, got_sd = r["b"]
        np.testing.assert_allclose(got["loss"].item(), float(m["loss"]),
                                   rtol=1e-4)
        assert int(got["confusion"].sum()) == \
            int(np.asarray(m["confusion"]).sum())
        assert want.keys() == got_sd.keys()
        worst = max((got_sd[k] - v).abs().max().item()
                    for k, v in want.items())
        assert worst < 1e-4, worst


def test_two_rank_eval_and_pool_scores(cases):
    """(c): the eval confusion and the pool pass's entropy and BALD
    scores, gathered in pool order, as one process's on every rank."""
    inputs, ranks, _ = cases
    x = inputs["c"]
    want_conf = steps.make_eval_step(x["model"], TRAIN_C)(x["batch"])
    want = pool_scores(x["model"], TRAIN_C, x["files"], TRAIN_HW, G, 1)
    for r in ranks:
        assert torch.equal(r["confusion"], want_conf)
        for name in ("entropy", "bald", "embed"):
            got = r["scores"][name]
            assert got.shape[0] == POOL and np.all(got.any(-1) if
                                                   got.ndim > 1 else got > 0)
            np.testing.assert_allclose(got, want[name], rtol=0, atol=1e-6,
                                       err_msg=name)
    assert want_conf.sum() > 0
    for name in ("entropy", "bald", "embed"):
        np.testing.assert_array_equal(ranks[0]["scores"][name],
                                      ranks[1]["scores"][name])


def test_predict_fn_over_two_devices():
    """(d): serving over the device list ``[cpu, cpu]`` (the batch split
    by rows, a replica a device, the maps gathered in order) gives one
    device's maps; a batch of 3 serves on the first device."""
    torch.set_num_threads(1)
    model = seeded_port_enet(TRAIN_C, 3, multiscale_heads=False)
    lut = torch.arange(256, dtype=torch.uint8)
    rng = np.random.default_rng(6)
    cpu = torch.device("cpu")
    one = inference.make_predict_fn(model, lut, 30, 60, 3, cpu)
    two = inference.make_predict_fn(model, lut, 30, 60, 3, [cpu, cpu])
    for n in (4, 3):
        stack = torch.from_numpy(rng.integers(0, 256, (n, *TRAIN_HW, 4))
                                 .astype(np.uint8))
        want = one(stack)
        got = two(stack)
        assert got.shape == (n, 30, 60) and got.dtype == torch.uint8
        assert torch.equal(got, want)
