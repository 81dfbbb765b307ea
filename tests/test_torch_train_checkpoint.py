"""The port's training checkpoints (``train/checkpoint.py``): the
manager's FIFO, state file, counter, cache/commit/chdir protocol and
background writes; resuming from a port training checkpoint (4 steps
straight equal 2 steps, a save, a restore into a fresh state and 2 more,
bit for bit on the CPU, with dropout and Adam); resuming from a
checkpoint the JAX package wrote (its weights, step and epoch, a fresh
optimizer); and serving's ``restore_checkpoint`` reading the model of a
training checkpoint. Small ENets at 2x16x32. Measured: about 11 s on one
process.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticsegmentationactivelearning_tpu.train import (
    checkpoint as jax_checkpoint)
from semanticsegmentationactivelearning_tpu.train import optim as jax_optim
from semanticsegmentationactivelearning_tpu.train.steps import (
    TrainState as JaxTrainState)
from semanticsegmentationactivelearning_tpu_torch.models import ENet
from semanticsegmentationactivelearning_tpu_torch.train import (
    checkpoint, optim, steps)

from _torch_parity import flax_variables, seeded_port_enet

C = 5
HP = {"learning_rate": 1e-3, "learning_rate_decay": 0.5,
      "optimizer": {"type": "Adam", "kwargs": {"beta1": 0.9, "beta2": 0.99}},
      "weight_reg": {"L2": 2e-4, "L1": 0.0, "glorot_scaling": False},
      "softmax": {"multiscale": True, "label_smoothing": 0.0,
                  "loginverse_scaling": 0.0}}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(seed=0):
    model = ENet(C, multiscale_heads=True)
    optimizer, scheduler = optim.make_optimizer(model.parameters(), HP,
                                                steps_per_epoch=2)
    return steps.create_train_state(model, optimizer, scheduler, seed=seed)


def _batch(i):
    rng = np.random.default_rng(100 + i)
    return {"image": torch.from_numpy(
                rng.uniform(size=(2, 16, 32, 3)).astype(np.float32)),
            "label": torch.from_numpy(rng.integers(0, C, (2, 16, 32))),
            "mask": torch.ones(2, 16, 32), "valid": torch.ones(2)}


def _train(state, first, last):
    step = steps.make_train_step(state.model, C, HP)
    for i in range(first, last):
        step(state, _batch(i), torch.Generator().manual_seed(i))


def _assert_same(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert a.scheduler.get_last_lr() == b.scheduler.get_last_lr()
    assert (a.step, a.epoch) == (b.step, b.epoch)


def test_resume_equals_training_straight(tmp_path):
    straight = _state()
    _train(straight, 0, 4)
    resumed = _state()
    _train(resumed, 0, 2)
    resumed.epoch = 1
    path = checkpoint.save_training_state(str(tmp_path / "m.ckpt"),
                                          resumed)
    fresh = _state(seed=9)
    checkpoint.restore_training_state(path, fresh)
    assert (fresh.step, fresh.epoch) == (2, 1)
    _train(fresh, 2, 4)
    fresh.epoch = straight.epoch = 1
    assert straight.step == 4
    _assert_same(straight, fresh)


def test_manager_fifo_state_file_and_counter(tmp_path):
    state = _state()
    d = str(tmp_path / "run")
    manager = checkpoint.CheckpointManager(d, max_to_keep=2)
    paths = [manager.save("model", state) for _ in range(3)]
    assert [os.path.basename(p) for p in paths] == [
        "model-1.ckpt", "model-2.ckpt", "model-3.ckpt"]
    assert not os.path.exists(paths[0])
    with open(os.path.join(d, checkpoint.STATE_FILE)) as fp:
        meta = json.load(fp)
    assert meta == {"latest": "model-3.ckpt",
                    "checkpoints": ["model-2.ckpt", "model-3.ckpt"],
                    "save_counter": 3}
    assert checkpoint.latest_checkpoint(d) == paths[2]
    # a new manager in the same directory continues the counter
    again = checkpoint.CheckpointManager(d, max_to_keep=2)
    assert again.save_counter == 3
    assert os.path.basename(again.save("model", state)) == "model-4.ckpt"
    assert not os.path.exists(paths[1])


def test_manager_cache_commit_and_chdir(tmp_path):
    state = _state()
    manager = checkpoint.CheckpointManager(str(tmp_path / "a"))
    assert manager.commit("best") == ""
    cached = manager.cache(state)
    assert os.path.basename(cached) == "tmp.ckpt" and os.path.exists(cached)
    best = manager.commit("best")
    assert os.path.basename(best) == "best-1.ckpt"
    assert not os.path.exists(cached)
    assert manager.latest_checkpoint == best
    manager.cache(state)
    manager.chdir(str(tmp_path / "b"))
    assert not os.path.exists(cached)           # the uncommitted cache
    assert manager.latest_checkpoint == ""
    assert os.path.basename(manager.save("model", state)) == "model-2.ckpt"


def test_async_write_holds_the_state_at_save(tmp_path):
    state = _state()
    manager = checkpoint.CheckpointManager(str(tmp_path), async_io=True)
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    path = manager.save("model", state)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    manager.close()
    got = torch.load(path, weights_only=True)["model"]
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert checkpoint.latest_checkpoint(str(tmp_path)) == path


def test_jax_checkpoint_gives_weights_step_and_epoch(tmp_path):
    """A TrainState the JAX package saved (Adam moments as one raveled
    optax.flatten buffer): the port takes its weights, step and epoch,
    starts Adam fresh and puts the schedule at the restored step."""
    src = seeded_port_enet(C, 4, drop_rates=(0.01, 0.1, 0.1, 0.1, 0.1))
    variables = flax_variables(src)
    tx = jax_optim.make_optimizer(HP, steps_per_epoch=2)
    jstate = JaxTrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        step=jnp.asarray(7, jnp.int32), epoch=jnp.asarray(3, jnp.int32))
    path = jax_checkpoint.save_checkpoint(str(tmp_path / "model-3.ckpt"),
                                          jstate)
    state = _state(seed=1)
    checkpoint.restore_training_state(str(tmp_path), state)
    assert (state.step, state.epoch) == (7, 3)
    assert state.optimizer.state_dict()["state"] == {}
    assert state.scheduler.get_last_lr()[0] == pytest.approx(
        1e-3 / (1 + 0.5 * 7 / 2), rel=1e-12)
    want = src.state_dict()
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    # and it trains on from there
    _train(state, 0, 1)
    assert state.step == 8
    assert os.path.exists(path)


def test_serving_reads_the_model_of_a_training_checkpoint(tmp_path):
    state = _state()
    _train(state, 0, 1)
    path = checkpoint.save_training_state(str(tmp_path / "model-1.ckpt"),
                                          state)
    served = ENet(C)           # no heads: serving drops them
    checkpoint.restore_checkpoint(str(tmp_path), served)
    for k, v in served.state_dict().items():
        assert torch.equal(v, state.model.state_dict()[k]), k
    assert checkpoint.latest_checkpoint(str(tmp_path)) == path
