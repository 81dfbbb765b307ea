"""Parity of the port's optimizers (``train/optim.py``) with the JAX
package's optax ones: three steps on fixed seeded gradients, with and
without the inverse-time learning-rate decay, for every optimizer of the
conf schema (RMSProp with and without momentum, Momentum with and
without Nesterov), and the schedule itself.

Tolerance: 1e-6 relative with 1e-9 absolute on the parameters after
each step (float32 on both sides). Measured: about 9 s on one process.
"""

import numpy as np
import pytest
import torch

import jax
import optax

from semanticsegmentationactivelearning_tpu.train import optim as joptim
from semanticsegmentationactivelearning_tpu_torch.train import optim

SHAPES = [(3, 4), (5,), (2, 3, 2)]
STEPS = 3

OPTIMIZERS = {
    "adam": {"type": "Adam", "kwargs": {"beta1": 0.9, "beta2": 0.99,
                                        "epsilon": 1e-7}},
    "sgd": {"type": "SGD"},
    "gradientdescent": {"type": "GradientDescent"},
    "momentum": {"type": "Momentum", "kwargs": {"momentum": 0.8}},
    "nesterov": {"type": "Momentum", "kwargs": {"momentum": 0.8,
                                                "use_nesterov": True}},
    "rmsprop": {"type": "RMSProp", "kwargs": {"decay": 0.85}},
    "rmsprop_momentum": {"type": "RMSProp",
                         "kwargs": {"decay": 0.9, "momentum": 0.7,
                                    "epsilon": 1e-6}},
    "adamw": {"type": "AdamW", "kwargs": {"beta1": 0.8, "beta2": 0.95,
                                          "weight_decay": 1e-2}},
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(seed):
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[rng.normal(size=s).astype(np.float32) for s in SHAPES]
             for _ in range(STEPS)]
    return params, grads


@pytest.mark.parametrize("decay", [0.0, 0.5])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_three_steps_match_optax(name, decay):
    hp = {"learning_rate": 1e-2, "learning_rate_decay": decay,
          "optimizer": OPTIMIZERS[name]}
    params, grads = _problem(len(name))
    tx = joptim.make_optimizer(hp, steps_per_epoch=2)
    jparams = {str(i): p for i, p in enumerate(params)}
    jstate = tx.init(jparams)
    update = jax.jit(tx.update)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy()))
               for p in params]
    opt, sched = optim.make_optimizer(tparams, hp, steps_per_epoch=2)
    schedule = joptim.make_schedule(1e-2, decay, 2)
    for step, g in enumerate(grads):
        ups, jstate = update({str(i): x for i, x in enumerate(g)}, jstate,
                             jparams)
        jparams = optax.apply_updates(jparams, ups)
        want_lr = schedule(step) if callable(schedule) else schedule
        np.testing.assert_allclose(sched.get_last_lr()[0], want_lr,
                                   rtol=1e-12)
        for p, x in zip(tparams, g):
            p.grad = torch.from_numpy(x)
        opt.step()
        sched.step()
        for i, p in enumerate(tparams):
            np.testing.assert_allclose(
                p.detach().numpy(), np.asarray(jparams[str(i)]),
                rtol=1e-6, atol=1e-9, err_msg=f"{name} step {step}")


def test_rmsprop_is_not_torchs():
    """optax puts eps inside the root; torch.optim.RMSprop outside: with
    a second moment near eps the two differ, and the port is optax's."""
    g = np.full((4,), 1e-4, np.float32)
    hp = {"learning_rate": 1e-2,
          "optimizer": {"type": "RMSProp", "kwargs": {"epsilon": 1e-6}}}
    tx = joptim.make_optimizer(hp)
    ups, _ = tx.update({"p": g}, tx.init({"p": np.zeros(4, np.float32)}))
    p = torch.nn.Parameter(torch.zeros(4))
    opt, _ = optim.make_optimizer([p], hp)
    p.grad = torch.from_numpy(g)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(ups["p"]),
                               rtol=1e-6)
    q = torch.nn.Parameter(torch.zeros(4))
    torch_rms = torch.optim.RMSprop([q], lr=1e-2, alpha=0.9, eps=1e-6)
    q.grad = torch.from_numpy(g)
    torch_rms.step()
    assert not np.allclose(q.detach().numpy(), p.detach().numpy(),
                           rtol=1e-2)


def test_schedule_and_resume_step():
    hp = {"learning_rate": 4e-3, "learning_rate_decay": 0.25}
    p = torch.nn.Parameter(torch.zeros(2))
    opt, sched = optim.make_optimizer([p], hp, steps_per_epoch=8)
    optim.set_schedule_step(sched, 12)
    want = 4e-3 / (1 + 0.25 * 12 / 8)
    assert sched.get_last_lr()[0] == pytest.approx(want, rel=1e-12)
    assert opt.param_groups[0]["lr"] == pytest.approx(want, rel=1e-12)
    assert optim.make_schedule(1e-3, 0.0, 5) == 1e-3
    with pytest.raises(NotImplementedError):
        optim.make_optimizer([p], {"optimizer": {"type": "Lion"}})
