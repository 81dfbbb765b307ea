"""The port's train step against the JAX package's ``make_train_step``
with the AL conf's loss (multiscale off, log-inverse weights 1.02), by
one SGD step and one Adam step (lr 1e-3), on the seeded ENet-19 at
2x32x64 with dropout rates 0. The multiscale case and the repair of the
stale weight packs are in ``tests/test_torch_train_step.py``; the JAX
reference (float64 on both sides, why: ``tests/_torch_parity.py``) is
computed once. Tolerances: as that file's; Adam (eps 1e-3, see
``_torch_parity.ADAM_EPS``) to 1e-6 absolute, under the 5e-4 bound of
``tests/test_train.py``'s Adam comparison. Also ``chip_smoke.py``'s
switch-aware float64 reference on this step. Measured: about 29 s on
one process, 20 s of it the JAX compile; the reference's test adds
about 4 s.
"""

import numpy as np
import pytest
import torch

import optax

from semanticsegmentationactivelearning_tpu_torch.train import bridge

from _torch_parity import (ADAM_EPS, check_sgd_step, jax_train_step,
                           optax_updated, port_train_step)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_sgd_step_matches_jax():
    check_sgd_step(False)


def test_adam_step_matches_jax():
    (_, grads, _), variables = jax_train_step(False)
    state, _ = port_train_step(False, "Adam", lr=1e-3)
    params = optax_updated(variables, grads,
                           optax.adam(1e-3, b1=0.9, b2=0.99, eps=ADAM_EPS))
    expect = bridge.state_dict_from_flax({"params": params})
    sd = state.model.state_dict()
    for k, v in expect.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_switch_aware_float64_reference():
    """``chip_smoke.py``'s float64 reference of phases 10a, 11a and 13a:
    the float64 step forced onto the float32 step's 2x2 pool switches
    (here the same as its own: no window flips) reads the free float64
    step's loss and BN statistics, and a switch moved at a decided window
    fails ``check_flips``."""
    from chip_smoke import check_flips, forced_switches, recorded_switches
    _, switches = recorded_switches(
        lambda: port_train_step(False, dtype=torch.float32))
    (state, got), flips = forced_switches(lambda: port_train_step(False),
                                          switches)
    assert len(flips) == len(switches) == 2
    assert check_flips(flips, "own switches").startswith("0 windows")
    want_state, want = port_train_step(False)
    assert got["loss"].item() == want["loss"].item()
    for (name, b), (_, w) in zip(state.model.named_buffers(),
                                 want_state.model.named_buffers()):
        assert torch.equal(b, w), name
    moved = [s.clone() for s in switches]
    moved[1].view(-1)[:16] = (moved[1].view(-1)[:16] + 1) % 4
    _, flips = forced_switches(lambda: port_train_step(False), moved)
    assert flips[1][0] == 16
    with pytest.raises(AssertionError, match="at a decided window"):
        check_flips(flips, "moved switches")
