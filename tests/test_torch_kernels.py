"""The PyTorch port's kernel modules (ops/kernels) against the JAX
package's Pallas kernels, run as the JAX tests run them on the CPU
(interpret mode), on the same inputs and converted weights at 1x64x64
fp32 with noised BatchNorm statistics.

On the CPU each wrapper runs its plain version, so these tests pin the
plain versions the CUDA kernels are compared with on the card
(chip_smoke.py, and the ``cuda``-marked tests of test_torch_cuda.py,
which skip here).

Tolerance: features rtol = atol = 1e-4; switches and masks exact where
the pooled window's top-2 gap exceeds 1e-4; labels exact where the
top-2 logit margin exceeds 1e-4 (tests/test_pallas_kernels.py
``_assert_labels_match``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticsegmentationactivelearning_tpu.models import ENet as JaxENet
from semanticsegmentationactivelearning_tpu.ops import pallas_kernels
from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
    front, mid, tail)

from _torch_parity import (assert_labels_match, fast_jit, noised_variables,
                           port_model)

TOL = dict(rtol=1e-4, atol=1e-4)
C = 5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process while the suite's workers share the
    cores: with a thread per core in each worker this file's torch work
    ran tens of times slower than alone. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def window_gap(x):
    """Top-2 gap of every 2x2 pool window: [N,H,W,C] -> [N,H/2,W/2,C]."""
    n, h, w, c = x.shape
    win = x.reshape(n, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 5, 2, 4)
    top2 = np.sort(win.reshape(n, h // 2, w // 2, c, 4), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def jax_logits(jm, variables, x):
    """JAX ENet's eval logits, jitted (eager flax dispatch compiles every
    op alone)."""
    return fast_jit(lambda v, x: jm.apply(v, x, training=False),
                    variables, x)(variables, x)


@pytest.fixture(scope="module")
def setup():
    x = np.random.default_rng(3).uniform(size=(1, 64, 64, 3)) \
        .astype(np.float32)
    jm = JaxENet(num_classes=C)
    variables = noised_variables(jm, x, 4)
    return jm, variables, port_model(variables, C), x


@pytest.fixture(scope="module")
def jax_front(setup):
    _, variables, _, x = setup
    x1, mask1 = pallas_kernels.fused_front_stage1_w(
        jnp.asarray(x), pallas_kernels.pack_enet_front_w(variables),
        interpret=True, out_dtype=jnp.float32)
    return np.array(x1), np.array(mask1)


@pytest.fixture(scope="module")
def jax_mid(setup, jax_front):
    jm, variables, _, _ = setup
    y, sw2 = fast_jit(lambda v, x: jm.apply(v, x, method="forward_stage23"),
                      variables, jax_front[0])(variables, jax_front[0])
    n, h8, w8, _ = y.shape
    return np.array(y), np.array(sw2).reshape(n, h8, w8, 64)


def test_front_matches_pallas_front(setup, jax_front):
    jm, variables, tm, x = setup
    want_x1, want_mask = jax_front
    with torch.no_grad():
        x1, mask1 = front.fused_front_stage1(torch.from_numpy(x), tm)
    np.testing.assert_allclose(x1.numpy(), want_x1, **TOL)
    assert mask1.shape == want_mask.shape == (1, 16, 16, 64)
    h0 = np.asarray(jm.apply(variables, jnp.asarray(x),
                             method=lambda m, x: m.Initial_(x, False)))
    gap = window_gap(h0)                                   # [1,16,16,16]
    sw = mask1.numpy().reshape(1, 16, 16, 4, 16).argmax(3)
    want_sw = want_mask.reshape(1, 16, 16, 4, 16).argmax(3)
    assert (gap > 1e-4).mean() > 0.9
    np.testing.assert_array_equal(sw[gap > 1e-4], want_sw[gap > 1e-4])
    assert set(np.unique(mask1.numpy())) <= {0.0, 1.0}
    np.testing.assert_array_equal(
        mask1.numpy().reshape(1, 16, 16, 4, 16).sum(3), 1.0)


def test_mask_switch_round_trip():
    rng = np.random.default_rng(5)
    sw = torch.from_numpy(rng.integers(0, 4, (2, 3, 4 * 16))
                          .astype(np.int8))
    mask = front.switches_to_mask(sw)
    assert mask.shape == (2, 3, 4, 64)
    torch.testing.assert_close(tail.mask_to_switches(mask), sw)


def test_mid_matches_jax_stage23(setup, jax_front, jax_mid):
    _, _, tm, _ = setup
    want_y, want_sw2 = jax_mid
    with torch.no_grad():
        y, sw2 = mid.fused_mid_stage23(torch.from_numpy(jax_front[0]), tm)
    assert sw2.dtype == torch.int8 and sw2.shape == (1, 8, 8, 64)
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    gap = window_gap(jax_front[0])
    np.testing.assert_array_equal(sw2.numpy()[gap > 1e-4],
                                  want_sw2[gap > 1e-4])


def test_tail_predict_matches_pallas_tail(setup, jax_front, jax_mid):
    jm, variables, tm, x = setup
    y, sw2 = jax_mid
    mask1 = jax_front[1]
    want = pallas_kernels.fused_tail_predict(
        jnp.asarray(y), jnp.asarray(sw2), jnp.asarray(mask1),
        pallas_kernels.pack_enet_tail(variables, C), C, interpret=True)
    with torch.no_grad():
        got = tail.fused_tail_predict(torch.from_numpy(y),
                                      torch.from_numpy(sw2),
                                      torch.from_numpy(mask1), tm)
    assert got.dtype == torch.int8 and got.shape == (1, 64, 64)
    logits = jax_logits(jm, variables, x)
    assert_labels_match(got.numpy(), logits)
    assert_labels_match(np.asarray(want), logits)


def test_fused_predict_at_a_width_without_tpu_kernels(setup):
    """W = 48 is not a multiple of 32, where the JAX package has no
    fused predict chain; the port's chain needs only H, W % 8."""
    jm, variables, tm, _ = setup
    x = np.random.default_rng(6).uniform(size=(2, 56, 48, 3)) \
        .astype(np.float32)
    got = tm.fused_predict(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (2, 56, 48)
    logits = jax_logits(jm, variables, x)
    assert_labels_match(got.numpy(), logits)


def test_fused_predict_rejects_bad_shapes(setup):
    tm = setup[2]
    with pytest.raises(ValueError):
        tm.fused_predict(torch.zeros(1, 60, 64, 3))
    with pytest.raises(ValueError):
        tm.fused_predict(torch.zeros(1, 64, 64, 4))


def test_launch_counters_stay_zero_on_cpu(setup):
    tm = setup[2]
    wrappers = (front.fused_front_stage1, mid.fused_mid_stage23,
                tail.fused_tail_predict)
    before = [fn.launches for fn in wrappers]
    tm.fused_predict(torch.zeros(1, 16, 16, 3))
    assert [fn.launches for fn in wrappers] == before == [0, 0, 0]


def test_no_fallback_for_other_devices(setup):
    """A tensor that is neither on the CPU nor on a CUDA device raises
    instead of silently taking the plain path."""
    tm = setup[2]
    with pytest.raises(ValueError, match="CUDA"):
        front.fused_front_stage1(torch.empty(1, 16, 16, 3, device="meta"),
                                 tm)
    with pytest.raises(ValueError, match="CUDA"):
        mid.fused_mid_stage23(torch.empty(1, 4, 4, 64, device="meta"), tm)
    with pytest.raises(ValueError, match="CUDA"):
        tail.fused_tail_predict(
            torch.empty(1, 2, 2, 128, device="meta"),
            torch.empty(1, 2, 2, 64, dtype=torch.int8, device="meta"),
            torch.empty(1, 4, 4, 64, device="meta"), tm)


def test_packs_are_cached_until_load_state_dict(setup):
    tm = setup[2]
    calls = []

    def build(model):
        calls.append(1)
        return front.pack_front(model)

    tm.clear_packs()
    a = tm.packed("front", torch.device("cpu"), build)
    b = tm.packed("front", torch.device("cpu"), build)
    assert a is b and len(calls) == 1
    tm.load_state_dict(tm.state_dict())
    tm.packed("front", torch.device("cpu"), build)
    assert len(calls) == 2
