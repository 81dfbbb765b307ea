"""Parity of the PyTorch port's ENet with the JAX package's on the same
converted weights: every block, the seams the kernels plug into, and the
whole eval forward at 1x64x64 fp32, with noised BatchNorm statistics.
Also pins the weight-conversion rules of ``train/bridge.py``.

Tolerance: rtol = atol = 1e-4 (fp32; the two frameworks sum in another
order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semanticsegmentationactivelearning_tpu.models import ENet as JaxENet
from semanticsegmentationactivelearning_tpu_torch.models import (ENet,
                                                                 get_model)
from semanticsegmentationactivelearning_tpu_torch.models import blocks
from semanticsegmentationactivelearning_tpu_torch.train import bridge

from _torch_parity import noised_variables, port_model, to_numpy_tree

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


@pytest.fixture(scope="module")
def pair():
    x = np.random.default_rng(0).uniform(size=(1, 64, 64, 3)) \
        .astype(np.float32)
    jm = JaxENet(num_classes=C)
    variables = noised_variables(jm, x, 0)
    return jm, variables, port_model(variables, C), x


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _switches(shape, seed):
    return np.random.default_rng(seed).integers(0, 4, size=shape) \
        .astype(np.int8)


# (port name, JAX submodule getter, input shape, switch shape or None)
BLOCKS = [
    ("Initial", lambda m: m.Initial_, (1, 64, 64, 3), None),
    ("Bottleneck1_0", lambda m: m.Bottleneck1_0, (1, 32, 32, 16), None),
    ("Bottleneck1_1", lambda m: m.stage1[0], (1, 16, 16, 64), None),
    ("Bottleneck2_0", lambda m: m.Bottleneck2_0, (1, 16, 16, 64), None),
    ("Bottleneck2_2", lambda m: m.stage2[1], (1, 8, 8, 128), None),
    ("Bottleneck2_3", lambda m: m.stage2[2], (1, 8, 8, 128), None),
    ("Bottleneck3_8", lambda m: m.stage3[7], (1, 8, 8, 128), None),
    ("Bottleneck4_0", lambda m: m.Bottleneck4_0, (1, 8, 8, 128),
     (1, 8, 8 * 64)),
    ("Bottleneck4_1", lambda m: m.stage4[0], (1, 16, 16, 64), None),
    ("Bottleneck5_0", lambda m: m.Bottleneck5_0, (1, 16, 16, 64),
     (1, 16, 16 * 16)),
    ("Bottleneck5_1", lambda m: m.Bottleneck5_1, (1, 32, 32, 16), None),
    ("Final", lambda m: m.Final_, (1, 32, 32, 16), None),
]


@pytest.mark.parametrize("name,getter,shape,sw_shape", BLOCKS,
                         ids=[b[0] for b in BLOCKS])
def test_block_matches_jax(pair, name, getter, shape, sw_shape):
    jm, variables, tm, _ = pair
    x = _rand(shape, sum(map(ord, name)))
    args = [jnp.asarray(x)]
    targs = [torch.from_numpy(x)]
    if sw_shape is not None:
        sw = _switches(sw_shape, 7)
        args.append(jnp.asarray(sw))
        targs.append(torch.from_numpy(sw))

    def call(m, *a):
        block = getter(m)
        return block(*a) if name == "Final" else block(*a, False)

    want = jm.apply(variables, *args, method=call)
    with torch.no_grad():
        got = getattr(tm, name)(*targs)
    if isinstance(want, tuple):  # downsample blocks: (out, switches)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   **TOL)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_matches_apply(pair):
    jm, variables, tm, x = pair
    want = np.asarray(jm.apply(variables, jnp.asarray(x), training=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (1, 64, 64, C)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_return_stage1_seam(pair):
    jm, variables, tm, x = pair
    wx1, wsw = jm.apply(variables, jnp.asarray(x), training=False,
                        return_stage1=True)
    with torch.no_grad():
        x1, sw = tm(torch.from_numpy(x), return_stage1=True)
    np.testing.assert_allclose(x1.numpy(), np.asarray(wx1), **TOL)
    np.testing.assert_array_equal(sw.numpy(), np.asarray(wsw))


def test_forward_stage23_seam(pair):
    jm, variables, tm, _ = pair
    x1 = _rand((1, 16, 16, 64), 11)
    wy, wsw = jm.apply(variables, jnp.asarray(x1), method="forward_stage23")
    with torch.no_grad():
        y, sw = tm.forward_stage23(torch.from_numpy(x1))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_array_equal(sw.numpy(), np.asarray(wsw))


def test_forward_tail_seam(pair):
    jm, variables, tm, _ = pair
    y = _rand((1, 8, 8, 128), 12)
    sw2 = _switches((1, 8, 8 * 64), 13)
    sw1 = _switches((1, 16, 16 * 16), 14)

    def tail(m, y, sw2, sw1):
        f4 = m.forward_stage4(y, sw2)
        return m.Final_(m.decode_from_stage4(f4, sw1))

    want = jm.apply(variables, jnp.asarray(y), jnp.asarray(sw2),
                    jnp.asarray(sw1), method=tail)
    with torch.no_grad():
        got = tm.forward_tail(torch.from_numpy(y), torch.from_numpy(sw2),
                              torch.from_numpy(sw1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_noised_statistics_reach_the_port(pair):
    """The running statistics are mapped, not left at their init: the
    same weights with fresh statistics give another forward."""
    _, variables, tm, x = pair
    fresh = ENet(C)
    sd = bridge.state_dict_from_flax(to_numpy_tree(variables))
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = torch.zeros_like(sd[k])
        elif k.endswith("running_var"):
            sd[k] = torch.ones_like(sd[k])
    fresh.load_state_dict(sd)
    with torch.no_grad():
        a = tm(torch.from_numpy(x))
        b = fresh(torch.from_numpy(x))
    assert (a - b).abs().max() > 1e-3
    bn = tm.Bottleneck1_1.proj_bn
    np.testing.assert_array_equal(
        bn.running_var.numpy(),
        np.asarray(variables["batch_stats"]["Bottleneck1_1"]["proj_bn"]
                   ["var"]))


@pytest.mark.parametrize("size", [16, 15])
def test_stride2_same_conv_pads_low_zero(size):
    """A 3x3/s2 SAME conv pads (0, 1) on even sizes, as XLA does."""
    x = _rand((1, size, size, 3), 20)
    k = _rand((3, 3, 3, 4), 21)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    conv = blocks.Conv(3, 4, (3, 3), stride=2)
    conv.weight.data = torch.from_numpy(np.transpose(k, (3, 2, 0, 1)).copy())
    with torch.no_grad():
        got = conv(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_conv_transpose_matches_lax():
    x = _rand((2, 5, 7, 6), 22)
    k = _rand((3, 3, 6, 4), 23)
    want = jax.lax.conv_transpose(jnp.asarray(x), jnp.asarray(k), (2, 2),
                                  "SAME", transpose_kernel=False)
    sd = bridge.state_dict_from_flax({"params": {"Final": {"deconv": {
        "kernel": k}}}})
    deconv = blocks.ConvTranspose(6, 4)
    deconv.weight.data = sd["Final.deconv.weight"]
    with torch.no_grad():
        got = deconv(torch.from_numpy(x))
    assert got.shape == (2, 10, 14, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bridge_carries_multiscale_heads(pair):
    """The multiscale loss heads of a flax tree cross the bridge into an
    ENet built with heads and compute what the flax heads compute; an
    ENet built without heads drops them (strictly, every other key
    loads)."""
    import flax.linen as fnn
    variables = to_numpy_tree(pair[1])
    params = dict(variables["params"])
    rng = np.random.default_rng(7)
    for i, ch in enumerate((16, 64, 128)):
        params[f"MultiscaleHead_{i}"] = {
            "kernel": rng.normal(size=(1, 1, ch, C)).astype(np.float32)}
    sd = bridge.state_dict_from_flax({**variables, "params": params})
    with_heads = ENet(C, multiscale_heads=True)
    with_heads.load_state_dict(sd)
    for i, ch in enumerate((16, 64, 128)):
        x = _rand((1, 8, 8, ch), 20 + i)
        want = fnn.Conv(C, (1, 1), use_bias=False).apply(
            {"params": params[f"MultiscaleHead_{i}"]}, jnp.asarray(x))
        got = getattr(with_heads, f"MultiscaleHead_{i}")(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
    get_model("ENet", C).load_state_dict(sd)  # strict on the rest


def test_get_model():
    assert isinstance(get_model("enet", 3), ENet)
    # ICNet is ported since its scoring slice (tests/test_torch_icnet.py)
    assert type(get_model("ICNet", 3)).__name__ == "ICNet"
    with pytest.raises(NotImplementedError, match="not supported"):
        get_model("UNet", 3)
