"""ENet's train mode in the port (``models/blocks.py``,
``models/enet.py``) against the JAX package's: the multiscale forward in
training (batch statistics, rates 0) against ``model.apply(...,
training=True, multiscale=True, mutable=["batch_stats"])`` on the same
seeded weights at 2x32x64, 19 classes, and the law of spatial dropout.

The parity runs in float64 on both sides (the JAX model with ``dtype``
float64 under ``jax.enable_x64``): logits and heads to 1e-4 of each
tensor's largest magnitude, the running statistics to 1e-5 absolute. In
float32 the two frameworks' rounding moves this shape's deepest
batch-normalised activations apart: measured 7.3e-4 on heads of up to 22
and 6.4e-5 on the statistics, the JAX side 15 times further from the
float64 result than the port. The port's float32 forward is held to its
float64 one instead, at the float32 bound below.
Measured: about 9 s on one process.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semanticsegmentationactivelearning_tpu.models import ENet as JaxENet
from semanticsegmentationactivelearning_tpu_torch.models import ENet
from semanticsegmentationactivelearning_tpu_torch.ops import nn as xops
from semanticsegmentationactivelearning_tpu_torch.train import bridge

from _torch_parity import fast_jit, flax_variables, seeded_port_enet

C = 19
SHAPE = (2, 32, 64, 3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def forward_pair():
    """(JAX heads and new statistics, the port's heads and model after
    one train-mode forward), both in float64, plus the port in
    float32."""
    model = seeded_port_enet(C, 0)
    model32 = copy.deepcopy(model)
    model64 = model.double()
    x = np.random.default_rng(1).uniform(size=SHAPE)
    variables = flax_variables(model64)
    with jax.enable_x64(True):
        jm = JaxENet(num_classes=C, drop_rates=(0.0,) * 5,
                     dtype=jnp.float64, fp32_logits=False)
        fn = fast_jit(lambda v, x: jm.apply(
            v, x, training=True, multiscale=True,
            mutable=["batch_stats"]), variables, x)
        (_, heads), mutated = fn(variables, x)
        want = [np.asarray(h) for h in heads]
        stats = jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])
    with torch.no_grad():
        _, got = model64(torch.from_numpy(x), training=True,
                         multiscale=True)
        _, got32 = model32(torch.from_numpy(x).float(), training=True,
                           multiscale=True)
    return want, stats, got, model64, got32, model32


def test_multiscale_forward_matches_apply(forward_pair):
    want, _, got, _, _, _ = forward_pair
    assert [tuple(g.shape) for g in got] == [
        (2, 32, 64, C), (2, 16, 32, C), (2, 8, 16, C), (2, 4, 8, C)]
    for w, g in zip(want, got):
        scale = np.abs(w).max()
        assert scale > 1.0
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * scale)


def test_running_statistics_match(forward_pair):
    _, stats, _, model64, _, _ = forward_pair
    want = bridge.state_dict_from_flax({"batch_stats": stats})
    got = model64.state_dict()
    assert len(want) == 2 * sum(1 for k in got if k.endswith("running_mean"))
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_float32_forward_holds_to_float64(forward_pair):
    """The port in float32 against itself in float64: heads to 1e-4 of
    their largest magnitude (measured 4.4e-5 on 22), statistics to 1e-4
    absolute."""
    _, _, got64, model64, got32, model32 = forward_pair
    for g64, g32 in zip(got64, got32):
        scale = g64.abs().max().item()
        np.testing.assert_allclose(g32.double().numpy(), g64.numpy(),
                                   rtol=0, atol=1e-4 * scale)
    sd64 = model64.state_dict()
    for k, v in model32.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.double().numpy(), sd64[k].numpy(),
                                       rtol=0, atol=1e-4, err_msg=k)


def test_spatial_dropout_law():
    """Keep share 1 - rate, kept values scaled by 1/keep, one draw per
    (example, channel) over the whole plane, the same draws from the
    same generator."""
    x = torch.ones(64, 3, 5, 96)
    rate = 0.3
    out = xops.spatial_dropout(x, rate, torch.Generator().manual_seed(0))
    per_nc = out[:, 0, 0, :]
    assert torch.equal(out, per_nc[:, None, None, :].expand_as(out))
    kept = per_nc != 0
    np.testing.assert_allclose(per_nc[kept].numpy(), 1.0 / (1.0 - rate),
                               rtol=1e-7)
    n = kept.numel()
    share = kept.float().mean().item()
    # 5 standard deviations of a binomial share at n = 6144
    assert abs(share - (1 - rate)) < 5 * np.sqrt(rate * (1 - rate) / n)
    again = xops.spatial_dropout(x, rate, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    other = xops.spatial_dropout(x, rate, torch.Generator().manual_seed(1))
    assert not torch.equal(out, other)
    assert xops.spatial_dropout(x, rate, None, training=False) is x


def test_train_forward_draws_dropout_from_the_generator():
    """The conf's rates reach every stage; the same generator seed gives
    the same train forward, another seed another one, and the eval
    forward draws nothing."""
    model = ENet(5, drop_rates=(0.01, 0.1, 0.2, 0.3, 0.4))
    rates = {name.split("_")[0]: blk.drop_rate
             for name, blk in model.named_children()
             if hasattr(blk, "drop_rate")}
    assert rates == {"Bottleneck1": 0.01, "Bottleneck2": 0.1,
                     "Bottleneck3": 0.2, "Bottleneck4": 0.3,
                     "Bottleneck5": 0.4}
    x = torch.rand(2, 16, 32, 3, generator=torch.Generator().manual_seed(2))
    state = copy.deepcopy(model.state_dict())

    def train_forward(seed):
        model.load_state_dict(state)
        with torch.no_grad():
            return model(x, training=True,
                         generator=torch.Generator().manual_seed(seed))

    assert torch.equal(train_forward(3), train_forward(3))
    assert not torch.equal(train_forward(3), train_forward(4))
    gen = torch.Generator().manual_seed(5)
    before = gen.get_state()
    with torch.no_grad():
        model(x, generator=gen)
    assert torch.equal(gen.get_state(), before)
    with pytest.raises(ValueError, match="multiscale_heads"):
        model(x, multiscale=True)
