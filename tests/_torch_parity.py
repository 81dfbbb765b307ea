"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
seeded JAX ENet and ICNet variables with noised BatchNorm statistics,
their port counterparts through train/bridge.py, and the decided-pixel
label rule."""

import numpy as np

import jax
import jax.numpy as jnp

from semanticsegmentationactivelearning_tpu.models import ICNet as JaxICNet
from semanticsegmentationactivelearning_tpu_torch.models import ENet, ICNet
from semanticsegmentationactivelearning_tpu_torch.train import bridge


def noised_variables(model, x, seed):
    """flax init plus |N(0, 0.3)| on every BatchNorm statistic (the
    recipe of tests/test_pallas_kernels.py)."""
    # jitted: eager flax init of the whole ENet takes tens of seconds
    v = jax.jit(lambda x: model.init(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed + 1)}, x, training=False))(
            jnp.asarray(x))
    return {"params": v["params"],
            "batch_stats": noised_stats(v["batch_stats"], seed)}


def noised_stats(batch_stats, seed):
    """|N(0, 0.3)| added to every BatchNorm statistic."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + np.abs(rng.normal(size=a.shape, scale=0.3))
        .astype(np.float32), batch_stats)


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_model(variables, num_classes):
    """The port's ENet holding the same (converted) weights."""
    model = ENet(num_classes)
    model.load_state_dict(
        bridge.state_dict_from_flax(to_numpy_tree(variables)))
    return model


def icnet_variables(num_classes, hw, seed):
    """A JAX ICNet and its variables: flax init (jitted) plus N(0, 0.1) on
    every BatchNorm mean and |N(0, 0.3)| on every variance. ENet's
    recipe (|N| on the means too) leaves ICNet's ReLU outputs all zero
    after a few blocks, which would make every comparison vacuous."""
    model = JaxICNet(num_classes=num_classes)
    v = jax.jit(lambda x: model.init({"params": jax.random.PRNGKey(seed)},
                                     x, training=False))(
        jnp.zeros((1, *hw, 3), jnp.float32))
    rng = np.random.default_rng(seed)

    def noise(path, a):
        if path[-1].key == "mean":
            return a + rng.normal(size=a.shape, scale=0.1).astype(np.float32)
        return a + np.abs(rng.normal(size=a.shape, scale=0.3)) \
            .astype(np.float32)

    return model, {"params": v["params"], "batch_stats":
                   jax.tree_util.tree_map_with_path(noise, v["batch_stats"])}


def port_icnet(variables, num_classes):
    """The port's ICNet holding the same (converted) weights, strictly."""
    model = ICNet(num_classes)
    model.load_state_dict(
        bridge.state_dict_from_flax(to_numpy_tree(variables)))
    return model.eval()


def decided(logits, margin=1e-4):
    """Pixels whose top-2 logit margin exceeds ``margin``: elsewhere two
    implementations may break a near-tie differently."""
    logits = np.asarray(logits, dtype=np.float32)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > margin


def assert_labels_match(got, logits, margin=1e-4):
    """Labels equal the argmax of ``logits`` on decided pixels, which
    are at least 99% of all (the check is not vacuous)."""
    mask = decided(logits, margin)
    assert mask.mean() > 0.99
    want = np.argmax(np.asarray(logits), axis=-1)
    np.testing.assert_array_equal(np.asarray(got)[mask], want[mask])
