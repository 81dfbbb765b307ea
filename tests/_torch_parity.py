"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
seeded JAX ENet and ICNet variables with noised BatchNorm statistics,
their port counterparts through train/bridge.py, and the decided-pixel
label rule."""

import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax

from semanticsegmentationactivelearning_tpu.models import ENet as JaxENet
from semanticsegmentationactivelearning_tpu.models import ICNet as JaxICNet
from semanticsegmentationactivelearning_tpu.train import (
    make_train_step as jax_make_train_step)
from semanticsegmentationactivelearning_tpu.train.steps import (
    TrainState as JaxTrainState)
from semanticsegmentationactivelearning_tpu_torch.models import ENet, ICNet
from semanticsegmentationactivelearning_tpu_torch.train import (bridge,
                                                                 optim, steps)


def _drawn_variables(model, x, seed, rngs=("params", "dropout")):
    """A flax ``{"params", "batch_stats"}`` tree of ``model`` at input
    ``x``'s shape, drawn with numpy (``seed``) by flax's initial laws:
    glorot-uniform kernels, zero biases, PReLU alpha 0.25, BN scale 1,
    bias 0, mean 0 and variance 1. The tree's structure comes from
    ``jax.eval_shape`` of ``model.init``, a trace without the compile
    (tens of seconds for ENet or ICNet) that a jitted init takes."""
    shapes = jax.eval_shape(
        lambda x: model.init({r: jax.random.PRNGKey(0) for r in rngs}, x,
                             training=False),
        jax.ShapeDtypeStruct(np.shape(x), jnp.float32))
    # a stream apart from the BN noise the callers draw from ``seed``
    rng = np.random.default_rng([seed, 1])

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            *window, fan_in, fan_out = leaf.shape
            receptive = int(np.prod(window)) if window else 1
            limit = np.sqrt(6.0 / (receptive * (fan_in + fan_out)))
            return rng.uniform(-limit, limit, leaf.shape).astype(np.float32)
        fill = {"alpha": 0.25, "scale": 1.0, "var": 1.0}.get(name, 0.0)
        return np.full(leaf.shape, fill, np.float32)

    return {k: jax.tree_util.tree_map_with_path(draw, shapes[k])
            for k in ("params", "batch_stats")}


def noised_variables(model, x, seed):
    """ENet's variables by flax's initial laws (:func:`_drawn_variables`)
    plus |N(0, 0.3)| on every BatchNorm statistic (the recipe of
    tests/test_pallas_kernels.py)."""
    v = _drawn_variables(model, x, seed)
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


def icnet_variables(num_classes, hw, seed, channels=3):
    """A JAX ICNet and its variables by flax's initial laws
    (:func:`_drawn_variables`) plus N(0, 0.1) on every BatchNorm mean and
    |N(0, 0.3)| on every variance. ENet's recipe (|N| on the means too)
    leaves ICNet's ReLU outputs all zero after a few blocks, which would
    make every comparison vacuous. ``channels``: the input planes."""
    model = JaxICNet(num_classes=num_classes)
    v = _drawn_variables(model, np.zeros((1, *hw, channels), np.float32), seed,
                         rngs=("params",))
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


# XLA options for the JAX references of the training tests: a train step
# of ENet takes ~25 s to compile at the default level on one core and
# under half that here; the results are the same computation.
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def fast_jit(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with ``FAST_COMPILE``."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)


def seeded_port_enet(num_classes, seed, drop_rates=(0.0,) * 5,
                     multiscale_heads=True, in_channels=3):
    """The port's ENet (of ``in_channels`` input planes) with glorot
    weights from a seeded generator and |N(0, 0.3)| added to its BN
    statistics (numpy, ``seed``)."""
    from semanticsegmentationactivelearning_tpu_torch.models.blocks import (
        BatchNorm, reset_parameters)
    model = ENet(num_classes, drop_rates=drop_rates,
                 multiscale_heads=multiscale_heads, in_channels=in_channels)
    reset_parameters(model, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                for buf in (m.running_mean, m.running_var):
                    buf += torch.from_numpy(np.abs(rng.normal(
                        size=buf.shape, scale=0.3)).astype(np.float32))
    return model


def flax_variables(model):
    """The flax ``{"params", "batch_stats"}`` tree (numpy) holding a
    port ENet's weights: the inverse of ``bridge.state_dict_from_flax``."""
    from semanticsegmentationactivelearning_tpu_torch.models.blocks import (
        BatchNorm, Conv, ConvTranspose, PReLU)
    params, stats = {}, {}

    def put(tree, name, leaf, value):
        node = tree
        for part in name.split("."):
            node = node.setdefault(part, {})
        # a copy: JAX may read a numpy buffer in place, asynchronously
        node[leaf] = np.array(value.detach().cpu().numpy(), copy=True)

    for name, m in model.named_modules():
        if isinstance(m, Conv):
            put(params, name, "kernel", m.weight.permute(2, 3, 1, 0))
        elif isinstance(m, ConvTranspose):
            put(params, name, "kernel",
                m.weight.permute(2, 3, 0, 1).flip(0, 1))
        elif isinstance(m, PReLU):
            put(params, name, "alpha", m.alpha)
        elif isinstance(m, BatchNorm):
            put(params, name, "scale", m.weight)
            put(params, name, "bias", m.bias)
            put(stats, name, "mean", m.running_mean)
            put(stats, name, "var", m.running_var)
    return {"params": params, "batch_stats": stats}


# -- the train step's JAX reference (tests/test_torch_train_step*.py) ----
#
# The JAX step runs once per case with an optimizer that applies nothing
# and keeps the gradients it is given, so one compile yields the step's
# loss, cost, learning rate, confusion, new BN statistics and exact
# gradients; optax's optimizers are then applied to those gradients.
# Both sides run in float64 (the JAX model with ``dtype`` float64 under
# ``jax.enable_x64``; each side's CE and regularizer in float32, as in
# training): in float32 the rounding of either implementation moves
# some BN gradients of this shape by up to 6% (relative L2) from the
# float64 step, so a float32 comparison could not hold a step to 1e-6.

TRAIN_C = 19
TRAIN_HW = (32, 64)
# Adam's first update is lr * g / (|g| + eps): at the confs' 1e-8 its
# direction on a gradient element below the gradients' rounding (~1e-7
# here, the CE is float32 on both sides) is noise, and one such element
# read 0.87 of an update apart; at 1e-3 the update is smooth in g
ADAM_EPS = 1e-3


def train_hyperparams(multiscale, opt="SGD", lr=5e-4):
    """The train steps' conf: with ``multiscale`` the pretrain conf's
    loss (label smoothing, the heads), else the AL conf's (log-inverse
    weights 1.02); L1 and L2 regularization."""
    return {"learning_rate": lr, "learning_rate_decay": 0.0,
            "optimizer": {"type": opt,
                          "kwargs": {"beta1": 0.9, "beta2": 0.99,
                                     "epsilon": ADAM_EPS}},
            "weight_reg": {"L2": 2e-4, "L1": 1e-5, "glorot_scaling": False},
            "softmax": {"multiscale": multiscale,
                        "label_smoothing": 0.05 if multiscale else 0.0,
                        "loginverse_scaling": 0.0 if multiscale else 1.02}}


def train_batch(seed=3, channels=3):
    """A seeded float64 batch of 2 at TRAIN_HW (``channels`` planes),
    10% of it masked."""
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(size=(2, *TRAIN_HW, channels)),
            "label": rng.integers(0, TRAIN_C, (2, *TRAIN_HW))
            .astype(np.int32),
            "mask": (rng.uniform(size=(2, *TRAIN_HW)) > 0.1)
            .astype(np.float64),
            "valid": np.ones(2)}


def pseudo_batch(seed=5):
    """The pseudo-labelling step's float64 batch of 3 at TRAIN_HW: the
    undistorted crops ``image_raw`` beside the images, the rows'
    ``labelled`` flags (yes, no, no) and ``valid`` (1, 1, 0)."""
    rng = np.random.default_rng(seed)
    b = {"image": rng.uniform(size=(3, *TRAIN_HW, 3)),
         "image_raw": rng.uniform(size=(3, *TRAIN_HW, 3)),
         "label": rng.integers(0, TRAIN_C, (3, *TRAIN_HW)).astype(np.int32),
         "mask": (rng.uniform(size=(3, *TRAIN_HW)) > 0.1).astype(np.float64),
         "valid": np.array([1.0, 1.0, 0.0]),
         "labelled": np.array([True, False, False])}
    return b


def port_train_batch(b, dtype=torch.float64):
    out = {"image": torch.from_numpy(b["image"]).to(dtype),
           "label": torch.from_numpy(b["label"]).long(),
           "mask": torch.from_numpy(b["mask"]).to(dtype),
           "valid": torch.from_numpy(b["valid"]).to(dtype)}
    if "image_raw" in b:
        out["image_raw"] = torch.from_numpy(b["image_raw"]).to(dtype)
        out["labelled"] = torch.from_numpy(b["labelled"])
    return out


def pseudo_cfg():
    """The entropy measure at the median confidence of the unlabelled
    valid row of ``pseudo_batch()`` under the seeded weights (float64),
    so that half its pixels take a pseudo label: the seeded ENet's
    confidences sit far under the confs' 0.9."""
    from semanticsegmentationactivelearning_tpu_torch.ops import acquisition
    model = seeded_port_enet(TRAIN_C, 0, multiscale_heads=False).double()
    with torch.no_grad():
        logits = model(port_train_batch(pseudo_batch())["image_raw"][1:2])
    conf = acquisition.confidence_map(logits, "entropy", TRAIN_C)
    # an even count of pixels: the mean of the two middle ones, no pixel's
    return {"measure": "entropy",
            "threshold": float(np.quantile(conf.numpy(), 0.5))}


_JAX_TRAIN_STEPS = {}


def jax_train_step(multiscale, pseudo=False, channels=3):
    """The JAX step's outputs in float64, computed once a case:
    ((metrics, gradients, new BN statistics), the initial flax
    variables). With ``pseudo``, the pseudo-labelling step on
    ``pseudo_batch()`` at ``pseudo_cfg()``; its metrics also hold the
    mixed targets (``mixed_label``, ``mixed_mask``), computed as the
    JAX step computes them (train/steps.py:172-186). ``channels``: the
    input planes of the model and of ``train_batch``."""
    key = (multiscale, pseudo, channels)
    if key not in _JAX_TRAIN_STEPS:
        _JAX_TRAIN_STEPS[key] = _run_jax_train_step(*key)
    return _JAX_TRAIN_STEPS[key]


def _run_jax_train_step(multiscale, pseudo, channels=3):
    from semanticsegmentationactivelearning_tpu.ops import (
        acquisition as jax_acquisition)
    model = seeded_port_enet(TRAIN_C, 0, multiscale_heads=multiscale,
                             in_channels=channels).double()
    variables = flax_variables(model)
    batch = pseudo_batch() if pseudo else train_batch(channels=channels)
    cfg = pseudo_cfg() if pseudo else None
    keep_grads = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    with jax.enable_x64(True):
        jm = JaxENet(num_classes=TRAIN_C, drop_rates=(0.0,) * 5,
                     dtype=jnp.float64)
        body = jax_make_train_step(jm, keep_grads, TRAIN_C,
                                   train_hyperparams(multiscale),
                                   pseudo_cfg=cfg, _body_only=True)

        def fn(state, batch, key):
            new, metrics = body(state, batch, key)
            if cfg is None:
                return new, metrics
            logits = jm.apply({"params": state.params,
                               "batch_stats": state.batch_stats},
                              batch["image_raw"], training=False)
            p_label, p_mask, _ = jax_acquisition.pseudo_annotate(
                logits, cfg["measure"], TRAIN_C, cfg["threshold"])
            labelled = batch["labelled"][:, None, None]
            valid = batch["valid"][:, None, None]
            return new, dict(
                metrics,
                mixed_label=jnp.where(labelled, batch["label"], p_label),
                mixed_mask=jnp.where(labelled, batch["mask"] * valid,
                                     p_mask * valid))

        state = JaxTrainState(
            params=variables["params"],
            batch_stats=variables["batch_stats"],
            opt_state=keep_grads.init(variables["params"]),
            step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32))
        key = jax.random.PRNGKey(0)
        new, metrics = fast_jit(fn, state, batch, key)(state, batch, key)
        out = jax.tree_util.tree_map(
            np.asarray, (metrics, new.opt_state, new.batch_stats))
    return out, variables


def port_train_step(multiscale, opt="SGD", lr=5e-4, dtype=torch.float64,
                    pseudo=False, channels=3):
    """One step of the port on the seeded ENet and ``train_batch()``
    (with ``pseudo``: the pseudo-labelling step on ``pseudo_batch()``):
    (the state after it, its metrics)."""
    model = seeded_port_enet(TRAIN_C, 0, multiscale_heads=multiscale,
                             in_channels=channels).to(dtype)
    hp = train_hyperparams(multiscale, opt, lr)
    optimizer, scheduler = optim.make_optimizer(model.parameters(), hp)
    state = steps.create_train_state(model, optimizer, scheduler)
    step = steps.make_train_step(model, TRAIN_C, hp,
                                 pseudo_cfg=pseudo_cfg() if pseudo else None)
    batch = pseudo_batch() if pseudo else train_batch(channels=channels)
    metrics = step(state, port_train_batch(batch, dtype))
    return state, metrics


def optax_updated(variables, grads, tx):
    """optax's first update of ``tx`` on ``grads``, applied."""
    def apply(g, p):
        updates, _ = tx.update(g, tx.init(g), p)
        return optax.apply_updates(p, updates)

    with jax.enable_x64(True):
        return jax.tree_util.tree_map(
            np.asarray, jax.jit(apply)(grads, variables["params"]))


def check_sgd_step(multiscale, pseudo=False, channels=3):
    """One SGD step of the port against the JAX step's."""
    (want, grads, new_stats), variables = jax_train_step(multiscale, pseudo,
                                                         channels)
    state, got = port_train_step(multiscale, pseudo=pseudo,
                                 channels=channels)
    assert state.step == 1
    for k in ("loss", "cost"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5)
    np.testing.assert_allclose(got["learning_rate"],
                               float(want["learning_rate"]), rtol=1e-7)
    np.testing.assert_array_equal(got["confusion"].numpy(),
                                  want["confusion"])
    params = optax_updated(variables, grads, optax.sgd(5e-4))
    expect = bridge.state_dict_from_flax({"params": params,
                                          "batch_stats": new_stats})
    sd = state.model.state_dict()
    assert expect.keys() == sd.keys()
    for k, v in expect.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
