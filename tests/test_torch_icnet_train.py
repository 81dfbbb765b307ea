"""ICNet's training in the port against the JAX package's on the CPU:
ICNet-19 at 2x64x64 with ``_torch_parity.icnet_variables``' weights
(glorot kernels, BN means N(0, 0.1)), in float64 on both sides (why:
``tests/_torch_parity.py``), with ``conf/icnet_cityscapes.json``'s loss
(the cascade CE over ``(cls4, aux8, aux16)`` weighted 1.0/0.4/0.4, L2
1e-4) and optimizer (Momentum 0.9, lr 1e-3).

- The train-mode forward (batch statistics) against
  ``JaxICNet.apply(training=True, multiscale=True,
  mutable=["batch_stats"])``: the full-res logits and the three heads to
  1e-6 of their largest magnitude (measured 2.3e-8 to 3.7e-8), the new
  running statistics to 1e-8 (1.7e-10).
- One step of ``train.steps.make_train_step`` against the JAX package's
  ``make_train_step`` (its body with an optimizer that keeps the
  gradients, as ``_torch_parity.jax_train_step`` holds ENet's): loss and
  cost to 1e-6 relative (7.7e-8), the learning rate, the confusion
  exactly, every gradient to 1e-6 relative L2 a tensor (1.0e-7 at
  worst), the BN statistics to 1e-8 (1.7e-10), and the weights after
  the Momentum update to 1e-6 of the tensor's largest update (6e-8).
- The regularizer: the L1/L2 cost of ICNet's kernels, the three 1x1
  classifiers with bias (``Classifier``, ``CFF1.aux_cls``,
  ``CFF2.aux_cls``) among them, against the JAX function, to 1e-6
  relative (2.3e-7); each classifier's share is over ten times that.
- The packs: a step and ``reinitialize_final_layer`` each leave
  ICNet's kernel packs (the BN-folded front + stem, the CFF2 + head
  record, the classifier) rebuilt from the new weights.

The floats differ only in where the JAX model rounds to float32 (the
classifiers' inputs, the CE in both) and in the order of sums. One JAX
compile (``fast_jit``) serves every case. Measured: about 35 s on one
process, 13 s of it that compile.

Four tests, one for each bullet above: the tier-1 command's ``--dist
loadfile`` queues the files with the most tests first, and
``test_multihost.py`` (4 tests, ~510 s) starts late enough to set the
run's wall time; a file with more tests than it is queued ahead of it
and pushes it later (replaying the queue with the suite's measured test
times put 13 tests here at +90 s of wall, 4 at -30 s).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from semanticsegmentationactivelearning_tpu.models import ICNet as JaxICNet
from semanticsegmentationactivelearning_tpu.ops import losses as jlosses
from semanticsegmentationactivelearning_tpu.train import (
    make_train_step as jax_make_train_step)
from semanticsegmentationactivelearning_tpu.train.steps import (
    TrainState as JaxTrainState)
from semanticsegmentationactivelearning_tpu_torch.models.icnet import (
    Conv1x1Bias)
from semanticsegmentationactivelearning_tpu_torch.ops import (acquisition,
                                                              losses)
from semanticsegmentationactivelearning_tpu_torch.ops.kernels import (
    icnet_front, icnet_head)
from semanticsegmentationactivelearning_tpu_torch.train import (
    checkpoint, optim, steps)

from _torch_parity import fast_jit, icnet_variables, port_icnet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, HW, SEED = 19, (64, 64), 4
CLASSIFIERS = ("Classifier", "CFF1.aux_cls", "CFF2.aux_cls")
REG_CASES = [(0.0, 1e-4, False), (1e-5, 2e-4, True)]
PACKS = {"icnet_front": icnet_front.pack_icnet_front,
         "cff2_head": icnet_head.pack_cff2_head,
         "classifier": icnet_head.pack_classifier}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def hyperparams():
    with open(os.path.join(REPO, "conf", "icnet_cityscapes.json")) as fp:
        return json.load(fp)["hyperparams"]


def batch_np(seed=3):
    """A seeded float64 batch of 2 at HW, 10% of it masked."""
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(size=(2, *HW, 3)),
            "label": rng.integers(0, C, (2, *HW)).astype(np.int32),
            "mask": (rng.uniform(size=(2, *HW)) > 0.1).astype(np.float64),
            "valid": np.ones(2)}


def port_batch(b, dtype=torch.float64):
    return {"image": torch.from_numpy(b["image"]).to(dtype),
            "label": torch.from_numpy(b["label"]).long(),
            "mask": torch.from_numpy(b["mask"]).to(dtype),
            "valid": torch.from_numpy(b["valid"]).to(dtype)}


def port_tree(tree):
    """A flax tree (params or batch_stats, numpy float64) as the port's
    state_dict keys, in float64 (``train/bridge.py``'s names and
    layouts; ICNet has no transposed conv)."""
    names = {"scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var", "kernel": "weight"}
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                a = np.asarray(v, np.float64)
                if k == "kernel":
                    a = np.transpose(a, (3, 2, 0, 1))
                out[".".join(prefix + (names[k],))] = a

    walk(tree, ())
    return out


@pytest.fixture(scope="module")
def ref():
    """The JAX step, train-mode forward and regularizer in float64, one
    compile: (the flax variables, a dict of numpy outputs)."""
    _, variables = icnet_variables(C, HW, SEED)
    keep_grads = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    batch = batch_np()
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     variables)
        jm = JaxICNet(num_classes=C, dtype=jnp.float64)
        body = jax_make_train_step(jm, keep_grads, C, hyperparams(),
                                   _body_only=True)

        def fn(state, batch, key):
            new, metrics = body(state, batch, key)
            (logits, heads), mutated = jm.apply(
                {"params": state.params, "batch_stats": state.batch_stats},
                batch["image"], training=True, multiscale=True,
                mutable=["batch_stats"])
            regs = [jlosses.regularization_loss(state.params, *case)
                    for case in REG_CASES]
            return dict(metrics=metrics, grads=new.opt_state,
                        stats=new.batch_stats, logits=logits, heads=heads,
                        forward_stats=mutated["batch_stats"], regs=regs)

        state = JaxTrainState(
            params=v64["params"], batch_stats=v64["batch_stats"],
            opt_state=keep_grads.init(v64["params"]),
            step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32))
        key = jax.random.PRNGKey(0)
        out = fast_jit(fn, state, batch, key)(state, batch, key)
        out = jax.tree_util.tree_map(np.asarray, out)
    return variables, out


@pytest.fixture(scope="module")
def port(ref):
    """The port's train-mode forward on one copy of the weights and one
    step of make_train_step on another, in float64."""
    variables, _ = ref
    b = port_batch(batch_np())
    fwd_model = port_icnet(variables, C).double()
    with torch.no_grad():
        logits, heads = fwd_model(b["image"], training=True, multiscale=True)
    model = port_icnet(variables, C).double()
    hp = hyperparams()
    optimizer, scheduler = optim.make_optimizer(model.parameters(), hp)
    state = steps.create_train_state(model, optimizer, scheduler)
    metrics = steps.make_train_step(model, C, hp)(state, b)
    return dict(logits=logits, heads=heads, forward_model=fwd_model,
                state=state, metrics=metrics)


def rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_train_forward_matches_jax(ref, port):
    """The full-res logits, the three heads and the new running
    statistics of the train-mode forward."""
    _, want = ref
    got = [port["logits"], *port["heads"]]
    exp = [want["logits"], *want["heads"]]
    for name, g, e in zip(("logits", "cls4", "aux8", "aux16"), got, exp):
        assert tuple(g.shape) == e.shape, name
        assert rel_max(g.numpy(), e) < 1e-6, name
    sd = port["forward_model"].state_dict()
    stats = port_tree(want["forward_stats"])
    assert len(stats) == 2 * sum(1 for k in sd if k.endswith("running_mean"))
    for k, v in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), v, rtol=0, atol=1e-8,
                                   err_msg=k)


def test_sgd_step_matches_jax(ref, port):
    """Loss, cost, learning rate and confusion; every gradient; the
    running statistics; the weights after the first Momentum update
    (optax's trace and torch's buffer both start at the gradient):
    w - lr * g."""
    variables, want = ref
    got, state = port["metrics"], port["state"]
    assert state.step == 1
    for k in ("loss", "cost"):
        np.testing.assert_allclose(got[k].item(), float(want["metrics"][k]),
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["learning_rate"],
                               float(want["metrics"]["learning_rate"]),
                               rtol=1e-7)
    np.testing.assert_array_equal(got["confusion"].numpy(),
                                  want["metrics"]["confusion"])
    grads = port_tree(want["grads"])
    params = dict(state.model.named_parameters())
    assert grads.keys() == params.keys()
    worst = {k: np.linalg.norm(params[k].grad.numpy() - g) / np.linalg.norm(g)
             for k, g in grads.items()}
    name = max(worst, key=worst.get)
    assert worst[name] < 1e-6, (name, worst[name])
    sd = state.model.state_dict()
    for k, v in port_tree(want["stats"]).items():
        np.testing.assert_allclose(sd[k].numpy(), v, rtol=0, atol=1e-8,
                                   err_msg=k)
    lr = hyperparams()["learning_rate"]
    start = port_tree(variables["params"])
    for k, g in grads.items():
        step = lr * g
        np.testing.assert_allclose(sd[k].numpy(), start[k] - step, rtol=0,
                                   atol=1e-6 * np.abs(step).max(), err_msg=k)


def test_regularizer_covers_the_classifiers(ref, port):
    """The port's regularizer on the step's starting weights against the
    JAX function over the same tree, at each of REG_CASES; each 1x1
    classifier's share is larger than the tolerance, so a classifier
    left out fails."""
    _, want = ref
    model = port["forward_model"]
    covered = {id(p) for p, _ in losses._regularized(model)}
    mods = dict(model.named_modules())
    for case, exp in zip(REG_CASES, want["regs"]):
        got = losses.regularization_loss(model, *case).item()
        np.testing.assert_allclose(got, float(exp), rtol=1e-6,
                                   err_msg=str(case))
        for name in CLASSIFIERS:
            assert isinstance(mods[name], Conv1x1Bias)
            assert id(mods[name].weight) in covered
            assert id(mods[name].bias) not in covered
            l1, l2, glorot = case
            var = 2.0 / sum(mods[name].weight.shape[:2]) if glorot else 1.0
            w = mods[name].weight.detach()
            share = (l1 / np.sqrt(var / 2) * w.abs().sum()
                     + l2 / var * w.square().sum()).item()
            assert share > 1e-5 * float(exp), (case, name)


def _packs(model):
    return {k: model.packed(k, torch.device("cpu"), fn)
            for k, fn in PACKS.items()}


def _snapshot(model, names):
    return {k: [t.clone() for t in v] if isinstance(v, list) else v.clone()
            for k, v in _packs(model).items() if k in names}


def _assert_scores_follow_the_weights(model, image):
    """Every CPU route of fused_score (the classifier's pack on the
    head routes) equals the plain forward's scores on the model's
    current weights."""
    with torch.no_grad():
        logits = model(image)
    for measure, kw in (("entropy", {}), ("entropy", {"fuse_cff2": False}),
                        ("entropy", {"fuse_stem": False}), ("margin", {})):
        want = acquisition.mean_confidence(logits, measure, C)
        got = model.fused_score(image, measure, **kw)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5, err_msg=f"{measure} {kw}")


def _assert_rebuilt(model, old):
    new = _packs(model)
    for k, v in old.items():
        a = v if isinstance(v, list) else [v]
        b = new[k] if isinstance(new[k], list) else [new[k]]
        assert not all(torch.equal(x, y) for x, y in zip(a, b)), k


def test_packs_follow_the_weights(ref):
    """A train step moves the weights and BN statistics in place, and
    ``-r`` (``reinitialize_final_layer``) draws the Classifier anew: the
    kernel packs built before either must not survive it (after ``-r``
    the classifier's and the CFF2 + head record, which hold it)."""
    model = port_icnet(ref[0], C)
    image = torch.from_numpy(batch_np(4)["image"]).float()
    old = _snapshot(model, PACKS)
    _assert_scores_follow_the_weights(model, image)
    hp = dict(hyperparams(), learning_rate=0.5)
    optimizer, scheduler = optim.make_optimizer(model.parameters(), hp)
    state = steps.create_train_state(model, optimizer, scheduler)
    steps.make_train_step(model, C, hp)(state, port_batch(batch_np(),
                                                          torch.float32))
    _assert_rebuilt(model, old)
    _assert_scores_follow_the_weights(model, image)

    old = _snapshot(model, ("cff2_head", "classifier"))
    checkpoint.reinitialize_final_layer(state, model,
                                        torch.Generator().manual_seed(2))
    _assert_rebuilt(model, old)
    _assert_scores_follow_the_weights(model, image)
