"""Parity of the port's losses and metrics (``ops/losses.py``,
``ops/metrics.py``) with the JAX package's on the same seeded numpy
inputs, JAX on the CPU.

Tolerances: every loss to 1e-6 relative (float32 on both sides); the
CE's gradient to 1e-5 relative with 1e-8 absolute against ``jax.grad``;
the confusion matrices, the accumulator and the derived metrics exactly.
Measured: about 12 s on one process.
"""

import numpy as np
import pytest
import torch

import jax

from semanticsegmentationactivelearning_tpu.ops import losses as jlosses
from semanticsegmentationactivelearning_tpu.ops import metrics as jmetrics
from semanticsegmentationactivelearning_tpu_torch.models import ENet
from semanticsegmentationactivelearning_tpu_torch.models.blocks import (
    BatchNorm)
from semanticsegmentationactivelearning_tpu_torch.ops import losses, metrics

from _torch_parity import flax_variables, seeded_port_enet

C = 7
REL = dict(rtol=1e-6, atol=0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread a process, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, shape=(2, 16, 24), scale=3.0):
    rng = np.random.default_rng(seed)
    logits = (scale * rng.normal(size=(*shape, C))).astype(np.float32)
    labels = rng.integers(0, C, shape).astype(np.int32)
    mask = (rng.uniform(size=shape) > 0.2).astype(np.float32)
    return logits, labels, mask


CE_CASES = [(0.0, 0.0), (0.1, 0.0), (0.0, 1.02), (0.05, 1.02)]


@pytest.mark.parametrize("smoothing,weight", CE_CASES)
def test_cross_entropy_and_its_gradient(smoothing, weight):
    logits, labels, mask = _inputs(1)

    def jloss(lo, la, ma):
        return jlosses.masked_softmax_cross_entropy(la, lo, ma, C, weight,
                                                    smoothing)

    want, want_grad = jax.jit(jax.value_and_grad(jloss))(
        logits, labels, mask)
    tl = torch.from_numpy(logits).requires_grad_()
    got = losses.masked_softmax_cross_entropy(
        torch.from_numpy(labels), tl, torch.from_numpy(mask), C, weight,
        smoothing)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **REL)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-8)


def test_label_outside_the_classes_picks_nothing():
    """A label >= C matches no class in the JAX iota compare; the port
    gives the same loss instead of indexing out of range."""
    logits, labels, mask = _inputs(2)
    labels[0, :3, :3] = C + 4
    want = jax.jit(lambda la, lo, ma: jlosses.masked_softmax_cross_entropy(
        la, lo, ma, C))(labels, logits, mask)
    got = losses.masked_softmax_cross_entropy(
        torch.from_numpy(labels), torch.from_numpy(logits),
        torch.from_numpy(mask), C)
    np.testing.assert_allclose(got.item(), float(want), **REL)


@pytest.mark.parametrize("out_hw", [(8, 12), (4, 6), (2, 3), (5, 7)])
def test_nearest_resize(out_hw):
    labels = np.random.default_rng(3).integers(0, 255, (2, 16, 24))
    want = jax.jit(lambda la: jlosses._nearest_resize_2d(la, out_hw))(
        labels.astype(np.int32))
    got = losses._nearest_resize_2d(torch.from_numpy(labels), out_hw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scale_weights,normalize",
                         [(None, False), ((1.0, 0.4, 0.4, 0.4), False),
                          (None, True)])
def test_multiscale_cross_entropy(scale_weights, normalize):
    """Heads at full, 1/2, 1/4 and 1/8 resolution."""
    _, labels, mask = _inputs(4, shape=(2, 32, 48))
    rng = np.random.default_rng(5)
    heads = [(3 * rng.normal(size=(2, 32 // f, 48 // f, C)))
             .astype(np.float32) for f in (1, 2, 4, 8)]
    want = jax.jit(
        lambda la, hs, ma: jlosses.multiscale_masked_softmax_cross_entropy(
            la, hs, ma, C, 1.02, 0.05, normalize=normalize,
            scale_weights=scale_weights))(labels, heads, mask)
    got = losses.multiscale_masked_softmax_cross_entropy(
        torch.from_numpy(labels), [torch.from_numpy(h) for h in heads],
        torch.from_numpy(mask), C, 1.02, 0.05, normalize=normalize,
        scale_weights=scale_weights)
    np.testing.assert_allclose(got.item(), float(want), **REL)


REG_CASES = [(0.0, 2e-4, False), (1e-5, 2e-4, False), (1e-5, 2e-4, True),
             (3e-5, 0.0, True)]


@pytest.fixture(scope="module")
def enet_pair():
    """A seeded port ENet with its heads, and the JAX regularization of
    its flax parameter tree for every case of REG_CASES (one jit)."""
    model = seeded_port_enet(C, 11)
    params = flax_variables(model)["params"]
    want = jax.jit(lambda p: [jlosses.regularization_loss(p, *case)
                              for case in REG_CASES])(params)
    return model, dict(zip(REG_CASES, map(float, want)))


@pytest.mark.parametrize("case", REG_CASES, ids=str)
def test_regularization_matches_jax(enet_pair, case):
    """The port selects conv kernels and PReLU alphas by module type;
    the JAX function by leaf name over the same tree (BN scales and
    biases are in it and ignored)."""
    model, want = enet_pair
    got = losses.regularization_loss(model, *case)
    np.testing.assert_allclose(got.item(), want[case], **REL)


def test_regularization_skips_batch_norm(enet_pair):
    model, _ = enet_pair
    before = losses.regularization_loss(model, 1e-5, 2e-4).item()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.mul_(3.0)
                m.bias.add_(1.0)
    try:
        assert losses.regularization_loss(model, 1e-5, 2e-4).item() \
            == before
    finally:
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.bias.sub_(1.0)
                    m.weight.div_(3.0)
    assert losses.regularization_loss(ENet(C), 0.0, 0.0).item() == 0.0


def _confusion_inputs(seed, n=4000):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, C + 2, n)       # some outside the classes
    preds = rng.integers(0, C, n)
    mask = (rng.uniform(size=n) > 0.3).astype(np.float32)
    return labels, preds, mask


def test_confusion_matrix_is_exact():
    labels, preds, mask = _confusion_inputs(6)
    for m in (mask, None):
        want = jax.jit(lambda la, pr, ma: jmetrics.confusion_matrix(
            la, pr, C, ma, use_matmul=False))(
                labels.astype(np.int32), preds.astype(np.int32), m)
        got = metrics.confusion_matrix(
            torch.from_numpy(labels), torch.from_numpy(preds), C,
            None if m is None else torch.from_numpy(m))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_accumulator_and_derived_metrics_are_exact():
    jacc = jmetrics.ConfusionAccumulator(C)
    acc = metrics.ConfusionAccumulator(C)
    for seed in (7, 8, 9):
        labels, preds, mask = _confusion_inputs(seed)
        labels = np.minimum(labels, C - 1)
        jacc.update(jax.jit(lambda la, pr, ma: jmetrics.confusion_matrix(
            la, pr, C, ma, use_matmul=False))(
                labels.astype(np.int32), preds.astype(np.int32), mask))
        acc.update(metrics.confusion_matrix(
            torch.from_numpy(labels), torch.from_numpy(preds), C,
            torch.from_numpy(mask)))
    np.testing.assert_array_equal(acc.matrix, jacc.matrix)
    want, got = jacc.metrics(), acc.metrics()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert acc.mean_iou == jacc.mean_iou
    acc.reset()
    assert acc.matrix.sum() == 0
