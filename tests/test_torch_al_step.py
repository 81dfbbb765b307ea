"""The active-learning slice's training pieces against the JAX package,
on the seeded ENet-19 at TRAIN_HW (32x64) with dropout rates 0:

- the pseudo-labelling train step (``make_train_step(pseudo_cfg=...)``)
  against the JAX ``make_train_step(pseudo_cfg=...)``, in float64 with
  SGD (why float64: ``tests/_torch_parity.py``), on a batch with a
  labelled row, an unlabelled row and a row with ``valid`` 0, at the
  entropy measure and the unlabelled row's median confidence: the
  mixed labels and masks equal, then the loss and cost to 1e-5
  relative, the parameters after the step and the BN statistics to
  1e-6 absolute and the confusion exactly (the tolerances of
  ``tests/test_torch_train_step_al.py``);
- an empty mask's loss: 0 in the port, NaN in the JAX package;
- ``checkpoint.reinitialize_final_layer``: only the Final's kernel
  changes, drawn by flax's glorot-uniform law;
- ``fused_score`` ranks with the current weights after ``-r``, after an
  optimizer step and after a restore: its score equals a freshly built
  model's on the same weights.

One JAX train-step compile (with the eval forward of the targets).
Measured: about 25 s on one process, 20 s of it the JAX compile.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semanticsegmentationactivelearning_tpu.ops import losses as jax_losses
from semanticsegmentationactivelearning_tpu_torch.models import ENet
from semanticsegmentationactivelearning_tpu_torch.ops import losses
from semanticsegmentationactivelearning_tpu_torch.train import (
    checkpoint as ckpt, optim, steps)

from _torch_parity import (TRAIN_C, check_sgd_step, jax_train_step,
                           port_train_batch, pseudo_batch, pseudo_cfg,
                           seeded_port_enet, train_batch, train_hyperparams)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_pseudo_targets_match_jax():
    (want, _, _), _ = jax_train_step(False, pseudo=True)
    model = seeded_port_enet(TRAIN_C, 0, multiscale_heads=False).double()
    batch = port_train_batch(pseudo_batch())
    label, mask = steps.pseudo_targets(model, batch, pseudo_cfg(), TRAIN_C)
    np.testing.assert_array_equal(label.numpy(), want["mixed_label"])
    np.testing.assert_array_equal(mask.numpy(), want["mixed_mask"])
    # the labelled row keeps its targets, the unlabelled one is half
    # pseudo-labelled, the invalid one is masked out
    assert torch.equal(label[0], batch["label"][0])
    assert 0.45 < mask[1].mean().item() < 0.55
    assert mask[2].sum().item() == 0


def test_pseudo_sgd_step_matches_jax():
    check_sgd_step(False, pseudo=True)


def test_empty_mask_has_zero_loss():
    """A batch with no pixel in the mask (a tail batch of pseudo rows
    none of whose pixels clears the threshold): the port's loss is 0 and
    its gradient finite; the JAX package's is NaN (0 / 0)."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 4, 6, TRAIN_C)).astype(np.float32)
    labels = rng.integers(0, TRAIN_C, (2, 4, 6))
    mask = np.zeros((2, 4, 6), np.float32)
    x = torch.from_numpy(logits).requires_grad_()
    loss = losses.masked_softmax_cross_entropy(
        torch.from_numpy(labels), x, torch.from_numpy(mask), TRAIN_C, 1.02)
    loss.backward()
    assert loss.item() == 0.0 and torch.isfinite(x.grad).all()
    assert np.isnan(float(jax_losses.masked_softmax_cross_entropy(
        jnp.asarray(labels), jnp.asarray(logits), jnp.asarray(mask),
        TRAIN_C, 1.02)))


def _state(model, lr=0.5):
    hp = train_hyperparams(False, "Adam", lr)
    optimizer, scheduler = optim.make_optimizer(model.parameters(), hp)
    return steps.create_train_state(model, optimizer, scheduler), hp


def test_reinitialize_final_layer_draws_the_final_alone():
    model = seeded_port_enet(TRAIN_C, 2, multiscale_heads=False)
    state, hp = _state(model)
    steps.make_train_step(model, TRAIN_C, hp)(
        state, port_train_batch(train_batch(), torch.float32))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt_before = state.optimizer.state_dict()
    assert ckpt.reinitialize_final_layer(
        state, model, torch.Generator().manual_seed(7)) is state
    after = model.state_dict()
    changed = [k for k in before if not torch.equal(before[k], after[k])]
    assert changed == ["Final.deconv.weight"]
    assert (state.step, state.epoch) == (1, 0)
    opt_after = state.optimizer.state_dict()
    for i, s in opt_before["state"].items():
        for k, v in s.items():
            assert torch.equal(v, opt_after["state"][i][k])
    # flax's glorot uniform on the [3, 3, 16, C] kernel
    fresh = np.asarray(jax.nn.initializers.glorot_uniform()(
        jax.random.PRNGKey(0), (3, 3, 16, TRAIN_C)))
    bound = np.sqrt(6.0 / (9 * 16 + 9 * TRAIN_C))
    w = after["Final.deconv.weight"].numpy()
    assert np.abs(w).max() <= bound and np.abs(fresh).max() <= bound
    assert abs(w.std() / fresh.std() - 1.0) < 0.1
    assert abs(w.mean()) < 0.1 * w.std()
    with pytest.raises(KeyError, match="output_module"):
        ckpt.reinitialize_final_layer(state, torch.nn.Linear(2, 2),
                                      torch.Generator())


def _fresh_scores(model, image):
    fresh = ENet(TRAIN_C, drop_rates=model.drop_rates,
                 multiscale_heads=model.multiscale_heads)
    fresh.load_state_dict(model.state_dict())
    return _scores(fresh, image)


def _scores(model, image):
    """The routes that read the model's weight packs on the CPU: the
    default entropy route, the deconv route and margin."""
    return [model.fused_score(image, measure, **kw).numpy()
            for measure, kw in (("entropy", {}),
                                ("entropy", {"fuse_decoder": False}),
                                ("margin", {}))]


@pytest.mark.parametrize("change", ["reinitialize", "train_step",
                                    "restore"])
def test_score_uses_the_current_weights(change, tmp_path):
    """After ``-r``, an optimizer step or a restore, the pool scores are
    those of a fresh model holding the same weights: the packs built
    before the change are gone."""
    model = seeded_port_enet(TRAIN_C, 3, multiscale_heads=False)
    image = torch.from_numpy(train_batch(4)["image"]).float()
    state, hp = _state(model)
    saved = ckpt.save_training_state(str(tmp_path / "a.ckpt"), state)
    stale = _scores(model, image)          # builds the packs
    if change == "reinitialize":
        ckpt.reinitialize_final_layer(state, model,
                                      torch.Generator().manual_seed(1))
    elif change == "train_step":
        steps.make_train_step(model, TRAIN_C, hp, pseudo_cfg={
            "measure": "entropy", "threshold": 0.0})(
            state, port_train_batch(pseudo_batch(), torch.float32))
    else:
        steps.make_train_step(model, TRAIN_C, hp)(
            state, port_train_batch(train_batch(), torch.float32))
        stale = _scores(model, image)      # the trained weights' packs
        ckpt.restore_training_state(saved, state)
    got, want = _scores(model, image), _fresh_scores(model, image)
    for g, w, s in zip(got, want, stale):
        np.testing.assert_array_equal(g, w)
        assert not np.array_equal(g, s)
