"""The port's train step (``train/steps.make_train_step``) against the
JAX package's ``make_train_step`` on the same seeded weights and batch
(ENet-19 at 2x32x64, dropout rates 0), with multiscale on (the pretrain
conf's loss: label smoothing, the multiscale heads), the training
precision, and the repair of the stale weight packs. The single-scale
case (the AL conf's loss) and the Adam step are in
``tests/test_torch_train_step_al.py``; the JAX reference (float64 on
both sides, why: ``tests/_torch_parity.py``) is computed once a case.
Tolerances: loss and cost to 1e-5 relative, SGD parameters after the
step to 1e-6 absolute, BN statistics to 1e-6 absolute, the confusion
exactly. Measured: about 26 s on one process, 20 s of it the JAX
compile.
"""

import numpy as np
import pytest
import torch

from semanticsegmentationactivelearning_tpu_torch.ops import acquisition
from semanticsegmentationactivelearning_tpu_torch.ops.kernels import packing
from semanticsegmentationactivelearning_tpu_torch.train import optim, steps

from _torch_parity import (TRAIN_C, check_sgd_step, port_train_batch,
                           port_train_step, seeded_port_enet, train_batch,
                           train_hyperparams)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_sgd_step_matches_jax():
    check_sgd_step(True)


def test_float32_step_holds_to_float64():
    """The training precision: the port's float32 step against its
    float64 step, loss to 1e-5 relative (measured 1.5e-7)."""
    _, got32 = port_train_step(True, dtype=torch.float32)
    _, got64 = port_train_step(True, dtype=torch.float64)
    np.testing.assert_allclose(got32["loss"].item(), got64["loss"].item(),
                               rtol=1e-5)


def test_step_refreshes_the_weight_packs():
    """A train step moves the weights and BN statistics in place; the
    kernels' packs built before it must not survive it. After the step
    the CPU routes that read the Final's pack (margin, and entropy
    without the decoder kernel) equal the plain forward's scores on the
    trained weights."""
    model = seeded_port_enet(TRAIN_C, 1, multiscale_heads=False)
    image = torch.from_numpy(train_batch(4)["image"]).float()
    pack = lambda: model.packed("final", image.device, lambda m:  # noqa
                                packing.deconv_hwio(m.Final.deconv)).clone()
    before = pack()
    model.fused_score(image, "margin")
    model.fused_score(image, "entropy", fuse_decoder=False)
    hp = train_hyperparams(False, lr=0.5)
    optimizer, scheduler = optim.make_optimizer(model.parameters(), hp)
    state = steps.create_train_state(model, optimizer, scheduler)
    steps.make_train_step(model, TRAIN_C, hp)(
        state, port_train_batch(train_batch(), torch.float32))
    assert not torch.equal(pack(), before)
    with torch.no_grad():
        logits = model(image)
    for measure, kw in (("margin", {}),
                        ("entropy", {"fuse_decoder": False})):
        want = acquisition.mean_confidence(logits, measure, TRAIN_C)
        got = model.fused_score(image, measure, **kw)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5, err_msg=measure)


def test_pseudo_label_step_names_its_slice():
    """The pseudo-labelling step is ported (``tests/test_torch_al_step.py``
    holds it to the JAX step); a measure that is no per-pixel confidence
    (BALD's: the AL CLI pseudo-labels by entropy under it) raises and
    names the measures it takes."""
    model = seeded_port_enet(TRAIN_C, 1, multiscale_heads=False)
    steps.make_train_step(model, TRAIN_C, train_hyperparams(False),
                          pseudo_cfg={"measure": "entropy",
                                      "threshold": 0.9})
    with pytest.raises(ValueError, match="pseudo-labelling needs one of"):
        steps.make_train_step(model, TRAIN_C, train_hyperparams(False),
                              pseudo_cfg={"measure": "bald",
                                          "threshold": 0.9})
