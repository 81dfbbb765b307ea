"""PyTorch + CUDA port of the semantic segmentation / active learning
system. ``semanticsegmentationactivelearning_tpu`` (JAX) is the
reference; this package imports ``torch`` and never ``jax``.

Serving and pool scoring run for ENet and ICNet:
``models.{ENet,ICNet}.fused_predict`` and ``fused_score`` run the
hand-written Hopper kernels of ``ops/kernels`` (sources in ``csrc/``)
on CUDA tensors and their plain PyTorch versions on CPU tensors;
``inference`` is the serving CLI, ``train.steps.make_score_step`` the
scoring step, and ``tools`` holds the measurement rigs. ENet trains
through ``train`` (the training CLI, plain PyTorch) and runs the
active-learning loop through ``active_learning`` (the AL CLI).
"""
