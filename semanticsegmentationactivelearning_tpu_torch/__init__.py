"""PyTorch + CUDA port of the semantic segmentation / active learning
system. ``semanticsegmentationactivelearning_tpu`` (JAX) is the
reference; this package imports ``torch`` and never ``jax``.

The first slice is ENet serving: ``models.ENet.fused_predict`` runs the
hand-written Hopper kernels of ``ops/kernels`` (sources in ``csrc/``)
on CUDA tensors and their plain PyTorch versions on CPU tensors;
``inference`` is the serving CLI.
"""
