"""Hand-written Hopper kernels of the ENet serving chain and their plain
PyTorch versions: ``front`` (image -> stage 1), ``mid`` (stages 2-3) and
``tail`` (stages 4-5 + Final + argmax). ``build`` compiles ``csrc/`` with
nvcc and binds it with ctypes; ``packing`` folds BN into the weights.

Each wrapper (``front.fused_front_stage1``, ``mid.fused_mid_stage23``,
``tail.fused_tail_predict``) launches its kernel on CUDA tensors, runs
the plain version on CPU tensors, raises for anything else, and counts
its kernel launches in a ``launches`` attribute.
"""
