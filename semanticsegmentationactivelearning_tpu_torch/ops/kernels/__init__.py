"""Hand-written Hopper kernels of ENet's predict and score chains and
their plain PyTorch versions: ``front`` (image -> stage 1), ``mid``
(stages 2-3), ``tail`` (stages 4-5 + Final + argmax or entropy mean),
``decoder`` (stage 5 + Final + entropy mean) and ``deconv_score``
(Final + entropy mean). ``build`` compiles ``csrc/`` with nvcc and
binds it with ctypes; ``packing`` folds BN into the weights.

Each wrapper (``front.fused_front_stage1``, ``mid.fused_mid_stage23``,
``tail.fused_tail_predict``, ``tail.fused_tail_entropy_score``,
``decoder.fused_decoder_entropy_score``,
``deconv_score.fused_deconv_entropy_score``) launches its kernel on CUDA
tensors, runs the plain version on CPU tensors, raises for anything
else, and counts its kernel launches in a ``launches`` attribute.
"""
