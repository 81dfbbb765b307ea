"""Hand-written Hopper kernels of ENet's and ICNet's predict and score
chains and their plain PyTorch versions: ``front`` (image -> stage 1),
``mid`` (stages 2-3), ``tail`` (stages 4-5 + Final + argmax or entropy
mean), ``decoder`` (stage 5 + Final + entropy mean) and
``deconv_score`` (Final + entropy mean; all three on ``csrc/tail.cu``)
for ENet; ``icnet_front``
(Branch1 + the half-res image, or + the stem's front) and
``icnet_head`` (classifier + 8x upsample, optionally after CFF2, ending
in an argmax or an entropy mean) for ICNet. ``build`` compiles ``csrc/``
with nvcc and binds it with ctypes; ``packing`` folds BN into the
weights.

Each wrapper (``front.fused_front_stage1``, ``mid.fused_mid_stage23``,
``tail.fused_tail_predict``, ``tail.fused_tail_entropy_score``,
``decoder.fused_decoder_entropy_score``,
``deconv_score.fused_deconv_entropy_score``,
``icnet_front.fused_icnet_front``, ``icnet_front.fused_icnet_front_stem``,
``icnet_head.fused_head8_predict``, ``icnet_head.fused_head8_entropy_score``,
``icnet_head.fused_cff2_head8_predict``,
``icnet_head.fused_cff2_head8_entropy_score``) launches its kernel on
CUDA tensors, runs the plain version on CPU tensors, raises for anything
else, and counts its kernel launches in a ``launches`` attribute.
"""
