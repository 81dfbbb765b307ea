"""Checkpoints and the JAX weight bridge of the PyTorch port."""
