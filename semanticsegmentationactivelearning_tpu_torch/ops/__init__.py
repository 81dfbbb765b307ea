"""Ops of the PyTorch port."""
