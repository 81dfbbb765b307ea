"""Device-side data path of the PyTorch port."""
