"""Host utilities of the PyTorch port: the CLI plumbing (``cli``), the
image summaries (``images``) and the TensorBoard event files
(``tb_events``)."""
