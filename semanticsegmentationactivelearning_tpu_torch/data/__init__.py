"""Host record IO and the device-side data path of the PyTorch port.

``proto``, ``tfrecord``, ``example``, ``etl``, ``loader``, ``native``,
``png_writer`` and ``sampler`` are the port's own copies of the JAX package's
framework-free host modules (same names, same behaviour); ``native``
binds the repo-root ``csrc/ssal_io.cc`` library. ``device_prefetch`` is
the port's host-to-device stage."""
