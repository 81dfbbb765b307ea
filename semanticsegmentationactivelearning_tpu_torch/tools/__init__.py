"""Measurement rigs of the port: the hand-written rig kernels of
``csrc/probe_launch.cu`` and ``csrc/probe_matmul.cu`` (``rigs``) and
their scripts, each run as ``python -m
semanticsegmentationactivelearning_tpu_torch.tools.<script>`` on a CUDA
device:

- ``probe_launch_overhead``: the tail kernel's grid and nine tile
  streams with a trivial body (the port of
  ``tools/probe_pallas_overhead.py``);
- ``probe_matmul_floor``: the rate of independent and chained
  ``[R,128]x[128,128]`` products (``tools/probe_mosaic_floor.py``);
- ``probe_front_packing``: wide ``[R,128]x[128,128]`` chains against
  narrow ``[8R,128]x[128,16]`` ones at equal useful work
  (``tools/probe_front_packing.py``).

Beside them: the probes of the redesigned kernels (``probe_front``,
``probe_mid``, ``probe_tail``, ``probe_cff2``, ``probe_icnet_front``,
``probe_head8``; ``tile_builds`` rebuilds a source with another tile for
them), and ``cpu_emu``, which runs ``csrc/`` kernels on the CPU before
their first run on a card.
"""
