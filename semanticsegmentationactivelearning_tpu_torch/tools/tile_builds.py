"""Builds of one CUDA source with another tile, for the probes that
compare tiles (``probe_tail.py --deconv-tile``, ``probe_head8.py
--tile``), and ptxas's lines for chosen kernels.

It imports nothing of the port, so that a probe run with ``--root`` of
another checkout loads this file from its own (``runpy.run_path``) and
still passes in that checkout's ``build`` module.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Iterable, Sequence


def ptxas_lines(log: str, keys: Sequence[str]) -> Iterable[str]:
    """ptxas's entry, register and spill lines of the kernels whose
    mangled name holds one of ``keys``."""
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and any(k in ln for k in keys):
            for nxt in lines[i:i + 4]:
                if "registers" in nxt or "spill" in nxt or nxt is ln:
                    yield nxt.strip()


def tile_libraries(build, source: str, line_re: str,
                   line: Callable[[str], str], entries: Sequence[str],
                   tiles: Sequence[str], out: Path) -> dict:
    """tile -> (ctypes library, nvcc log): ``build``'s ``csrc/<source>``
    built once for each tile with its one line that matches ``line_re``
    replaced by ``line(tile)``, into ``out/<tile>/``, one nvcc a tile,
    all started together; ``entries`` get their ``build.SIGNATURES``."""
    procs = {}
    for tile in tiles:
        src = out / tile / "csrc"
        shutil.rmtree(src.parent, ignore_errors=True)
        shutil.copytree(build.CSRC, src)
        cu = src / source
        text, k = re.subn(line_re, line(tile), cu.read_text())
        if k != 1:
            raise RuntimeError(f"{cu}: no tile line to replace")
        cu.write_text(text)
        lib = src.parent / f"{Path(source).stem}.so"
        procs[tile] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for tile, (path, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on tile {tile}:\n{log}")
        lib = ctypes.CDLL(str(path))
        for name in entries:
            args, res = build.SIGNATURES[name]
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = res
        libs[tile] = (lib, log)
    return libs
