"""The PyTorch port stands alone: no module of
``semanticsegmentationactivelearning_tpu_torch``, no part of
``chip_smoke.py`` (the scripts it runs in child processes included)
imports JAX, flax, optax or the JAX package, and the port's own copies
of the record modules read what the JAX package's writer wrote, and the
reverse."""

import ast
import io
import os
import re

import numpy as np
import pytest
from PIL import Image

from semanticsegmentationactivelearning_tpu.data import (
    example as jax_example)
from semanticsegmentationactivelearning_tpu.data import (
    tfrecord as jax_tfrecord)
from semanticsegmentationactivelearning_tpu_torch.data import (example,
                                                               tfrecord)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "semanticsegmentationactivelearning_tpu_torch")
# an import statement of a JAX-side module, at the start of a line or of
# a string (a child script), in either form; the port's own name, which
# extends the JAX package's, does not match
JAX_IMPORT = re.compile(
    r"""(?:^|["';])\s*(?:from|import)\s+"""
    r"""(?:jax|flax|optax|semanticsegmentationactivelearning_tpu)"""
    r"""(?![\w])""", re.M)


def _sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_the_scan_sees_every_form_of_import():
    """The pattern catches imports in code and in child-script strings,
    and passes the port's own imports and bare module names."""
    caught = ["import jax", "from jax import numpy",
              "  import flax.linen as nn", "from optax import adam",
              "from semanticsegmentationactivelearning_tpu.data import x",
              '"from semanticsegmentationactivelearning_tpu.data import "',
              "'import jax\\n'", "x = 1; import jax"]
    passed = ["from semanticsegmentationactivelearning_tpu_torch import x",
              "import semanticsegmentationactivelearning_tpu_torch",
              'JAX_SIDE = ("jax", "flax", "semanticsegmentationactivelearning'
              '_tpu")', "imports neither JAX nor the JAX package",
              "import jaxlike", "from .data import example"]
    assert all(JAX_IMPORT.search(s) for s in caught)
    assert not any(JAX_IMPORT.search(s) for s in passed)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import(path):
    with open(path) as fp:
        text = fp.read()
    bad = [m.group(0).strip() for m in JAX_IMPORT.finditer(text)]
    assert not bad, f"{path} imports the JAX side: {bad}"


def test_tensorflow_only_in_the_importer():
    """TensorFlow is imported in one place, inside
    ``train/tf_import.convert_reference_checkpoint`` (the offline
    migration path), so neither the package nor ``chip_smoke.py`` needs
    it on a card's machine."""
    found = []
    for path in _sources():
        with open(path) as fp:
            tree = ast.parse(fp.read())
        parents = {c: p for p in ast.walk(tree)
                   for c in ast.iter_child_nodes(p)}
        for node in ast.walk(tree):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else [node.module or ""] \
                if isinstance(node, ast.ImportFrom) else []
            if any(n.split(".")[0] == "tensorflow" for n in names):
                scope = node
                while scope in parents \
                        and not isinstance(scope, ast.FunctionDef):
                    scope = parents[scope]
                found.append((os.path.relpath(path, PORT),
                              getattr(scope, "name", None)))
    assert found == [(os.path.join("train", "tf_import.py"),
                      "convert_reference_checkpoint")]


def test_the_scan_covers_the_rig_scripts():
    """The port's tools/ subpackage (the rigs and their scripts) is in
    the scan, so the rigs stand alone as the package does."""
    tools = os.path.join(PORT, "tools")
    scanned = {os.path.relpath(p, tools) for p in _sources()
               if p.startswith(tools + os.sep)}
    assert {"rigs.py", "probe_launch_overhead.py", "probe_matmul_floor.py",
            "probe_front_packing.py"} <= scanned


def test_the_port_has_its_own_host_modules():
    for name in ("data/proto.py", "data/tfrecord.py", "data/example.py",
                 "data/etl.py", "data/loader.py", "data/native.py",
                 "data/png_writer.py", "datasets/__init__.py",
                 "datasets/base.py", "datasets/cityscapes.py",
                 "datasets/freiburg.py", "datasets/vistas.py",
                 "datasets/generic.py"):
        assert os.path.isfile(os.path.join(PORT, name)), name


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_records_round_trip_between_the_packages(tmp_path, direction):
    writer_ex, writer_rec, reader_ex = (
        (jax_example, jax_tfrecord, example) if direction == "jax_to_port"
        else (example, tfrecord, jax_example))
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (12, 20, 3), dtype=np.uint8)
    lbl = rng.integers(0, 19, (12, 20)).astype(np.uint8)
    ex = writer_ex.SegExample(
        file_id="r0", height=12, width=20, label=_png(lbl),
        modalities={"image": (_png(img), "png", 3)})
    path = str(tmp_path / "r0.tfrecord")
    writer_rec.write_record_file(path, writer_ex.make_example(ex))
    got = reader_ex.read_example(path)
    assert (got.file_id, got.height, got.width) == ("r0", 12, 20)
    assert got.label == ex.label
    assert got.modalities == ex.modalities
    assert reader_ex.peek_dims(path) == (12, 20, 3)
