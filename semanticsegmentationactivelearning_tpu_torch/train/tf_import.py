"""Import the reference's TensorFlow checkpoints into the PyTorch port,
the counterpart of ``semanticsegmentationactivelearning_tpu/train/
tf_import.py``.

A user switching from the reference brings trained TF object-based
checkpoints: ``tf.train.Checkpoint(model=ENet(), epoch, step,
optimizer)`` saved per epoch (reference: train.py:226-229,
active_learning.py:441-444). Checkpoint keys follow TF's object-path
scheme, rooted at the reference ENet's attribute names (reference:
models/enet/enet.py:35-247, models/enet/enet_modules.py:139-188,
366-524, 730-938, 1070-1292, 1294-1381), e.g.::

    model/Bottleneck2_3/conv_kernel/0/.ATTRIBUTES/VARIABLE_VALUE
    model/Initial/variance/.ATTRIBUTES/VARIABLE_VALUE
    epoch/.ATTRIBUTES/VARIABLE_VALUE

The reading and the mapping are apart:
:func:`convert_reference_variables` maps a key -> array dict to the
flax-named tree the JAX package's importer builds, then through
``bridge.state_dict_from_flax`` to the port's ``state_dict``;
:func:`convert_reference_checkpoint` reads a checkpoint through
TensorFlow, imported there and nowhere else in the port, and calls it.

The mapping (the JAX importer's tables):

- conv kernels are HWIO in TF as in flax;
- transpose-conv kernels are ``[H, W, out, in]`` in TF
  (``tf.nn.conv2d_transpose``) and ``[H, W, in, out]`` with flipped
  spatial taps in flax: ``flax = tf.transpose(0, 1, 3, 2)[::-1, ::-1]``;
- BN: gamma -> scale, beta -> bias, mean -> mean, variance -> var;
- asymmetric 5x5 kernels: ``conv_kernel/0`` (5x1, applied first) ->
  ``conv_col``, ``conv_kernel/1`` (1x5) -> ``conv_row``;
- the multiscale heads ``model/loss_scale_weights/{i}`` (over b5_1,
  b4_2, b3_8) -> ``MultiscaleHead_{i}``.

Optimizer slots (``.OPTIMIZER_SLOT``) are not imported: the optimizer
starts fresh. They are counted and logged.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from . import bridge

logger = logging.getLogger(__name__)

_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"

# attribute -> (collection, (module, leaf), transform)
_IDENTITY = lambda a: a  # noqa: E731


def _deconv_to_flax(k: np.ndarray) -> np.ndarray:
    """TF conv2d_transpose filter [H,W,out,in] -> flax ConvTranspose
    kernel [H,W,in,out] (see the module docstring)."""
    return np.ascontiguousarray(
        np.transpose(k, (0, 1, 3, 2))[::-1, ::-1])


def _bn_entries(prefix_ref: str, bn_name: str):
    return {
        f"{prefix_ref}gamma": ("params", (bn_name, "scale"), _IDENTITY),
        f"{prefix_ref}beta": ("params", (bn_name, "bias"), _IDENTITY),
        f"{prefix_ref}mean": ("batch_stats", (bn_name, "mean"),
                              _IDENTITY),
        f"{prefix_ref}variance": ("batch_stats", (bn_name, "var"),
                                  _IDENTITY),
    }


def _block_attr_map(is_upsample: bool) -> Dict[str, Tuple]:
    """Bottleneck-family attribute map (enet_modules.py:366-524 plain,
    730-938 downsample, 1070-1292 upsample)."""
    m = {
        "proj_kernel": ("params", ("proj_conv", "kernel"), _IDENTITY),
        "proj_alpha": ("params", ("proj_prelu", "alpha"), _IDENTITY),
        "conv_alpha": ("params", ("conv_prelu", "alpha"), _IDENTITY),
        "exp_kernel": ("params", ("exp_conv", "kernel"), _IDENTITY),
        "residual_alpha": ("params", ("res_prelu", "alpha"), _IDENTITY),
        # asymmetric pair: column (kx1) first, then row (1xk)
        "conv_kernel/0": ("params", ("conv_col", "kernel"), _IDENTITY),
        "conv_kernel/1": ("params", ("conv_row", "kernel"), _IDENTITY),
    }
    m.update(_bn_entries("proj_", "proj_bn"))
    m.update(_bn_entries("conv_", "conv_bn"))
    m.update(_bn_entries("exp_", "exp_bn"))
    if is_upsample:
        m["conv_kernel"] = ("params", ("deconv", "kernel"), _deconv_to_flax)
        m["res_kernel"] = ("params", ("res_conv", "kernel"), _IDENTITY)
    else:
        m["conv_kernel"] = ("params", ("conv", "kernel"), _IDENTITY)
    return m


_INITIAL_MAP = {
    "kernel": ("params", ("conv", "kernel"), _IDENTITY),
    "alpha": ("params", ("prelu", "alpha"), _IDENTITY),
    **_bn_entries("", "bn"),
}

_FINAL_MAP = {
    "kernel": ("params", ("deconv", "kernel"), _deconv_to_flax),
}


def _set(tree: dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for part in path[:-1]:
        node = node.setdefault(part, {})
    node[path[-1]] = value


def convert_reference_variables(named: Mapping[str, np.ndarray]) -> dict:
    """Map a reference checkpoint's variables (TF object-path key, as
    ``tf.train.load_checkpoint`` names them, -> array) to
    ``{"state_dict", "epoch", "step", "skipped"}`` (and
    ``"save_counter"`` where the checkpoint has one): the port's
    ``state_dict`` of the reference ENet, the bookkeeping scalars, and
    the keys left out (optimizer slots, the object graph, unknown
    attributes)."""
    # upsample blocks are the ones with a residual 1x1 conv
    upsample_blocks = {
        key[len("model/"):].split("/")[0] for key in named
        if key.startswith("model/") and "/res_kernel/" in key}

    tree = {"params": {}, "batch_stats": {}}
    out = {"epoch": 0, "step": 0, "skipped": []}
    for key in sorted(named):
        if not key.endswith(_SUFFIX):
            out["skipped"].append(key)
            continue
        path = key[:-len(_SUFFIX)]
        if ".OPTIMIZER_SLOT" in path or path.startswith("optimizer"):
            out["skipped"].append(key)
            continue
        value = named[key]
        if path in ("epoch", "step", "save_counter"):
            out[path] = int(np.asarray(value))
            continue
        if not path.startswith("model/"):
            out["skipped"].append(key)
            continue
        parts = path[len("model/"):].split("/")
        block, attr = parts[0], "/".join(parts[1:])
        if block == "loss_scale_weights":
            # the heads live at the model's top level
            _set(tree["params"], (f"MultiscaleHead_{attr}", "kernel"),
                 np.asarray(value))
            continue
        if block == "Initial":
            dest = _INITIAL_MAP.get(attr)
        elif block == "Final":
            dest = _FINAL_MAP.get(attr)
        elif block.startswith("Bottleneck"):
            dest = _block_attr_map(block in upsample_blocks).get(attr)
        else:
            dest = None
        if dest is None:
            out["skipped"].append(key)
            continue
        collection, leaf_path, transform = dest
        _set(tree[collection], (block,) + leaf_path,
             transform(np.asarray(value)))
    out["state_dict"] = bridge.state_dict_from_flax(tree)
    return out


def convert_reference_checkpoint(ckpt_path: str) -> dict:
    """Read a reference TF checkpoint (file prefix or directory) and
    map it (:func:`convert_reference_variables`). Needs TensorFlow,
    which only this offline migration path imports."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(
            "Importing reference checkpoints requires TensorFlow "
            "(offline tool dependency only)") from e
    if os.path.isdir(ckpt_path):
        latest = tf.train.latest_checkpoint(ckpt_path)
        if latest is None:
            raise FileNotFoundError(f"No TF checkpoint found in {ckpt_path}")
        ckpt_path = latest
    reader = tf.train.load_checkpoint(ckpt_path)
    named = {key: reader.get_tensor(key)
             for key in reader.get_variable_to_shape_map()}
    out = convert_reference_variables(named)
    n_slots = sum(".OPTIMIZER_SLOT" in k for k in out["skipped"])
    logger.info(
        "Converted %s: %d tensors, epoch=%d step=%d; skipped %d keys (%d "
        "optimizer slots: the optimizer starts fresh)", ckpt_path,
        len(out["state_dict"]), out["epoch"], out["step"],
        len(out["skipped"]), n_slots)
    return out


def merge_report(target: Mapping[str, torch.Tensor], converted: dict
                 ) -> dict:
    """Account for every converted tensor against a port model's
    ``state_dict()`` (``target``): which have no key there (an ENet
    without multiscale heads, an ICNet) or another shape (the class
    count, the input planes). Returns ``{"missing": [key...],
    "mismatched": [(key, src_shape, dst_shape)...], "merged": int}``."""
    report = {"missing": [], "mismatched": [], "merged": 0}
    for key, value in converted["state_dict"].items():
        if key not in target:
            report["missing"].append(key)
        elif tuple(target[key].shape) != tuple(value.shape):
            report["mismatched"].append(
                (key, tuple(value.shape), tuple(target[key].shape)))
        else:
            report["merged"] += 1
    return report


def load_into(model: torch.nn.Module, converted: dict) -> dict:
    """Load the converted tensors that fit into ``model``; every other
    tensor of the model keeps its value (the JAX importer's leaf-wise
    merge). Those that do not fit are logged and dropped. Returns the
    :func:`merge_report`."""
    target = model.state_dict()
    report = merge_report(target, converted)
    for key in report["missing"]:
        logger.warning("converted tensor %s has no destination in the "
                       "model: DROPPED", key)
    for key, src, dst in report["mismatched"]:
        logger.warning("converted tensor %s shape %s does not match the "
                       "model's %s: DROPPED (the model's kept)", key, src,
                       dst)
    bad = set(report["missing"]) | {k for k, _, _ in report["mismatched"]}
    merged = dict(target)
    merged.update({k: v for k, v in converted["state_dict"].items()
                   if k not in bad})
    model.load_state_dict(merged)
    return report
