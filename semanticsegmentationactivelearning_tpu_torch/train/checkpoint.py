"""Checkpoints of the PyTorch port: the save/restore half of
``semanticsegmentationactivelearning_tpu/train/checkpoint.py``.

A port checkpoint is one file holding a model ``state_dict`` written by
``torch.save``; it is read back with ``torch.load(weights_only=True)``,
which unpickles tensors and containers only. Writes are atomic
(``.part`` then ``os.replace``). :func:`restore_checkpoint` also takes
a checkpoint written by the JAX package and converts it through
``train/bridge.py``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch
from torch import nn

from . import bridge

CKPT_EXT = ".ckpt"
STATE_FILE = "checkpoint.json"


def save_checkpoint(path: str, model: nn.Module) -> str:
    """Write ``model.state_dict()`` to ``path`` atomically."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    tmp = path + ".part"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    """Newest committed checkpoint in ``directory``: the ``latest``
    entry of ``checkpoint.json``, else the highest-numbered
    ``*.ckpt`` (the JAX package's directory layout)."""
    state_path = os.path.join(directory, STATE_FILE)
    if os.path.exists(state_path):
        with open(state_path) as fp:
            latest = json.load(fp).get("latest")
        if latest and os.path.exists(os.path.join(directory, latest)):
            return os.path.join(directory, latest)
    candidates = [f for f in os.listdir(directory)
                  if f.endswith(CKPT_EXT) and not f.startswith("tmp")]

    def _num(name):
        try:
            return int(name[:-len(CKPT_EXT)].rsplit("-", 1)[1])
        except (IndexError, ValueError):
            return -1

    return os.path.join(directory, max(candidates, key=_num)) \
        if candidates else None


def _resolve(path: str) -> str:
    if os.path.isdir(path):
        latest = latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"No checkpoint found in {path}")
        return latest
    if not os.path.exists(path) and os.path.exists(path + CKPT_EXT):
        return path + CKPT_EXT
    return path


def restore_checkpoint(path: str, model: Optional[nn.Module] = None
                       ) -> Dict[str, torch.Tensor]:
    """Read a checkpoint file (or the latest one in a directory) as a
    port ``state_dict``, converting a JAX-package checkpoint on the
    way, and load it into ``model`` (strictly) when one is given."""
    path = _resolve(path)
    if bridge.is_jax_checkpoint(path):
        state = bridge.state_dict_from_jax_checkpoint(path)
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
    if model is not None:
        model.load_state_dict(state)
    return state
