"""Checkpoints of the PyTorch port, the counterpart of
``semanticsegmentationactivelearning_tpu/train/checkpoint.py``
(reference: tensortools/checkpoint_manager.py).

A port checkpoint is one file written by ``torch.save`` and read back
with ``torch.load(weights_only=True)``, which unpickles tensors and
containers only. A model checkpoint (:func:`save_checkpoint`) holds a
model ``state_dict``; a training checkpoint (:func:`save_training_state`,
the :class:`CheckpointManager`) holds ``{"model", "optimizer",
"scheduler", "step", "epoch"}``. Writes are atomic (``.part`` then
``os.replace``). :func:`restore_checkpoint` reads the model of either
kind, or of a checkpoint written by the JAX package (through
``train/bridge.py``); :func:`restore_training_state` resumes a run from
either kind, or from a JAX checkpoint's weights, step and epoch with a
fresh optimizer: optax's moments are one raveled ``optax.flatten``
buffer that maps onto no ``torch.optim`` state. A model restores only
weights of its own number of input planes (:func:`input_planes`): a
multi-modal checkpoint needs a model built with its ``in_channels``,
and any other model raises a ``ValueError`` that names both counts.
:func:`reinitialize_final_layer` draws the output layer anew (the AL
CLI's ``-r``).

The manager keeps the reference's protocol: ``save(prefix, state)``
writes ``{prefix}-{N}.ckpt``; ``cache(state)`` then ``commit(prefix)``
write a ``tmp`` file each epoch and promote it only when the caller saw
an improvement; ``chdir`` moves to an AL round's directory; ``wait``
joins the write in flight; the FIFO
keeps ``max_to_keep`` files; ``checkpoint.json`` holds the list, the
latest and the save counter; ``async_io`` writes on one background
thread that ``close()`` joins.
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import os
from typing import Dict, Optional

import torch
from torch import nn

from . import bridge

logger = logging.getLogger(__name__)

CKPT_EXT = ".ckpt"
STATE_FILE = "checkpoint.json"


# the first conv of each model: its weight is [out, in_channels, kh, kw]
_INPUT_CONVS = ("Initial.conv.weight", "Branch1_1.conv.weight")


def input_planes(state: Dict[str, torch.Tensor]) -> Optional[int]:
    """The input planes a model ``state_dict`` takes (3 for RGB, more
    with stacked modalities), or None where it has no known first
    conv."""
    for key in _INPUT_CONVS:
        if key in state:
            return int(state[key].shape[1])
    return None


def _load_model(model: nn.Module, state, path: str) -> None:
    """``model.load_state_dict(state)`` behind a check of the input
    planes, whose mismatch would otherwise surface as a bare size
    error."""
    planes = input_planes(state)
    want = getattr(model, "in_channels", None)
    if planes is not None and want is not None and planes != want:
        raise ValueError(
            f"checkpoint {path} takes {planes} input planes, the "
            f"{type(model).__name__} it is restored into {want}: build "
            f"the model with in_channels={planes} (or pass the "
            f"modalities it was trained with)")
    model.load_state_dict(state)


def _atomic_save(obj, path: str) -> str:
    tmp = path + ".part"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(path: str, model: nn.Module) -> str:
    """Write ``model.state_dict()`` to ``path`` atomically."""
    return _atomic_save({k: v.detach().cpu()
                         for k, v in model.state_dict().items()}, path)


def _detached(obj, copy):
    """``obj`` with every tensor passed through ``copy``."""
    if isinstance(obj, torch.Tensor):
        return copy(obj.detach())
    if isinstance(obj, dict):
        return {k: _detached(v, copy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_detached(v, copy) for v in obj)
    return obj


def _payload(state, copy) -> dict:
    """A training checkpoint's contents for ``state`` (a
    ``steps.TrainState``), every tensor passed through ``copy``."""
    return _detached({
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "step": int(state.step), "epoch": int(state.epoch)}, copy)


def _write(path: str, payload: dict) -> str:
    return _atomic_save(_detached(payload, lambda t: t.cpu()), path)


def save_training_state(path: str, state) -> str:
    """Write a training checkpoint of ``state`` (a ``steps.TrainState``)
    to ``path`` atomically."""
    return _write(path, _payload(state, lambda t: t))


def _is_training_payload(obj) -> bool:
    return isinstance(obj, dict) and isinstance(obj.get("model"), dict) \
        and "step" in obj


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
    port ``state_dict``: a model checkpoint, the model of a training
    checkpoint, or a JAX-package checkpoint converted on the way. Load
    it into ``model`` (strictly) when one is given."""
    path = _resolve(path)
    if bridge.is_jax_checkpoint(path):
        state = bridge.state_dict_from_jax_checkpoint(path)
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
        if _is_training_payload(state):
            state = state["model"]
    if model is not None:
        _load_model(model, state, path)
    return state


def restore_training_state(path: str, state):
    """Resume ``state`` (a ``steps.TrainState``) from a checkpoint file
    or the latest one in a directory, in place, and return it. A port
    training checkpoint restores the model, optimizer, scheduler, step
    and epoch; a model checkpoint the weights alone. A JAX-package
    checkpoint gives the weights, the step and the epoch; the optimizer
    starts fresh, its schedule at the restored step."""
    from . import optim
    path = _resolve(path)
    if bridge.is_jax_checkpoint(path):
        tree = bridge.read_jax_checkpoint(path)
        _load_model(state.model, bridge.state_dict_from_flax(tree), path)
        state.step = int(tree.get("step", 0))
        state.epoch = int(tree.get("epoch", 0))
        optim.set_schedule_step(state.scheduler, state.step)
        logger.info("JAX checkpoint %s: weights, step %d and epoch %d "
                    "restored; the optimizer starts fresh (optax's state "
                    "does not map onto torch.optim)", path, state.step,
                    state.epoch)
        return state
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not _is_training_payload(payload):
        _load_model(state.model, payload, path)
        logger.info("model checkpoint %s: weights restored, the optimizer "
                    "starts fresh", path)
        return state
    _load_model(state.model, payload["model"], path)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.scheduler.load_state_dict(payload["scheduler"])
    state.step = int(payload["step"])
    state.epoch = int(payload["epoch"])
    return state


class CheckpointManager:
    """Two-phase best-checkpoint manager (see the module docstring).

    With ``async_io`` each ``cache``/``save`` copies the state on its
    device (a copy that later steps do not touch) and a background
    thread moves it to the host and writes it, so the write overlaps the
    next epoch; ``commit``, ``chdir`` and ``close`` wait for the write in
    flight and re-raise its error."""

    def __init__(self, directory: str, max_to_keep: int = 10,
                 async_io: bool = False):
        self._directory = directory
        self._max_to_keep = max_to_keep
        self._checkpoints = []          # committed paths, oldest first
        self._cached: Optional[str] = None
        self._save_counter = 0
        self._async = async_io
        self._pool = None
        self._pending = None
        os.makedirs(directory, exist_ok=True)
        # a resumed run continues the counter and the FIFO, so it never
        # overwrites an existing checkpoint
        self._load_state_file()

    def _snapshot(self, state):
        # a device copy, which later steps do not touch, for the thread
        return _payload(state, torch.clone if self._async
                        else (lambda t: t))

    def _run(self, fn, *args) -> None:
        if not self._async:
            fn(*args)
            return
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-io")
        self._pending = self._pool.submit(fn, *args)

    def wait(self) -> None:
        """Wait for the write in flight (and re-raise its error)."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self) -> None:
        """Wait for the write in flight and stop the writer thread."""
        try:
            self.wait()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None

    def _load_state_file(self) -> None:
        state_path = os.path.join(self._directory, STATE_FILE)
        if not os.path.exists(state_path):
            return
        try:
            with open(state_path) as fp:
                meta = json.load(fp)
            self._save_counter = max(self._save_counter,
                                     int(meta.get("save_counter", 0)))
            self._checkpoints = [
                os.path.join(self._directory, name)
                for name in meta.get("checkpoints", [])
                if os.path.exists(os.path.join(self._directory, name))]
        except (ValueError, OSError):
            pass

    def _write_state_file(self) -> None:
        meta = {"latest": os.path.basename(self._checkpoints[-1]),
                "checkpoints": [os.path.basename(p)
                                for p in self._checkpoints],
                "save_counter": self._save_counter}
        with open(os.path.join(self._directory, STATE_FILE), "w") as fp:
            json.dump(meta, fp, indent=2)

    @property
    def latest_checkpoint(self) -> str:
        return self._checkpoints[-1] if self._checkpoints else ""

    @property
    def save_counter(self) -> int:
        return self._save_counter

    def set_save_counter(self, value: int) -> None:
        """Re-seed the counter (the importer keeps the reference's)."""
        self._save_counter = int(value)

    def _next_path(self, prefix: str) -> str:
        self._save_counter += 1
        name = f"{os.path.basename(prefix)}-{self._save_counter}{CKPT_EXT}"
        return os.path.join(self._directory, name)

    def _push(self, target: str) -> Optional[str]:
        """Append ``target`` to the FIFO; return the evicted path."""
        victim = None
        if len(self._checkpoints) >= self._max_to_keep:
            victim = self._checkpoints.pop(0)
        self._checkpoints.append(target)
        return victim

    def cache(self, state) -> str:
        """Write the epoch's state to the ``tmp`` file
        (checkpoint_manager.py:22-33)."""
        self.wait()  # one write in flight at most
        self._cached = os.path.join(self._directory, "tmp" + CKPT_EXT)
        self._run(_write, self._cached, self._snapshot(state))
        return self._cached

    def commit(self, prefix: str = "model") -> str:
        """Promote the cached file to ``{prefix}-{N}``; with nothing
        cached, return the last committed path
        (checkpoint_manager.py:35-73)."""
        if self._cached is None:
            return self.latest_checkpoint
        self.wait()  # the cached file must exist before the rename
        target = self._next_path(prefix)
        os.replace(self._cached, target)
        self._cached = None
        victim = self._push(target)
        # evict only after the replacement landed
        if victim is not None and os.path.exists(victim):
            os.remove(victim)
        self._write_state_file()
        return target

    def save(self, prefix: str, state) -> str:
        """Unconditional numbered save (checkpoint_manager.py:95-105; the
        train CLI's save after every epoch)."""
        self.wait()  # the job in flight reads the FIFO
        target = self._next_path(prefix)
        victim = self._push(target)

        def job(payload):
            # checkpoint.json names a file only once it has landed, and
            # the evicted file outlives its replacement
            _write(target, payload)
            if victim is not None and os.path.exists(victim):
                os.remove(victim)
            self._write_state_file()

        self._run(job, self._snapshot(state))
        return target

    def chdir(self, directory: str) -> None:
        """Move to another directory (an AL round's,
        checkpoint_manager.py:75-86): drops an uncommitted cache, keeps
        the save counter, and adopts the directory's ``checkpoint.json``
        so a re-entered round continues its counter and FIFO."""
        self.wait()
        if self._cached is not None and os.path.exists(self._cached):
            os.remove(self._cached)
        self._cached = None
        self._checkpoints = []
        self._directory = directory
        os.makedirs(directory, exist_ok=True)
        self._load_state_file()


def reinitialize_final_layer(state, model: nn.Module,
                             generator: torch.Generator):
    """Fresh glorot-uniform weights for the model's output layer
    (``model.output_module``: "Final" on ENet, "Classifier" on ICNet)
    from the CPU ``generator``, the AL CLI's ``-r`` transfer option
    (active_learning.py:461-462, 905-910). Like the JAX function, which
    replaces ``params[head]`` alone, it leaves every other weight, the
    BN statistics, the optimizer's state, the step and the epoch as
    they were; the packs built from the old layer are cleared
    (``blocks.reset_parameters``). Returns ``state``."""
    from ..models.blocks import reset_parameters
    head = getattr(model, "output_module", None)
    if head is None or not isinstance(getattr(model, head, None),
                                      nn.Module):
        raise KeyError(f"Cannot reinitialize output layer: model "
                       f"{type(model).__name__} declares output_module="
                       f"{head!r}")
    reset_parameters(getattr(model, head), generator)
    return state
