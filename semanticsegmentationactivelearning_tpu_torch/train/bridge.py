"""Weight bridge from the JAX package to the PyTorch port.

The JAX package keeps a model's weights (ENet's, ICNet's) as a flax
variable tree ``{"params": ..., "batch_stats": ...}`` of nested dicts;
the port keeps a ``state_dict`` whose keys carry the same module names.
The rules:

- Conv ``kernel [kh, kw, in, out]`` -> ``weight [out, in, kh, kw]``; a
  conv ``bias`` (ICNet's ``Classifier`` and ``aux_cls``) stays ``bias``.
- ConvTranspose ``kernel [3, 3, in, out]`` (``lax.conv_transpose`` with
  ``transpose_kernel=False``) -> spatially flipped, ``[in, out, kh, kw]``
  (the port runs ``conv_transpose2d(stride=2)`` and crops to 2H x 2W).
- BatchNorm ``scale/bias`` (params) and ``mean/var`` (batch_stats) ->
  ``weight/bias/running_mean/running_var``.
- PReLU ``alpha`` stays as it is.

ENet's multiscale loss heads (``MultiscaleHead_*``, 1x1 convs) and
ICNet's cascade heads (``aux_cls``) cross like any other conv; an ENet
built without heads drops them on loading (``ENet.load_state_dict``).

:func:`read_jax_checkpoint` reads the ``.ckpt`` files the JAX
package's ``train/checkpoint.save_checkpoint`` writes (flax msgpack,
ndarrays as msgpack ext type 1 holding ``(shape, dtype, bytes)``) with
the ``msgpack`` module alone.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_BN_NAMES = {"scale": "weight", "bias": "bias",
             "mean": "running_mean", "var": "running_var"}
# msgpack ext codes of flax.serialization for arrays and numpy scalars
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _convert(path: tuple, value: np.ndarray) -> tuple:
    """(state_dict key, torch tensor) for one flax leaf."""
    *mods, leaf = path
    value = np.array(value, dtype=np.float32)
    if leaf == "kernel":
        if mods[-1] == "deconv":
            value = np.transpose(value[::-1, ::-1], (2, 3, 0, 1))
        else:
            value = np.transpose(value, (3, 2, 0, 1))
        name = "weight"
    elif leaf == "alpha":
        name = "alpha"
    elif leaf in _BN_NAMES:
        name = _BN_NAMES[leaf]
    else:
        raise KeyError(f"unknown flax leaf {'/'.join(path)}")
    key = ".".join([*mods, name])
    return key, torch.from_numpy(np.ascontiguousarray(value))


def _walk(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax ``{"params", "batch_stats"}`` tree (nested dicts of
    numpy arrays) to the port's ``state_dict`` (ENet or ICNet)."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _walk(variables.get(collection, {})):
            key, tensor = _convert(path, value)
            out[key] = tensor
    return out


def _ext_hook(code: int, data: bytes):
    import msgpack
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        return msgpack.ExtType(code, data)
    shape, dtype, buf = msgpack.unpackb(data, raw=False)
    arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
    return arr[()] if code == _EXT_NPSCALAR else arr


def read_jax_checkpoint(path: str) -> dict:
    """The state tree of a JAX-package ``.ckpt`` (a serialized
    ``TrainState``: params, batch_stats, opt_state, step, epoch) as
    nested dicts of numpy arrays."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError(
            "reading a JAX checkpoint needs the 'msgpack' module") from e
    with open(path, "rb") as fp:
        return msgpack.unpackb(fp.read(), ext_hook=_ext_hook, raw=False,
                               strict_map_key=False)


def is_jax_checkpoint(path: str) -> bool:
    """True for a flax msgpack file (a msgpack map), False for a
    ``torch.save`` zip archive."""
    with open(path, "rb") as fp:
        head = fp.read(1)
    return bool(head) and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


def state_dict_from_jax_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    return state_dict_from_flax(read_jax_checkpoint(path))
