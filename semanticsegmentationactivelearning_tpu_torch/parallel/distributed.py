"""Multi-process runs of the PyTorch port over ``torch.distributed``: the
counterpart of ``semanticsegmentationactivelearning_tpu/parallel/
mesh.py:37-155`` without the ``Mesh``.

The JAX package shards each global batch over a ``("data",)`` mesh and
XLA inserts the gradient and metric ``psum``s. Here every rank is one
process with one card (or the CPU), holds a replica of the model and
decodes only its rows of each global batch (``RecordLoader.
global_batches``); the collectives are explicit:

- train-mode batch norm reduces its statistics over the global batch
  (``models.blocks.BatchNorm``), the masked CE divides by the global
  mask sum (``ops.losses``), and the train step sums the gradients and
  the metrics across ranks (``train.steps``);
- the eval step sums its confusion matrix, so every rank takes the
  same branch on the validation mIoU;
- the AL loop's pool pass gathers the ranks' scores or embeddings in
  pool order (:func:`all_gather_rows`), so every rank picks the same
  examples; rank 0 alone writes, and the round's checkpoint path is
  broadcast (:func:`broadcast_str`).

Ranks join from torchrun's environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``): ``torchrun --nproc_per_node N -m
semanticsegmentationactivelearning_tpu_torch.train ...``. The backend
rule: NCCL where each rank of a host has a card of its own (rank
``LOCAL_RANK`` on ``cuda:LOCAL_RANK``), Gloo where the ranks of a host
share its cards (more ranks than cards: ``cuda:LOCAL_RANK % cards``;
Gloo reduces and broadcasts CUDA tensors through the host) or run on
the CPU (``--device cpu``). Every rank logs the rule's choice; a failed
join raises, and a rank never moves to the CPU because it found no card.

Without torchrun's ``WORLD_SIZE`` no process group exists and every
helper here is the identity of one process: the one-process paths run
exactly as before. With it (a one-rank world included) the helpers run
their collectives.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Iterable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# how long a rank waits for the others at a collective before it raises
TIMEOUT = datetime.timedelta(minutes=10)


def launched() -> bool:
    """Whether torchrun's environment asks this process to join a
    world (``WORLD_SIZE`` set, a world of one included)."""
    return "WORLD_SIZE" in os.environ


def env_world_size() -> int:
    """The world size torchrun's environment names (1 without it)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def active() -> bool:
    """Whether this process is a rank of a joined world."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if active() else 0


def process_count() -> int:
    return dist.get_world_size() if active() else 1


def is_main() -> bool:
    """Rank 0, the one that writes."""
    return process_index() == 0


def backend_for(device: torch.device) -> tuple:
    """The backend rule: ``(backend, reason)`` for a rank on
    ``device``."""
    if device.type != "cuda":
        return "gloo", "ranks on the CPU"
    cards = torch.cuda.device_count()
    ranks = int(os.environ.get("LOCAL_WORLD_SIZE", env_world_size()))
    if ranks > cards:
        return "gloo", f"{ranks} ranks share this host's {cards} card(s)"
    return "nccl", f"a card a rank ({ranks} ranks, {cards} cards)"


def initialize_distributed(device: torch.device) -> None:
    """Join the ranks that torchrun's environment names, on ``device``
    (this rank's card, ``utils.cli.device_from_args``, or the CPU), by
    the backend rule (:func:`backend_for`), then wait for every rank.
    Raises if the join fails or times out."""
    rank, world = int(os.environ["RANK"]), env_world_size()
    backend, reason = backend_for(device)
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device
    logger.info("Rank %d of %d (local rank %d): backend %s on %s (%s)",
                rank, world, local_rank(), backend, device, reason)
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=rank, timeout=TIMEOUT, **kwargs)
    sync_processes("ssal-startup")


def shutdown() -> None:
    """Leave the world (after a last barrier), if this process joined
    one."""
    if active():
        sync_processes("ssal-shutdown")
        dist.destroy_process_group()


def sync_processes(tag: str) -> None:
    """A barrier across the ranks (no-op in one process); ``tag`` names
    it in the debug log."""
    if not active():
        return
    logger.debug("barrier %s", tag)
    dist.barrier()


def check_batch_divisible(batch_size: int, world: int) -> None:
    """The JAX CLIs' rule (root train.py:170-178): the conf's
    ``batch_size`` is the global batch and divides by the world."""
    if batch_size % world:
        raise ValueError("Multi-host run needs batch_size divisible by the "
                         f"global device count {world}")


def process_shard(count: int, process_id: Optional[int] = None,
                  num_processes: Optional[int] = None) -> slice:
    """This rank's contiguous slice of ``count`` examples (each rank
    decodes only its rows of the global batch)."""
    pid = process_index() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    per = -(-count // n)
    return slice(pid * per, min(count, (pid + 1) * per))


def batches(loader, order, global_batch_size: int
            ) -> Iterator[dict]:
    """This rank's rows of each global batch of ``order``
    (``RecordLoader.global_batches``; ``loader``'s batch size is the
    rank's share). Every rank sees as many batches; the padding rows of
    a short last batch, a whole empty share among them, carry ``valid``
    False. In one process: ``loader.batches(order)``."""
    return loader.global_batches(np.asarray(order), global_batch_size,
                                 process_index(), process_count())


def _device() -> torch.device:
    """Where a collective's own buffers live: this rank's card under
    NCCL, the CPU under Gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The elementwise sum of ``x`` over the ranks, differentiable
    (``torch.distributed.nn.functional.all_reduce``: the backward sums
    the gradients over the ranks too, as each rank's loss reads every
    rank's input). ``x`` itself in one process."""
    if not active():
        return x
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(x)


def all_reduce_grads(parameters: Iterable[torch.nn.Parameter]) -> None:
    """Sum the parameters' gradients over the ranks in place, in one
    collective over their concatenation (no-op in one process)."""
    if not active():
        return
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def all_gather_rows(x: torch.Tensor, count: Optional[int] = None
                    ) -> torch.Tensor:
    """The ranks' rows in rank order, padding dropped: rank r gives the
    first ``count`` (default all) rows of its ``x`` ``[rows, ...]``; the
    row counts may differ between ranks, the trailing shape not. Every
    rank gets ``[sum of counts, ...]``, bit for bit the rows given. ``x``
    itself (its first ``count`` rows) in one process. One reduction of
    the counts, one of the rows, each rank's rows in a slot of its own."""
    count = x.shape[0] if count is None else int(count)
    if not active():
        return x[:count]
    world, rank = process_count(), process_index()
    counts = torch.zeros(world, dtype=torch.int64, device=_device())
    counts[rank] = count
    dist.all_reduce(counts)
    counts = counts.tolist()
    if not max(counts):
        return x[:0]
    slots = torch.zeros((world, max(counts), *x.shape[1:]), dtype=x.dtype,
                        device=x.device)
    slots[rank, :count] = x[:count]
    dist.all_reduce(slots)
    return torch.cat([slots[r, :counts[r]] for r in range(world)])


def broadcast_str(s: Optional[str]) -> str:
    """Rank 0's string on every rank (the JAX AL's ``_bcast_str``: the
    committed checkpoint path for the restore from a shared
    filesystem); ``None`` travels as ``""``."""
    s = s or ""
    if not active():
        return s
    data = s.encode()
    size = torch.tensor([len(data)], dtype=torch.int64, device=_device())
    dist.broadcast(size, 0)
    if not size.item():
        return ""
    buf = torch.zeros(int(size.item()), dtype=torch.uint8, device=_device())
    if is_main():
        buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
    dist.broadcast(buf, 0)
    return bytes(buf.cpu().tolist()).decode()
