"""One rank of ``tests/test_torch_distributed.py``, torch only: it joins
the world that torchrun's variables name (Gloo on the CPU), runs the
cases of ``inputs.pt`` in the directory it is given on its rows of each
global batch, and writes what it got to ``rank{R}.pt`` there. The test
imports its helpers for the one-process references.

    python tests/_torch_dist_worker.py DIR
"""

import logging
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from semanticsegmentationactivelearning_tpu_torch import (  # noqa: E402
    active_learning as al)
from semanticsegmentationactivelearning_tpu_torch.data import (  # noqa: E402
    loader)
from semanticsegmentationactivelearning_tpu_torch.models.blocks import (  # noqa: E402,E501
    BatchNorm)
from semanticsegmentationactivelearning_tpu_torch.parallel import (  # noqa: E402,E501
    distributed)
from semanticsegmentationactivelearning_tpu_torch.train import (  # noqa: E402
    optim, steps)

DROP_KEY = (7, 0)   # the train step's dropout key
POOL_KEY = (13, 0)  # the pool pass's crop key
MC_PASSES = 2
MC_KEY = (11, 0)    # the BALD round's key


def train_step(x, rows):
    """One train step of the model ``x["model"]`` on ``x["batch"]``'s
    ``rows`` (its dropout masks keyed by the rows' global indices):
    (metrics, the state dict after it)."""
    model = x["model"]
    optimizer, scheduler = optim.make_optimizer(model.parameters(), x["hp"])
    state = steps.create_train_state(model, optimizer, scheduler)
    step = steps.make_train_step(model, x["classes"], x["hp"])
    index = np.arange(x["batch"]["image"].shape[0])[rows]
    masks = steps.dropout_masks(DROP_KEY, index, "cpu")
    metrics = step(state, {k: v[rows] for k, v in x["batch"].items()},
                   masks)
    return metrics, {k: v.clone() for k, v in model.state_dict().items()}


def pool_scores(model, classes, files, hw, global_batch, world):
    """The AL CLI's pool pass over ``files`` (each rank's share of every
    global batch of ``global_batch``): the entropy scores, the BALD
    scores (``MC_PASSES`` passes, the round key ``MC_KEY``) and core-set's
    embeddings."""
    local = global_batch // world
    plan = al.rank_plan(loader.RecordLoader(files, local, min_hw=hw), local,
                        hw)
    mc = steps.make_mc_score_step(model, classes, MC_PASSES)
    out = {}
    for name, step in (
            ("entropy", steps.make_score_step(model, classes, "entropy")),
            ("bald", lambda b: mc(b, MC_KEY, b["index"]))):
        out[name] = al.score_pool(step, plan, len(files), POOL_KEY, hw, 3,
                                  "cpu")
    out["embed"] = al.embed_pool(steps.make_embed_step(model), plan,
                                 len(files), POOL_KEY, hw, 3, "cpu").numpy()
    return out


def bn_step(x, rows):
    """A lone BatchNorm's train forward on ``x``'s ``rows``: its running
    (mean, variance) after it."""
    bn = BatchNorm(x.shape[-1]).to(x.dtype)
    with torch.no_grad():
        bn(x[rows], training=True)
    return bn.running_mean.clone(), bn.running_var.clone()


def main(tmp):
    logging.basicConfig(level=logging.INFO)
    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    distributed.initialize_distributed(torch.device("cpu"))
    rank, world = distributed.process_index(), distributed.process_count()

    def rows(n):
        share = n // world
        return slice(rank * share, (rank + 1) * share)

    out = {"rank": rank, "world": world}
    for case in ("a", "b"):
        x = inputs[case]
        out[case] = train_step(x, rows(x["batch"]["image"].shape[0]))
    x = inputs["c"]
    g = x["batch"]["image"].shape[0]
    out["confusion"] = steps.make_eval_step(x["model"], x["classes"])(
        {k: v[rows(g)] for k, v in x["batch"].items()})
    out["scores"] = pool_scores(x["model"], x["classes"], x["files"],
                                x["hw"], g, world)
    out["bn"] = bn_step(x["bn_input"], rows(x["bn_input"].shape[0]))
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
