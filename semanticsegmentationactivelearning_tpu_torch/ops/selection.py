"""Set-based acquisition over pool embeddings, the PyTorch port of
``semanticsegmentationactivelearning_tpu/ops/selection.py``.

Greedy k-center ("core-set", Sener & Savarese, arXiv:1708.00489): each
pick is the candidate farthest (squared L2) from the labelled and
already selected examples, so a round's batch covers the pool instead
of clustering on one confusing mode.

It stays O(N*D) in memory, with no ``[N, N]`` distance matrix: the
distances to the initial centers stream over column chunks (one
``[N, D] x [D, chunk]`` product and a masked min a chunk), and each pick
updates the running minimum with one ``[N, D] x [D]`` product. The picks
stay on the embeddings' device: the loop never reads a value back to
the host.
"""

from __future__ import annotations

import torch


def k_center_greedy(embeddings: torch.Tensor, centers, candidates,
                    k: int, col_chunk: int = 1024):
    """Greedy k-center selection.

    :param embeddings: ``[N, D]`` pool embeddings (any float dtype)
    :param centers:    ``[N]`` bool, the labelled examples (the initial
                       center set; may be empty)
    :param candidates: ``[N]`` bool, the selectable (unlabelled) ones
    :param k:          the number of picks. Picks are prefix-stable (the
                       first ``j`` picks of a ``k``-run equal a
                       ``j``-run's); picks beyond ``candidates.sum()``
                       are meaningless and the caller slices them off
    :param col_chunk:  center columns per streamed distance block
    :returns: (picks ``[k]`` int64 indices into N, on the embeddings'
               device; min_dist ``[N]`` float32 squared distance of
               every example to the *initial* center set: ``inf`` with
               no centers, ``-inf`` outside the candidates)
    """
    emb = embeddings.float()
    dev = emb.device
    n = emb.shape[0]
    centers = torch.as_tensor(centers, dtype=torch.bool, device=dev)
    candidates = torch.as_tensor(candidates, dtype=torch.bool, device=dev)
    sq = (emb * emb).sum(dim=1)
    inf = float("inf")

    min_dist = torch.full((n,), inf, dtype=torch.float32, device=dev)
    chunk = min(col_chunk, n)
    for start in range(0, n, chunk):
        cols = emb[start:start + chunk]
        blk = sq[:, None] - 2.0 * (emb @ cols.t()) \
            + sq[None, start:start + chunk]
        blk = torch.where(centers[None, start:start + chunk],
                          blk.clamp_min(0.0), inf)
        min_dist = torch.minimum(min_dist, blk.amin(dim=1))
    # non-candidates never win the argmax
    min_dist = torch.where(candidates, min_dist, -inf)

    dist = min_dist.clone()
    picks = []
    for _ in range(k):
        # first maximum, as jnp.argmax; a 1-element index tensor keeps
        # every step on the device
        nxt = torch.argmax(dist).reshape(1)
        picks.append(nxt)
        row = emb.index_select(0, nxt)[0]
        d2 = (sq - 2.0 * (emb @ row) + sq.index_select(0, nxt)).clamp_min(0.0)
        dist = torch.minimum(dist, d2).index_fill_(0, nxt, -inf)
    picks = torch.cat(picks) if picks else \
        torch.empty(0, dtype=torch.int64, device=dev)
    return picks, min_dist


__all__ = ["k_center_greedy"]
