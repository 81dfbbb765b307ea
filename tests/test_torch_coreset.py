"""The port's core-set (k-center greedy) selection against the JAX
package's, on the CPU:

- ``ops/selection.k_center_greedy`` against the JAX
  ``k_center_greedy`` and a plain numpy greedy (the oracle of
  tests/test_selection.py) on numpy-seeded pools: with and without
  centers, column chunks smaller than N and not dividing it, k beyond
  the candidates, prefix-stable picks and the ``init_min_dist``
  diagnostic (picks equal; distances to 1e-5 relative);
- ``return_embedding`` of ENet (B3_8's mean over H and W) and of ICNet
  (fused8's mean) against the JAX models' ``apply(...,
  return_embedding=True)`` on the same weights (1e-5), through one jit
  at ``_torch_parity.FAST_COMPILE`` (faster here than eager dispatch,
  which compiles every primitive), and ``train/steps.make_embed_step``
  on them.

Measured: about 14 s on one process.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticsegmentationactivelearning_tpu.models import ENet as JaxENet
from semanticsegmentationactivelearning_tpu.ops import (
    selection as jselection)
from semanticsegmentationactivelearning_tpu_torch.ops import selection
from semanticsegmentationactivelearning_tpu_torch.train import steps

from _torch_parity import (fast_jit, flax_variables, icnet_variables,
                           port_icnet, seeded_port_enet)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def oracle_greedy(emb, centers, candidates, k):
    """Greedy k-center in plain numpy (float64), first maximum wins."""
    emb = emb.astype(np.float64)
    cent = list(np.flatnonzero(centers))
    cand = list(np.flatnonzero(candidates))
    picks = []
    for _ in range(k):
        d = [min((((emb[i] - emb[c]) ** 2).sum() for c in cent),
                 default=np.inf) for i in cand]
        best = cand[int(np.argmax(d))]
        picks.append(best)
        cent.append(best)
        cand.remove(best)
    return picks


def _pool(seed, n=40, d=8, labelled=5):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    centers = np.zeros(n, dtype=bool)
    centers[rng.choice(n, labelled, replace=False)] = True
    return emb, centers, ~centers


def _both(emb, centers, candidates, k, col_chunk=1024):
    got = selection.k_center_greedy(torch.from_numpy(emb),
                                    torch.from_numpy(centers),
                                    torch.from_numpy(candidates), k,
                                    col_chunk)
    want = jselection.k_center_greedy(jnp.asarray(emb), jnp.asarray(centers),
                                      jnp.asarray(candidates), k, col_chunk)
    return [t.numpy() for t in got], [np.asarray(a) for a in want]


@pytest.mark.parametrize("col_chunk", [1024, 8, 7])
def test_picks_match_jax_and_the_oracle(col_chunk):
    # 8 < N = 40 streams the distance blocks; 7 leaves a ragged last one
    emb, centers, candidates = _pool(3)
    (picks, dist), (jpicks, jdist) = _both(emb, centers, candidates, 6,
                                           col_chunk)
    assert picks.dtype == np.int64 and picks.shape == (6,)
    np.testing.assert_array_equal(picks, jpicks)
    np.testing.assert_array_equal(picks,
                                  oracle_greedy(emb, centers, candidates, 6))
    fin = np.isfinite(jdist)
    np.testing.assert_array_equal(np.isfinite(dist), fin)
    np.testing.assert_allclose(dist[fin], jdist[fin], rtol=1e-5, atol=0)


def test_no_centers():
    # an empty center set: inf distances, the first candidate first
    emb, _, _ = _pool(5, n=12, d=4)
    centers = np.zeros(12, dtype=bool)
    candidates = np.ones(12, dtype=bool)
    (picks, dist), (jpicks, jdist) = _both(emb, centers, candidates, 12)
    np.testing.assert_array_equal(picks, jpicks)
    np.testing.assert_array_equal(picks,
                                  oracle_greedy(emb, centers, candidates, 12))
    assert sorted(picks.tolist()) == list(range(12))
    assert np.isposinf(dist).all() and np.isposinf(jdist).all()


def test_k_beyond_the_candidates_and_prefix_stability():
    emb, _, _ = _pool(9, n=8, d=4)
    centers = np.zeros(8, dtype=bool)
    centers[:5] = True
    (picks, _), (jpicks, _) = _both(emb, centers, ~centers, 6)
    # the first three drain the pool; the rest is the caller's to slice
    assert sorted(picks[:3].tolist()) == [5, 6, 7]
    np.testing.assert_array_equal(picks[:3], jpicks[:3])
    emb, centers, candidates = _pool(3)
    full, _ = selection.k_center_greedy(torch.from_numpy(emb), centers,
                                        candidates, 10)
    short, _ = selection.k_center_greedy(torch.from_numpy(emb), centers,
                                         candidates, 4)
    assert torch.equal(full[:4], short)
    assert len(set(full.tolist())) == 10 and candidates[full.numpy()].all()


def test_init_min_dist_is_the_distance_to_the_centers():
    emb, centers, candidates = _pool(4)
    _, dist = selection.k_center_greedy(torch.from_numpy(emb), centers,
                                        candidates, 1, col_chunk=16)
    dist = dist.numpy()
    c_emb = emb[centers].astype(np.float64)
    for i in np.flatnonzero(candidates):
        want = ((emb[i] - c_emb) ** 2).sum(axis=1).min()
        np.testing.assert_allclose(dist[i], want, rtol=1e-5)
    assert np.isneginf(dist[~candidates]).all()


# -- the embeddings --------------------------------------------------------

def _jax_embedding(jm, variables, x):
    """``jm.apply(..., return_embedding=True)`` through one jit at
    ``FAST_COMPILE`` (about 1 s for ENet; eagerly, a compile for every
    primitive, 7 s)."""
    fn = fast_jit(lambda v, x: jm.apply(v, x, training=False,
                                        return_embedding=True),
                  variables, jnp.asarray(x))
    return np.asarray(fn(variables, jnp.asarray(x)))


def test_enet_embedding_matches_jax():
    model = seeded_port_enet(5, 2, multiscale_heads=False).eval()
    x = np.random.default_rng(8).uniform(size=(2, 32, 64, 3)) \
        .astype(np.float32)
    want = _jax_embedding(JaxENet(num_classes=5), flax_variables(model), x)
    got = steps.make_embed_step(model)({"image": torch.from_numpy(x)})
    assert got.dtype == torch.float32 and got.shape == (2, 128)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.abs(want).max() > 1e-2


def test_icnet_embedding_matches_jax():
    jm, variables = icnet_variables(5, (64, 64), 3)
    model = port_icnet(variables, 5)
    x = np.random.default_rng(9).uniform(size=(2, 64, 64, 3)) \
        .astype(np.float32)
    want = _jax_embedding(jm, variables, x)
    got = steps.make_embed_step(model)({"image": torch.from_numpy(x)})
    assert got.dtype == torch.float32 and got.shape == (2, 128)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.abs(want).max() > 1e-2
