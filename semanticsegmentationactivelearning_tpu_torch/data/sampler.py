"""Host-side index-set sampler for the active-learning loop.

Replaces the reference's placeholder-backed ``NumpyCapsule``
(tensortools/input.py:331-435) with a plain numpy object: JAX has no
placeholders, so the AL loop simply computes each epoch's example order
on the host and hands arrays to the loader.

Semantics preserved:

- ``set_indices(indices)`` restricts epochs to a subset (the labelled
  set); the complement becomes the pseudo-label sample pool
  (input.py:369-395).
- ``set_sample_size(n)`` adds ``n`` examples drawn without replacement
  from the sample pool each epoch (input.py:347-358).
- ``epoch_order()`` shuffles the combined set (input.py:352-359).
- ``size`` is ``len(indices) + sample_size`` (input.py:408-410).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class IndexSampler:

    def __init__(self, filenames, rng: Optional[np.random.Generator] = None,
                 shuffle: bool = True):
        self.filenames = np.asarray(filenames)
        self.shuffle = shuffle
        self._rng = rng if rng is not None else np.random.default_rng()
        self._full_range = np.arange(len(self.filenames))
        self._indices = self._full_range
        self._sample_set = np.empty(0, dtype=np.int64)
        self._sample_size = 0
        self._sample_prob = None

    def set_indices(self, indices=None, sample_indices=None,
                    sample_prob=None) -> None:
        if indices is None:
            self._indices = self._full_range
            self._sample_set = np.empty(0, dtype=np.int64)
            self._sample_size = 0
            self._sample_prob = None
            return
        self._indices = np.asarray(indices, dtype=np.int64)
        # probabilities never outlive the sample set they were sized for
        self._sample_prob = None
        if sample_indices is None:
            self._sample_set = self._full_range[
                np.isin(self._full_range, self._indices, invert=True)]
        else:
            self._sample_set = np.asarray(sample_indices, dtype=np.int64)
        if sample_prob is not None:
            if len(sample_prob) != len(self._sample_set):
                raise ValueError(
                    f"sample_prob length {len(sample_prob)} != sample "
                    f"set size {len(self._sample_set)}")
            self._sample_prob = np.asarray(sample_prob)

    def set_sample_size(self, size: int) -> int:
        self._sample_size = int(size)
        return self._sample_size

    @property
    def indices(self) -> np.ndarray:
        return self._indices

    @property
    def size(self) -> int:
        return len(self._indices) + self._sample_size

    def epoch_order(self) -> np.ndarray:
        """Indices for one epoch: the active set plus a fresh random
        sample from the complement, shuffled together."""
        indices = self._indices.copy()
        if self._sample_size > 0 and len(self._sample_set) > 0:
            draw = min(self._sample_size, len(self._sample_set))
            sampled = self._rng.choice(self._sample_set, draw,
                                       replace=False, p=self._sample_prob)
            indices = np.concatenate((indices, sampled))
        if self.shuffle:
            self._rng.shuffle(indices)
        return indices
