"""Class-balanced sampling (reference data_preprocess.py:66-75).

The reference wraps torch's WeightedRandomSampler around inverse class
frequencies of the dataset's type codes. Here: a seeded numpy choice over
the same weights, drawn once per epoch.

The port's own copy of ``medical_tri_modal_pilot_tpu/data/sampler.py``.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


class WeightedClassSampler:
    def __init__(self, type_list: Sequence[int], seed: int = 0):
        types = np.asarray(type_list)
        _classes, inverse, counts = np.unique(types, return_inverse=True,
                                              return_counts=True)
        weights = (1.0 / counts)[inverse]
        self.probs = weights / weights.sum()
        self.n = len(types)
        self.rng = np.random.default_rng(seed)

    def epoch_indices(self) -> np.ndarray:
        return self.rng.choice(self.n, size=self.n, replace=True, p=self.probs)


class SequentialSampler:
    def __init__(self, n: int):
        self.n = n

    def epoch_indices(self) -> np.ndarray:
        return np.arange(self.n)
