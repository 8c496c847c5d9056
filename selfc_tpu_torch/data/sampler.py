"""Distributed iteration-oriented sampler: the JAX package's
``data/sampler.py`` (reference data/data_sampler.py:12-65).

It inflates the epoch by ``ratio`` (200) so the loader restarts rarely,
shuffles deterministically by epoch seed, and strides the indices across
ranks (the processes of ``parallel/dist.py``).
"""

from __future__ import annotations

import math

import numpy as np


class DistIterSampler:
    def __init__(self, dataset_size: int, num_replicas: int, rank: int, ratio: int = 200):
        if rank >= num_replicas:
            raise ValueError("invalid rank")
        self.dataset_size = dataset_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(dataset_size * ratio / self.num_replicas))
        self.total_size = self.num_samples * self.num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.default_rng(self.epoch)
        indices = rng.permutation(self.total_size) % self.dataset_size
        indices = indices[self.rank : self.total_size : self.num_replicas]
        return iter(indices.tolist())

    def __len__(self):
        return self.num_samples
