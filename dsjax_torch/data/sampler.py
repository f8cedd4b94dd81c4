"""Batch samplers: epoch-seeded shuffling, mid-epoch resume, per-rank sharding.

A copy of dsjax/data/sampler.py (reference loader/data_loader.py:282-360:
DSRandomSampler, pre-binned fixed batches, an epoch-seeded permutation,
start_index resume; DSElasticDistributedSampler, the same rank-strided
and padded to equal length), drawing from numpy's default_rng as dsjax
does, so both packages give the same batches in the same order for a seed,
a rank and a number of replicas. A replica is a DDP rank here, a JAX
process in dsjax.
"""

from __future__ import annotations

import math
from typing import Iterator, List

import numpy as np


def _make_bins(n: int, batch_size: int) -> List[List[int]]:
    ids = list(range(n))
    return [ids[i:i + batch_size] for i in range(0, n, batch_size)]


class BucketBatchSampler:
    """Single-host sampler (reference DSRandomSampler parity).

    Batches are fixed contiguous bins of dataset order — manifests are
    duration-sorted, so bins group similar lengths, which minimizes padding
    waste AND keeps XLA shape buckets tight.
    """

    def __init__(self, dataset_size: int, batch_size: int = 1, seed: int = 0):
        self.dataset_size = dataset_size
        self.batch_size = batch_size
        self.seed = seed
        self.start_index = 0
        self.epoch = 0
        self.bins = _make_bins(dataset_size, batch_size)

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng(self.seed + self.epoch)
        order = rng.permutation(len(self.bins) - self.start_index) + self.start_index
        for x in order:
            batch_ids = list(self.bins[int(x)])
            rng.shuffle(batch_ids)
            yield batch_ids

    def __len__(self) -> int:
        return len(self.bins) - self.start_index

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "start_index": self.start_index}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = state.get("epoch", 0)
        self.start_index = state.get("start_index", 0)


class OrderedBatchSampler(BucketBatchSampler):
    """Deterministic in-order batches (validation/eval)."""

    def __iter__(self) -> Iterator[List[int]]:
        for b in self.bins[self.start_index:]:
            yield list(b)


class DistributedBucketSampler(BucketBatchSampler):
    """Multi-rank sampler (reference DSElasticDistributedSampler parity):
    every rank gets ceil(n_bins / num_replicas) batches, padded by wrapping,
    subsampled rank-strided so shuffles stay aligned across ranks."""

    def __init__(self, dataset_size: int, batch_size: int = 1, seed: int = 0,
                 num_replicas: int = 1, rank: int = 0):
        super().__init__(dataset_size, batch_size, seed)
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} is not one of {num_replicas} replicas")
        self.num_replicas = num_replicas
        self.rank = rank

    @property
    def num_samples(self) -> int:
        return int(math.ceil(float(len(self.bins) - self.start_index) / self.num_replicas))

    @property
    def total_size(self) -> int:
        return self.num_samples * self.num_replicas

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng(self.seed + self.epoch)
        indices = list(rng.permutation(len(self.bins) - self.start_index) + self.start_index)
        # pad by wrapping until every rank gets num_samples batches (the
        # reference pads once and breaks when num_replicas > n_bins,
        # data_loader.py:348; dsjax and the port wrap repeatedly)
        while len(indices) < self.total_size:
            indices += indices[: (self.total_size - len(indices))]
        indices = indices[self.rank: self.total_size: self.num_replicas]
        for x in indices:
            batch_ids = list(self.bins[int(x)])
            rng.shuffle(batch_ids)
            yield batch_ids

    def __len__(self) -> int:
        return self.num_samples


class DistributedOrderedSampler(DistributedBucketSampler):
    """Deterministic in-order rank-strided batches for multi-rank
    validation. Bins are padded by wrapping so every rank steps the same
    number of times; the wrapped duplicates slightly overweight early bins,
    the trade the reference's padded DistributedSampler makes
    (data_loader.py:344-351)."""

    def __iter__(self) -> Iterator[List[int]]:
        indices = list(range(self.start_index, len(self.bins)))
        while len(indices) < self.total_size:
            indices += indices[: self.total_size - len(indices)]
        for x in indices[self.rank: self.total_size: self.num_replicas]:
            yield list(self.bins[int(x)])
