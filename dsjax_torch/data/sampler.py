"""Batch samplers: epoch-seeded shuffling and mid-epoch resume.

A copy of the single-process samplers of dsjax/data/sampler.py (reference
loader/data_loader.py:282-317, DSRandomSampler: pre-binned fixed batches,
an epoch-seeded permutation, start_index resume), drawing from numpy's
default_rng as dsjax does, so both packages give the same batches in the
same order for a seed. The distributed samplers wait for multi-device
training (ROADMAP.md, Queue 1 item 6).
"""

from __future__ import annotations

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
