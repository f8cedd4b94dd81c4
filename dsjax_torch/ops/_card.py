"""What the persistent kernels (K1 and K4, csrc/scan_persist.cuh; K8,
csrc/mm_chain.cu) need to know of the card and how their plans reach C."""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

# shared memory a CTA can take on sm_90 (227 KB)
SMEM_LIMIT = 232448

_sm_counts: dict = {}


def sm_count(device: torch.device) -> int:
    """The card's SM count (cached per device)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


def plan_array(plan: Sequence[int]):
    """A plan as the C entry points take it: its fields as a C int array."""
    return (ctypes.c_int * len(plan))(*plan)
