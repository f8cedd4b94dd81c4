"""Exact batched top-k (K6): the CUDA kernel, its plain version and the wrapper.

Counterpart of dsjax/ops/topk_pallas.py:topk_pallas. ``topk(scores, k)``
takes (B, N) float32 scores and returns (values (B, k) float32, indices
(B, k) int32) in the total order that ``jax.lax.top_k`` gives: score
descending, ties to the lower index. The device beam search selects its
top-W from a candidate pool full of equal -1e30 dead slots on every step,
so the tie order decides which slots survive; ``torch.topk`` does not
promise one, so neither the kernel nor its plain version uses it.

The comparator assumes no NaN, as dsjax's does: a NaN score breaks the
total order and the result is then unspecified. -0.0 and +0.0 compare
equal, so their order is by index.

On CUDA tensors ``topk`` launches ``csrc/topk.cu`` (one CTA per row, a
bitonic sort of the padded row in shared memory) or raises; on CPU tensors
it runs the plain version ``topk_reference``. Any k <= N works, for rows of
up to ``MAX_N`` scores (the kernel holds a row of (score, index) pairs,
padded to a power of two, in dynamic shared memory: 16384 pairs are 128 KB
of the 227 KB a CTA may use).
"""

from __future__ import annotations

import threading
from typing import Tuple

import torch

from dsjax_torch.ops import _build

Tensor = torch.Tensor

# wrapper calls on CUDA tensors so far, one per kernel launch
LAUNCHES = 0
_launch_lock = threading.Lock()

MAX_N = 16384


def topk_reference(scores: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of K6: a stable descending sort, cut to k, so
    equal scores keep their index order."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[:, :k], idx[:, :k].to(torch.int32)


def _check(scores: Tensor, k: int) -> None:
    if scores.dim() != 2:
        raise ValueError(f"topk takes (B, N) scores, got {tuple(scores.shape)}")
    if scores.dtype != torch.float32:
        raise TypeError(f"topk takes float32 scores, got {scores.dtype}")
    if not 0 < k <= scores.shape[1]:
        raise ValueError(f"k={k} must be in 1..N={scores.shape[1]}")
    if scores.device.type not in ("cuda", "cpu"):
        raise ValueError(f"topk runs on cuda or cpu tensors, not {scores.device}")


def topk(scores: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Exact top-k over the last axis of (B, N) float32 scores ->
    (values (B, k) float32, indices (B, k) int32), equal to
    ``jax.lax.top_k``. K6 on CUDA tensors, the plain version on CPU ones."""
    global LAUNCHES
    _check(scores, k)
    if scores.device.type == "cpu":
        return topk_reference(scores, k)
    n_b, n = scores.shape
    if n > MAX_N:
        raise ValueError(f"the topk kernel takes rows of at most {MAX_N} scores, got {n}")
    scores = scores.contiguous()
    values = torch.empty((n_b, k), dtype=torch.float32, device=scores.device)
    idx = torch.empty((n_b, k), dtype=torch.int32, device=scores.device)
    if n_b == 0:
        return values, idx
    lib = _build.load_library()
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dsjax_torch_topk(scores.data_ptr(), values.data_ptr(), idx.data_ptr(),
                                   n_b, n, k, stream)
    _build.check(lib, err, "topk launch")
    with _launch_lock:
        LAUNCHES += 1
    return values, idx
