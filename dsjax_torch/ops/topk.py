"""Exact batched top-k (K6): the CUDA kernel, its plain version and the wrapper.

Counterpart of dsjax/ops/topk_pallas.py:topk_pallas. ``topk(scores, k)``
takes (B, N) float32 scores and returns (values (B, k) float32, indices
(B, k) int32) in the order that ``jax.lax.top_k`` gives: the IEEE total
order of the scores, descending, ties to the lower index. So -0.0 ranks
below +0.0, subnormals keep their order, and the values are the scores bit
for bit (-0.0 stays -0.0). The device beam search selects its top-W from a
candidate pool full of equal -1e30 dead slots on every step, so the tie
order decides which slots survive; ``torch.topk`` does not promise one, so
neither the kernel nor its plain version uses it. A NaN score is
unspecified, as in dsjax.

dsjax's Pallas kernel compares the floats themselves (-0.0 equal to +0.0)
and, as XLA runs it on the CPU, flushes subnormals to zero, so on rows of
signed zeros or subnormals it differs from ``jax.lax.top_k``; the port
follows ``jax.lax.top_k``, which dsjax uses wherever it is not on one TPU.
The fused beam scan (K7, ``ops.beam``) keeps the float comparison of the
kernel it ports.

On CUDA tensors ``topk`` launches ``csrc/topk.cu`` (one CTA per row, a
radix select of the k-th key, then only the k survivors ordered) or raises;
on CPU tensors it runs the plain version ``topk_reference``. Any k <= N
works, for rows of up to ``MAX_N`` scores (the kernel holds a thread's
strip of the row in registers, at most 16 scores a thread of 1024).
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


def _order_key(scores: Tensor) -> Tensor:
    """int32 keys of float32 scores whose integer order is the IEEE total
    order: the bits of a score of sign 0, else the bits with all but the
    sign flipped."""
    bits = scores.view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def topk_reference(scores: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of K6: a stable descending sort of the
    total-order keys, cut to k, so equal scores keep their index order; the
    values are gathered from the scores themselves."""
    idx = torch.sort(_order_key(scores), dim=-1, descending=True, stable=True).indices[:, :k]
    return torch.gather(scores, 1, idx), idx.to(torch.int32)


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
