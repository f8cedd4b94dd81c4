"""The whole no-LM, no-pruning CTC prefix-beam scan in one kernel (K7) and
the backtrack that reads its output: the CUDA kernels, their plain
versions and the wrappers.

Counterpart of dsjax/ops/beam_pallas.py:fused_beam_scan. ``fused_beam_scan``
takes log_probs (B, T, C) float32 and sizes (B,) and returns, bit for bit,
what ``decode.beam_device._beam_scan`` returns on the same decode (no
pruning), slot order included:

  backptr, emit, (h1_seq, h2_seq)   (T, B, W) int32
  totals                            (B, W) float32
  carry                             (p_b, p_nb, last, h1, h2, ph1, ph2), (B, W)
  ranking                           (totals sorted descending, ties to the
                                    lower slot; their slots), both (B, W)

The carry has the scan's structure, so a stream may switch between K7 and
the scan from one chunk to the next; ``carry0`` resumes from either's
carry. The ranking lets a decode pick its n-best without a K6 launch.
Limits: W <= 128, C <= 30, as dsjax's.

``backtrack`` chases the parent pointers of either route's (T, B, W)
backptr and emit from (B, K) slots back to t = 0, as
``decode.beam_device._backtrack`` does (dsjax/decode/beam_device.py:
_backtrack): (T, B, K) int16 chars and the (B, K) start slots.

On CUDA tensors the wrappers launch ``csrc/beam_scan.cu`` (K7: the time
loop inside, the beam state in shared memory, a CTA an utterance; the
backtrack: a thread per followed beam) or raise; on
CPU tensors they run the plain versions, ``fused_beam_scan_reference`` (the
port's ``_beam_scan`` with K7's float-order selection) and ``_backtrack``.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from dsjax_torch.ops import _build

Tensor = torch.Tensor

# wrapper calls on CUDA tensors so far, one per kernel launch: K7's and the
# backtrack's
LAUNCHES = 0
BACKTRACK_LAUNCHES = 0
_launch_lock = threading.Lock()

MAX_WIDTH = 128
MAX_CLASSES = 30


def _float_order_top_k(scores: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """K7's selection: a stable descending sort of the floats themselves,
    cut to k. It compares as K7 and dsjax's fused scan do
    (csrc/beam_scan.cu:score_key, dsjax/ops/topk_pallas.py:_before), so
    -0.0 ties with +0.0, where K6 follows jax.lax.top_k's total order."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[:, :k], idx[:, :k].to(torch.int32)


def fused_beam_scan_reference(log_probs: Tensor, sizes: Tensor, w: int, blank: int,
                              carry0: Optional[Tuple[Tensor, ...]] = None):
    """Plain PyTorch version of K7: the scan with K7's selection, and the
    final beams ranked by it."""
    from dsjax_torch.decode.beam_device import _beam_scan

    backptr, emit, hists, totals, carry = _beam_scan(log_probs, sizes, w, blank,
                                                     carry0=carry0, top_k=_float_order_top_k)
    return backptr, emit, hists, totals, carry, _float_order_top_k(totals, w)


def _check(log_probs: Tensor, sizes: Tensor, w: int, blank: int, carry0) -> None:
    if log_probs.dim() != 3 or log_probs.dtype != torch.float32:
        raise ValueError(f"log_probs must be (B, T, C) float32, got {tuple(log_probs.shape)} "
                         f"{log_probs.dtype}")
    b_dim, _, c_dim = log_probs.shape
    if not 0 < w <= MAX_WIDTH or not 0 < c_dim <= MAX_CLASSES or not 0 <= blank < c_dim:
        raise ValueError(f"fused_beam_scan takes 1 <= W <= {MAX_WIDTH} (got {w}), "
                         f"1 <= C <= {MAX_CLASSES} (got {c_dim}), blank < C (got {blank})")
    if tuple(sizes.shape) != (b_dim,) or sizes.device != log_probs.device:
        raise ValueError(f"sizes must be ({b_dim},) on {log_probs.device}")
    if log_probs.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_beam_scan runs on cuda or cpu tensors, not {log_probs.device}")
    if carry0 is not None:
        dtypes = (torch.float32,) * 2 + (torch.int32,) * 5
        if len(carry0) != 7 or any(tuple(a.shape) != (b_dim, w) or a.dtype != dt
                                   or a.device != log_probs.device
                                   for a, dt in zip(carry0, dtypes)):
            raise ValueError("carry0 must be 7 (B, W) tensors: p_b, p_nb f32, then "
                             "last, h1, h2, ph1, ph2 int32, on the posteriors' device")


def fused_beam_scan(log_probs: Tensor, sizes: Tensor, w: int, blank: int,
                    carry0: Optional[Tuple[Tensor, ...]] = None):
    """K7 on CUDA tensors, the plain version on CPU ones; see the module
    docstring for the outputs."""
    global LAUNCHES
    sizes = torch.as_tensor(sizes, device=log_probs.device).to(torch.int32)
    _check(log_probs, sizes, w, blank, carry0)
    if log_probs.device.type == "cpu":
        return fused_beam_scan_reference(log_probs, sizes, w, blank, carry0)
    b_dim, t_dim, c_dim = log_probs.shape
    dev = log_probs.device
    lp = log_probs.contiguous()
    sizes = sizes.contiguous()
    i32 = dict(dtype=torch.int32, device=dev)
    seqs = [torch.empty((t_dim, b_dim, w), **i32) for _ in range(4)]  # backptr emit h1 h2
    totals = torch.empty((b_dim, w), dtype=torch.float32, device=dev)
    ranked = torch.empty_like(totals)
    order = torch.empty((b_dim, w), **i32)
    carry = (torch.empty_like(totals), torch.empty_like(totals)) + tuple(
        torch.empty((b_dim, w), **i32) for _ in range(5))
    init = ([a.contiguous() for a in carry0] if carry0 is not None else None)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dsjax_torch_beam_scan(
            lp.data_ptr(), sizes.data_ptr(),
            *([a.data_ptr() for a in init] if init is not None else [None] * 7),
            *(a.data_ptr() for a in seqs), totals.data_ptr(), ranked.data_ptr(),
            order.data_ptr(), *(a.data_ptr() for a in carry),
            b_dim, t_dim, c_dim, w, blank, stream)
    _build.check(lib, err, "beam_scan launch")
    with _launch_lock:
        LAUNCHES += 1
    backptr, emit, h1s, h2s = seqs
    return backptr, emit, (h1s, h2s), totals, carry, (ranked, order)


def backtrack(backptr: Tensor, emit: Tensor, order: Tensor) -> Tuple[Tensor, Tensor]:
    """(T, B, W) int32 backptr and emit, and the (B, K) slots to follow ->
    ((T, B, K) int16 chars, -1 where none, (B, K) int32 start slots at
    t = 0). One kernel launch on CUDA tensors, ``_backtrack`` on CPU ones."""
    global BACKTRACK_LAUNCHES
    if backptr.dim() != 3 or tuple(emit.shape) != tuple(backptr.shape):
        raise ValueError(f"backptr and emit must be one (T, B, W) shape, got "
                         f"{tuple(backptr.shape)} and {tuple(emit.shape)}")
    if order.dim() != 2 or order.shape[0] != backptr.shape[1]:
        raise ValueError(f"order must be (B, K) with B={backptr.shape[1]}, got "
                         f"{tuple(order.shape)}")
    if emit.device != backptr.device or order.device != backptr.device:
        raise ValueError("backptr, emit and order must be on one device")
    if backptr.device.type == "cpu":
        from dsjax_torch.decode.beam_device import _backtrack

        return _backtrack(backptr, emit, order)
    if backptr.device.type != "cuda":
        raise ValueError(f"backtrack runs on cuda or cpu tensors, not {backptr.device}")
    if backptr.dtype != torch.int32 or emit.dtype != torch.int32:
        raise TypeError(f"backptr and emit must be int32, got {backptr.dtype}, {emit.dtype}")
    t_dim, b_dim, w = backptr.shape
    k_dim = order.shape[1]
    dev = backptr.device
    order = order.to(torch.int32).contiguous()
    chars = torch.empty((t_dim, b_dim, k_dim), dtype=torch.int16, device=dev)
    if b_dim == 0 or k_dim == 0:
        return chars, order
    start = torch.empty((b_dim, k_dim), dtype=torch.int32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dsjax_torch_beam_backtrack(backptr.contiguous().data_ptr(),
                                             emit.contiguous().data_ptr(), order.data_ptr(),
                                             chars.data_ptr(), start.data_ptr(), t_dim, b_dim,
                                             w, k_dim, stream)
    _build.check(lib, err, "beam_backtrack launch")
    with _launch_lock:
        BACKTRACK_LAUNCHES += 1
    return chars, start
