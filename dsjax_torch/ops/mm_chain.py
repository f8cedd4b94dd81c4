"""The matmul-only chain (K8): the floor of one recurrent scan step.

Counterpart of the Pallas kernel ``_mm_kernel`` in tools/lstm_microbench.py.
Per step t, in float32: z = h . W + xp[t] over all 4H columns, then
h <- z[:, :H] rounded to bf16; every step's full (B, 4H) product is written
to a scratch buffer, so the chain does the work of one step of K1 without
the gate math. W is (H, 4H), xp (T, B, 4H), h0 (B, H), all bf16.
``mm_chain`` returns (h_T (B, H), z (B, 4H), the last step's product).

On CUDA tensors ``mm_chain`` launches csrc/mm_chain.cu (tensor cores through
WMMA); on CPU tensors it runs the plain version ``mm_chain_reference``. The
port's model never calls it: ``tools/torch_lstm_microbench.py`` times it
beside the scan kernels, as the floor the redesign of K1 measures against.
"""

from __future__ import annotations

import threading
from typing import Tuple

import torch

from dsjax_torch.ops import _build

Tensor = torch.Tensor

LAUNCHES = 0          # wrapper calls on CUDA tensors, one per chain of T steps
_launch_lock = threading.Lock()


def mm_chain_reference(xp: Tensor, w: Tensor, h0: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version: a loop over time, float32 sums of bf16 products."""
    n_h = h0.shape[-1]
    w32 = w.float()
    h = h0
    z = xp.new_zeros(xp.shape[1:])
    for t in range(xp.shape[0]):
        z = (h.float() @ w32 + xp[t].float()).to(xp.dtype)
        h = z[:, :n_h]
    return h.contiguous(), z


def _check(xp: Tensor, w: Tensor, h0: Tensor) -> None:
    if xp.dim() != 3:
        raise ValueError(f"xp must be (T, B, 4H), got {tuple(xp.shape)}")
    n_t, n_b, g4 = xp.shape
    n_h = g4 // 4
    if g4 != 4 * n_h or n_h % 16 or n_b % 16 or n_b > 128:
        raise ValueError(f"batch {n_b} and hidden size {g4 / 4} must be multiples of 16, "
                         f"the batch at most 128")
    for name, t, shape in (("xp", xp, (n_t, n_b, g4)), ("w", w, (n_h, g4)), ("h0", h0, (n_b, n_h))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if t.device != xp.device:
            raise ValueError(f"{name} is on {t.device}, xp on {xp.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        # WMMA loads whole 16 x 16 tiles from 32-byte boundaries
        if t.data_ptr() % 32:
            raise ValueError(f"{name} must start on a 32-byte boundary")
    if xp.device.type not in ("cuda", "cpu"):
        raise ValueError(f"mm_chain runs on cuda or cpu tensors, not {xp.device}")


def mm_chain(xp: Tensor, w: Tensor, h0: Tensor) -> Tuple[Tensor, Tensor]:
    """K8 over all T steps -> (h_T, the last step's full product z)."""
    global LAUNCHES
    _check(xp, w, h0)
    if xp.device.type == "cpu":
        return mm_chain_reference(xp, w, h0)
    n_t, n_b, g4 = xp.shape
    h = torch.empty((2,) + tuple(h0.shape), dtype=h0.dtype, device=h0.device)
    h[0].copy_(h0)
    z = torch.zeros((n_b, g4), dtype=xp.dtype, device=xp.device)
    lib = _build.load_library()
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dsjax_torch_mm_chain(xp.data_ptr(), w.data_ptr(), h.data_ptr(), z.data_ptr(),
                                       n_t, n_b, g4 // 4, stream)
    _build.check(lib, err, "mm_chain launch")
    with _launch_lock:
        LAUNCHES += 1
    return h[n_t % 2], z
