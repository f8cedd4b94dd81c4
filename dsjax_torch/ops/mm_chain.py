"""The matmul-only chain (K8): the floor of one recurrent scan step.

Counterpart of the Pallas kernel ``_mm_kernel`` in tools/lstm_microbench.py.
Per step t, in float32: z = h . W + xp[t] over all 4H columns, then
h <- z[:, :H] rounded to bf16; every step's full (B, 4H) product is written
to a scratch buffer, so the chain does the work of one step of K1 without
the gate math. W is (H, 4H), xp (T, B, 4H), h0 (B, H), all bf16.
``mm_chain`` returns (h_T (B, H), z (B, 4H), the last step's product).

On CUDA tensors ``mm_chain`` launches csrc/mm_chain.cu: one cooperative
launch runs all T steps, each CTA (one an SM) keeping its 32 columns of W
in shared memory for the whole chain, loading h by tensor copies (TMA) and
running the step product with wgmma, laid out by ``chain_plan``; where the
card cannot hold the grid at once it raises. On CPU tensors it runs the plain version
``mm_chain_reference``. The port's model never calls it:
``tools/torch_lstm_microbench.py`` times it beside the scan kernels, as
their floor.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Tuple

import torch

from dsjax_torch.ops import _build
from dsjax_torch.ops._card import SMEM_LIMIT, plan_array, sm_count

Tensor = torch.Tensor

LAUNCHES = 0          # wrapper calls on CUDA tensors with T > 0, one per chain of T steps
_launch_lock = threading.Lock()

# what csrc/mm_chain.cu takes: 32 output columns a CTA (wgmma's N), h in K
# atoms of 64 bf16 (one 128-byte swizzled row), their count a multiple of
# 4 (the product's unrolled unit) and at most 20 (an mbarrier of 8 bytes
# each), a ring of 2 buffers at least, a 1024-byte alignment pad, at most
# 128 batch rows (two m64 tiles)
COLS = 32
_ATOM_K = 64
_UNIT = 4
_MAX_ATOMS = 20
_MIN_STAGES = 2
_ALIGN = 1024
MAX_BATCH = 128


class ChainPlan(NamedTuple):
    """K8's layout (csrc/mm_chain.cu ``Plan``, in this order): CTAs (one
    an SM, 32 output columns each), columns a CTA, the rows of the step
    product (B padded to 64 or 128), h's buffers of one K atom in shared
    memory, whether every atom of h has its own buffer (1; else 0, h
    streams through them as a ring), and the shared memory a CTA."""

    ctas: int
    cols: int
    m_rows: int
    stages: int
    resident: int
    smem_bytes: int


def chain_plan(n_b: int, n_h: int, sm_count: int) -> ChainPlan:
    """K8's plan for batch B and width H on a card of ``sm_count`` SMs:
    4H / 32 CTAs, each with its (H x 32) slice of W resident (4 KB a K atom
    of 64, ceil(H / 256) x 4 atoms) and h_t in K atoms beside it, every
    atom its own buffer where all fit, else as many as fit, 2 at least.
    Raises ValueError where the card cannot take the shape (more CTAs than
    SMs, or the shared memory). Pure: the CPU tests reach it."""
    if n_b % 16 or not 16 <= n_b <= MAX_BATCH or n_h % 16 or n_h < 16:
        raise ValueError(f"no plan: batch {n_b} must be a multiple of 16 up to {MAX_BATCH}, "
                         f"hidden size {n_h} a positive multiple of 16")
    ctas = 4 * n_h // COLS
    if ctas > sm_count:
        raise ValueError(f"no plan: H={n_h} needs {ctas} CTAs of {COLS} columns, one an SM, "
                         f"on a card of {sm_count} SMs")
    atoms = -(-n_h // (_UNIT * _ATOM_K)) * _UNIT
    fixed = _ALIGN + atoms * COLS * 128 + _MAX_ATOMS * 8      # W's slice, the mbarriers
    m_rows = 64 if n_b <= 64 else 128
    stage = m_rows * 128
    stages = min(atoms, (SMEM_LIMIT - fixed) // stage)
    if atoms > _MAX_ATOMS or stages < min(atoms, _MIN_STAGES):
        raise ValueError(f"no plan: W's slice at H={n_h} leaves room for {stages} buffers of "
                         f"h at B={n_b}, fewer than {_MIN_STAGES}")
    return ChainPlan(ctas, COLS, m_rows, stages, int(stages == atoms), fixed + stages * stage)


def kernel_attributes(plan: ChainPlan) -> dict:
    """K8's kernel as built (needs the card): registers a thread, static
    and dynamic shared memory a CTA (the latter the plan's), local memory
    (spills) a thread, columns a CTA, and the plan."""
    lib = _build.load_library()
    out = (ctypes.c_int * 5)()
    _build.check(lib, lib.dsjax_torch_mm_chain_attributes(plan.resident, out),
                 "mm_chain attributes")
    attrs = dict(zip(("registers", "static_smem_bytes", "dynamic_smem_bytes", "local_bytes",
                      "cols"), out))
    attrs.update(dynamic_smem_bytes=plan.smem_bytes, plan=plan._asdict())
    return attrs


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
        # W's rows are read 16 bytes at a time, xp in pairs; 32 bytes as before
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
    plan = chain_plan(n_b, g4 // 4, sm_count(xp.device))
    # slot 0 holds h0; step s reads slot s % 2
    h = torch.empty((2,) + tuple(h0.shape), dtype=h0.dtype, device=h0.device)
    h[0].copy_(h0)
    z = torch.zeros((n_b, g4), dtype=xp.dtype, device=xp.device)
    if n_t == 0:
        return h[0], z
    counter = torch.zeros(1, dtype=torch.int32, device=xp.device)
    lib = _build.load_library()
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dsjax_torch_mm_chain(xp.data_ptr(), w.data_ptr(), h.data_ptr(), z.data_ptr(),
                                       counter.data_ptr(), plan_array(plan), n_t, n_b, g4 // 4,
                                       stream)
    _build.check(lib, err, f"mm_chain launch (K8, cooperative, {plan})")
    with _launch_lock:
        LAUNCHES += 1
    return h[n_t % 2], z
