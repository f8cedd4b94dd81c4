"""Masked LSTM recurrence: the CUDA kernel, its plain version and the wrapper.

Counterpart of dsjax/ops/lstm_pallas.py (forward, no residuals). The input
projections of all time steps are computed outside, as one large matrix
product; this op runs only the sequential half, h_{t-1} . W_hh^T per step.

Every tensor carries a leading direction axis D (1 or 2), so one call, and
one kernel launch sequence, covers both directions of a layer:

  xp    (D, T, B, 4H)  input projections with b_ih added, gate order i, f, g, o
  mask  (T, B) f32     1 where t < length
  w_hh  (D, 4H, H)     recurrent weights in torch's layout (one row per gate
                       column, as the kernel reads them)
  b_hh  (D, 4H)
  h0/c0 (D, B, H)      initial carry
  reverse              D bools: direction d scans time backwards, which
                       equals flipping xp and mask, scanning, and flipping y
                       back (dsjax/model/ds2.py:334-346)

Returns (y (D, T, B, H), h_T (D, B, H), c_T (D, B, H)). The carry freezes
where the mask is 0; y is h' * m computed from the unrounded h'. xp, w_hh,
b_hh, h0 and c0 share one working dtype, float32 or bfloat16; sums and the
cell math run in float32 and the carry is rounded to the working dtype every
step, as in the Pallas kernel.

On CUDA tensors ``lstm_scan`` always launches the kernel in
``csrc/lstm_fwd.cu``; on CPU tensors it runs ``lstm_scan_reference``.
"""

from __future__ import annotations

import threading
from typing import Sequence, Tuple

import torch

from dsjax_torch.ops import _build

Tensor = torch.Tensor

# lstm_scan calls on CUDA tensors so far: one per call of the C entry point,
# which covers every direction of a layer and launches one step kernel per
# time step; STEP_LAUNCHES counts those step kernels
LAUNCHES = 0
STEP_LAUNCHES = 0
_launch_lock = threading.Lock()

# the kernel stages (8, H) f32 rows of h in shared memory and loads 16 bytes
# at a time, so H must be a multiple of 8 and the stage must fit a CTA
MAX_HIDDEN = 4096
DTYPES = (torch.float32, torch.bfloat16)


def _scan_one(xp: Tensor, mask: Tensor, w_hh: Tensor, b_hh: Tensor,
              h: Tensor, c: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """One forward-in-time direction; mirrors lstm_pallas.lstm_scan_reference."""
    dtype = xp.dtype
    w_t = w_hh.t().float()
    b = b_hh.float()
    ys = []
    for t in range(xp.shape[0]):
        gates = xp[t].float() + h.float() @ w_t + b
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = mask[t][:, None].float()
        h = (m * h_new + (1 - m) * h.float()).to(dtype)
        c = (m * c_new + (1 - m) * c.float()).to(dtype)
        ys.append((h_new * m).to(dtype))
    y = torch.stack(ys) if ys else xp.new_zeros((0,) + h.shape)
    return y, h, c


def lstm_scan_reference(xp: Tensor, mask: Tensor, w_hh: Tensor, b_hh: Tensor,
                        h0: Tensor, c0: Tensor, reverse: Sequence[bool]
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the kernel: same contract, a loop over time."""
    ys, hs, cs = [], [], []
    for d, rev in enumerate(reverse):
        x_d, m_d = (xp[d].flip(0), mask.flip(0)) if rev else (xp[d], mask)
        y, h, c = _scan_one(x_d, m_d, w_hh[d], b_hh[d], h0[d], c0[d])
        ys.append(y.flip(0) if rev else y)
        hs.append(h)
        cs.append(c)
    return torch.stack(ys), torch.stack(hs), torch.stack(cs)


def _check(xp: Tensor, mask: Tensor, w_hh: Tensor, b_hh: Tensor, h0: Tensor,
           c0: Tensor, reverse: Sequence[bool]) -> None:
    if xp.dim() != 4:
        raise ValueError(f"xp must be (D, T, B, 4H), got {tuple(xp.shape)}")
    n_dir, n_t, n_b, g4 = xp.shape
    n_h = g4 // 4
    if n_dir not in (1, 2) or len(reverse) != n_dir:
        raise ValueError(f"{n_dir} directions with reverse={tuple(reverse)}")
    if g4 != 4 * n_h or n_h % 8 or n_h > MAX_HIDDEN:
        raise ValueError(f"hidden size {g4 / 4} must be a multiple of 8 "
                         f"and at most {MAX_HIDDEN}")
    if xp.dtype not in DTYPES:
        raise TypeError(f"xp dtype {xp.dtype} is not one of {DTYPES}")
    expect = {"w_hh": (w_hh, (n_dir, g4, n_h), xp.dtype),
              "b_hh": (b_hh, (n_dir, g4), xp.dtype),
              "h0": (h0, (n_dir, n_b, n_h), xp.dtype),
              "c0": (c0, (n_dir, n_b, n_h), xp.dtype),
              "mask": (mask, (n_t, n_b), torch.float32)}
    for name, (t, shape, dtype) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != xp.device:
            raise ValueError(f"{name} is on {t.device}, xp on {xp.device}")
    for name, t in (("xp", xp), ("mask", mask), ("w_hh", w_hh), ("b_hh", b_hh),
                    ("h0", h0), ("c0", c0)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # the kernel reads W_hh rows with 16-byte loads; a misaligned one would
    # fault after the launch returned, where no error check can see it
    if w_hh.data_ptr() % 16:
        raise ValueError("w_hh must start on a 16-byte boundary")


def lstm_scan(xp: Tensor, mask: Tensor, w_hh: Tensor, b_hh: Tensor,
              h0: Tensor, c0: Tensor, reverse: Sequence[bool]
              ) -> Tuple[Tensor, Tensor, Tensor]:
    """Masked LSTM recurrence over time for D directions. See the module
    docstring for the contract."""
    global LAUNCHES, STEP_LAUNCHES
    _check(xp, mask, w_hh, b_hh, h0, c0, reverse)
    if xp.device.type == "cpu":
        return lstm_scan_reference(xp, mask, w_hh, b_hh, h0, c0, reverse)
    if xp.device.type != "cuda":
        raise ValueError(f"lstm_scan runs on cuda or cpu tensors, not {xp.device}")
    n_dir, n_t, n_b, g4 = xp.shape
    n_h = g4 // 4
    # slot 0 holds the carry entering step 0; step s reads slot s % 2
    h = torch.empty((2, n_dir, n_b, n_h), dtype=xp.dtype, device=xp.device)
    c = torch.empty_like(h)
    h[0].copy_(h0)
    c[0].copy_(c0)
    y = torch.empty((n_dir, n_t, n_b, n_h), dtype=xp.dtype, device=xp.device)
    reverse_bits = sum(1 << d for d, rev in enumerate(reverse) if rev)
    lib = _build.load_library()
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dsjax_torch_lstm_fwd(
            xp.data_ptr(), mask.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            h.data_ptr(), c.data_ptr(), y.data_ptr(), n_dir, n_t, n_b, n_h,
            reverse_bits, int(xp.dtype == torch.bfloat16), stream)
    _build.check(lib, err, "lstm_fwd launch")
    with _launch_lock:
        LAUNCHES += 1
        STEP_LAUNCHES += n_t
    return y, h[n_t % 2], c[n_t % 2]
