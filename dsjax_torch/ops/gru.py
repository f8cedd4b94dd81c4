"""Masked GRU recurrence: the CUDA kernels, their plain versions, the wrappers
and the autograd Function that ties them together.

Counterpart of dsjax/ops/gru_pallas.py, with the contract of ``ops/lstm.py``:
the input projections of all time steps are computed outside, as one large
matrix product, and these ops run only the sequential half. Every tensor
carries a leading direction axis D (1 or 2):

  xp    (D, T, B, 3H)  input projections with b_ih added, gate order r, z, n
  mask  (T, B) f32     1 where t < length
  w_hh  (D, 3H, H)     recurrent weights in torch's layout
  b_hh  (D, 3H)
  h0    (D, B, H)      initial carry
  reverse              D bools: direction d scans time backwards

Per step, in float32 (gru_pallas.py:72-87):
  hp = h . W_hh^T + b_hh;  r = sigmoid(xr + hr);  z = sigmoid(xz + hz)
  n  = tanh(xn + r * hn)          (b_hn stays inside the product with r)
  h' = (1 - z) * n + z * h;  h = m * h' + (1 - m) * h  rounded to the working dtype
  y[t] = h' * m                   from the unrounded h'
``gru_scan`` returns (y (D, T, B, H), h_T (D, B, H)).

Three kernels, as in dsjax:
  K4  ``gru_scan_fwd``                 forward without residuals (inference):
      K1's persistent kernel with three gates (csrc/scan_persist.cuh), one
      cooperative launch a layer call, laid out by ``ops.lstm.scan_plan``;
  K4 with residuals  ``gru_scan_fwd(save_residuals=True)``, the forward of
      training, which also writes (r, z, n, hn) (D, T, B, 4H) at natural
      time t (csrc/gru_fwd.cu, on the step product of csrc/scan_mma.cuh);
  K5  ``gru_scan_bwd``                 the reverse scan: dxp (D, T, B, 3H),
      dh0 (csrc/gru_bwd.cu, on the step product of csrc/scan_mma.cuh that
      K3 runs too).
``gru_scan`` takes the autograd Function ``GRUScan`` only when autograd will
differentiate the call; it runs K4 with residuals, then K5, and reduces dW
and db outside the kernel from dhp = [dxp_rz, dxp_n * r] in float32, as
dsjax's custom VJP does (gru_pallas.py:300-325). On CUDA tensors the
wrappers always launch their kernel; on CPU tensors they run the plain
versions ``gru_scan_reference`` and ``gru_scan_backward_reference``.

K5 takes the carried h_prev (D, T, B, H), the h that enters each step,
computed once outside (``ops.lstm._carried_h_prev``, which dW needs too).
dsjax's Pallas backward reads the masked output y instead
(gru_pallas.py:192); before the first valid step of a suffix mask with a
nonzero carry that is 0, not h0, and its gradients are wrong there. The
two agree wherever dsjax's kernel is right (tests/test_torch_gru_grad.py).
"""

from __future__ import annotations

import threading
from typing import Sequence, Tuple

import torch

from dsjax_torch.ops import _build
from dsjax_torch.ops._card import plan_array, sm_count
from dsjax_torch.ops.lstm import (ScanPlan, _carried_h_prev, _flip, _reverse_bits,
                                  check_aligned, check_pairs, check_reverse_scan, check_scan,
                                  persistent_attributes, scan_plan, wide_pass)

Tensor = torch.Tensor

# wrapper calls on CUDA tensors so far, one per call of a C entry point,
# which covers every direction of a layer: LAUNCHES for K4 (one kernel
# launch a call with n_t > 0, none at n_t = 0; STEPS counts the time steps
# those calls scanned; of those, WIDE_PASS_LAUNCHES the f32 calls whose
# plan takes more than 8 batch rows a pass), RESIDUAL_LAUNCHES for K4 with
# residuals, BWD_LAUNCHES for K5
LAUNCHES = 0
STEPS = 0
WIDE_PASS_LAUNCHES = 0
RESIDUAL_LAUNCHES = 0
BWD_LAUNCHES = 0
_launch_lock = threading.Lock()


def _scan_one(xp: Tensor, mask: Tensor, w_hh: Tensor, b_hh: Tensor, h: Tensor,
              save_residuals: bool):
    """One forward-in-time direction; mirrors gru_pallas.gru_scan_reference
    and, when saving, the residual writes of gru_pallas._fwd_kernel."""
    dtype = xp.dtype
    w_t = w_hh.t().float()
    b = b_hh.float()
    ys, gs = [], []
    for t in range(xp.shape[0]):
        hp = h.float() @ w_t + b
        xr, xz, xn = xp[t].float().chunk(3, dim=-1)
        hr, hz, hn = hp.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1 - z) * n + z * h.float()
        m = mask[t][:, None].float()
        h = (m * h_new + (1 - m) * h.float()).to(dtype)
        ys.append((h_new * m).to(dtype))
        if save_residuals:
            gs.append(torch.cat([r, z, n, hn], dim=-1).to(dtype))
    y = torch.stack(ys) if ys else xp.new_zeros((0,) + h.shape)
    if not save_residuals:
        return y, h
    g_seq = torch.stack(gs) if gs else xp.new_zeros((0,) + h.shape[:-1] + (4 * h.shape[-1],))
    return y, h, g_seq


def gru_scan_reference(xp: Tensor, mask: Tensor, w_hh: Tensor, b_hh: Tensor, h0: Tensor,
                       reverse: Sequence[bool], save_residuals: bool = False
                       ) -> Tuple[Tensor, ...]:
    """Plain PyTorch version of K4 (and, with ``save_residuals``, of K4 with
    residuals): same contract, a loop over time. With ``save_residuals`` it
    also returns (r, z, n, hn) (D, T, B, 4H) at natural time. Autograd can
    differentiate it."""
    outs = []
    for d, rev in enumerate(reverse):
        out = _scan_one(_flip(xp[d], rev), _flip(mask, rev), w_hh[d], b_hh[d], h0[d],
                        save_residuals)
        outs.append((_flip(out[0], rev), out[1]) + tuple(_flip(r, rev) for r in out[2:]))
    return tuple(torch.stack(parts) for parts in zip(*outs))


def _bwd_one(g_seq: Tensor, mask: Tensor, w_hh: Tensor, h_prev: Tensor, dy: Tensor,
             dh: Tensor) -> Tuple[Tensor, Tensor]:
    """One forward-in-time direction in reverse; mirrors gru_pallas._bwd_kernel
    with the carried h_prev in place of y."""
    dtype = g_seq.dtype
    w = w_hh.float()
    dh = dh.float()
    dxs = [None] * g_seq.shape[0]
    for t in reversed(range(g_seq.shape[0])):
        r, z, n, hn = g_seq[t].float().chunk(4, dim=-1)
        m = mask[t][:, None].float()
        dh_acc = dh + dy[t].float() * m
        dh_new = dh_acc * m
        dz = dh_new * (h_prev[t].float() - n)
        dn = dh_new * (1 - z)
        dn_pre = dn * (1 - n * n)
        dr_pre = (dn_pre * hn) * r * (1 - r)
        dz_pre = dz * z * (1 - z)
        dxs[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1).to(dtype)
        # the h-side gradients, each rounded to the working dtype before the
        # product with W_hh (gru_pallas.py:225-229): the n block is dn_pre * r
        dg = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=-1).to(dtype)
        dh = dh_new * z + dg.float() @ w + dh_acc * (1 - m)
    dxp = torch.stack(dxs) if dxs else g_seq.new_zeros(g_seq.shape[:-1] + (3 * dh.shape[-1],))
    return dxp, dh.to(dtype)


def gru_scan_backward_reference(g_seq: Tensor, mask: Tensor, w_hh: Tensor, h_prev: Tensor,
                                dy: Tensor, dh_t: Tensor, reverse: Sequence[bool]
                                ) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of K5: the residuals (r, z, n, hn) that K4 saved,
    the carried h_prev (D, T, B, H), the cotangents dy (D, T, B, H) and dh_T
    (D, B, H), all in the working dtype -> (dxp (D, T, B, 3H), dh0 (D, B, H)).
    dh runs in float32."""
    outs = []
    for d, rev in enumerate(reverse):
        dxp, dh0 = _bwd_one(_flip(g_seq[d], rev), _flip(mask, rev), w_hh[d],
                            _flip(h_prev[d], rev), _flip(dy[d], rev), dh_t[d])
        outs.append((_flip(dxp, rev), dh0))
    return tuple(torch.stack(parts) for parts in zip(*outs))


def gru_scan_fwd(xp: Tensor, mask: Tensor, w_hh: Tensor, b_hh: Tensor, h0: Tensor,
                 reverse: Sequence[bool], save_residuals: bool = False
                 ) -> Tuple[Tensor, ...]:
    """The forward scan: K4, or K4 with residuals (then also (r, z, n, hn)).
    Inputs as ``ops.lstm.check_scan`` takes them; with residuals also xp and
    b_hh on a boundary of two elements (``ops.lstm.check_pairs``, on every
    device), and K4 on a CUDA tensor xp on a 16-byte boundary. K4 is one
    cooperative launch of ``scan_plan``'s grid; where the card cannot hold
    that grid at once (another process holding SMs) it raises."""
    global LAUNCHES, STEPS, RESIDUAL_LAUNCHES, WIDE_PASS_LAUNCHES
    if save_residuals:
        check_pairs({"xp": xp, "b_hh": b_hh})
    if xp.device.type == "cpu":
        return gru_scan_reference(xp, mask, w_hh, b_hh, h0, reverse,
                                  save_residuals=save_residuals)
    n_dir, n_t, n_b, g3 = xp.shape
    n_h = g3 // 3
    plan = None
    if not save_residuals:
        check_aligned("xp", xp)
        plan = scan_plan(n_dir, n_h, 3, xp.dtype, n_b, sm_count(xp.device))
    # slot 0 holds the carry entering step 0; step s reads slot s % 2
    h = torch.empty((2, n_dir, n_b, n_h), dtype=xp.dtype, device=xp.device)
    h[0].copy_(h0)
    y = torch.empty((n_dir, n_t, n_b, n_h), dtype=xp.dtype, device=xp.device)
    g_seq = (torch.empty((n_dir, n_t, n_b, 4 * n_h), dtype=xp.dtype, device=xp.device)
             if save_residuals else None)
    if n_t == 0 and not save_residuals:
        return y, h[0]
    # arrivals at each direction's barrier between steps (K4)
    counters = None if save_residuals else torch.zeros(n_dir, dtype=torch.int32,
                                                       device=xp.device)
    lib = _build.load_library()
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dsjax_torch_gru_fwd(
            xp.data_ptr(), mask.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), h.data_ptr(),
            y.data_ptr(), g_seq.data_ptr() if save_residuals else None, n_dir, n_t, n_b, n_h,
            _reverse_bits(reverse), int(xp.dtype == torch.bfloat16), stream,
            None if plan is None else plan_array(plan),
            None if counters is None else counters.data_ptr())
    _build.check(lib, err, "gru_fwd launch" if save_residuals else
                 f"gru_fwd launch (K4, cooperative, {plan})")
    with _launch_lock:
        if save_residuals:
            RESIDUAL_LAUNCHES += 1
        else:
            LAUNCHES += 1
            STEPS += n_t
            WIDE_PASS_LAUNCHES += wide_pass(plan, xp.dtype)
    out = (y, h[n_t % 2])
    return out + (g_seq,) if save_residuals else out


def check_scan_bwd(g_seq: Tensor, mask: Tensor, w_hh: Tensor, h_prev: Tensor,
                   cotangents: Sequence[Tensor], reverse: Sequence[bool]) -> None:
    """Raise on what K5 does not take (``ops.lstm.check_reverse_scan``):
    w_hh (D, 3H, H), h_prev (D, T, B, H) and the cotangents dy, dh_T beside
    g_seq."""
    dy, dh_t = cotangents
    check_reverse_scan("gru_scan_bwd", g_seq, mask, w_hh, 3, reverse,
                       {"h_prev": h_prev, "dy": dy}, {"dh_T": dh_t})


def gru_scan_bwd(g_seq: Tensor, mask: Tensor, w_hh: Tensor, h_prev: Tensor, dy: Tensor,
                 dh_t: Tensor, reverse: Sequence[bool]) -> Tuple[Tensor, Tensor]:
    """The reverse scan, K5: the contract of ``gru_scan_backward_reference``.
    The residuals come from ``gru_scan_fwd(save_residuals=True)``; the
    cotangents and h_prev are cast to the working dtype and made contiguous
    here, then ``check_scan_bwd`` checks K5's inputs on every device. The
    two operands of its step product, W_hh^T and the exchanged dG, must
    start on 16-byte boundaries: they are tensors this wrapper allocates,
    which the allocator aligns further."""
    global BWD_LAUNCHES
    dtype = g_seq.dtype
    dy, dh_t, h_prev = (a.to(dtype).contiguous() for a in (dy, dh_t, h_prev))
    check_scan_bwd(g_seq, mask, w_hh, h_prev, (dy, dh_t), reverse)
    if g_seq.device.type == "cpu":
        return gru_scan_backward_reference(g_seq, mask, w_hh, h_prev, dy, dh_t, reverse)
    n_dir, n_t, n_b, g4 = g_seq.shape
    n_h = g4 // 4
    w_t = w_hh.transpose(1, 2).contiguous()          # (D, H, 3H): a unit's weights per row
    dxp = torch.empty((n_dir, n_t, n_b, 3 * n_h), dtype=dtype, device=g_seq.device)
    # the h-side gradients (dr_pre, dz_pre, dn_pre * r) that steps exchange,
    # double-buffered by launch parity
    exchange = torch.empty((2, n_dir, n_b, 3 * n_h), dtype=dtype, device=g_seq.device)
    dh_rest = dh_t.to(torch.float32, copy=True)      # the kernel's f32 carry, overwritten
    dh0 = torch.empty_like(dh_t)
    lib = _build.load_library()
    with torch.cuda.device(g_seq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dsjax_torch_gru_bwd(
            g_seq.data_ptr(), mask.data_ptr(), w_t.data_ptr(), h_prev.data_ptr(),
            dy.data_ptr(), dxp.data_ptr(), exchange.data_ptr(), dh_rest.data_ptr(),
            dh0.data_ptr(), n_dir, n_t, n_b, n_h, _reverse_bits(reverse),
            int(dtype == torch.bfloat16), stream)
    _build.check(lib, err, "gru_bwd launch")
    with _launch_lock:
        BWD_LAUNCHES += 1
    return dxp, dh0


def fwd_kernel_attributes(dtype: torch.dtype) -> dict:
    """K4 with residuals' step kernel for ``dtype`` as built (needs the
    card): registers a thread, static and dynamic shared memory a CTA, local
    memory (spills) a thread, and the hidden units a CTA owns."""
    return _build.kernel_attributes("dsjax_torch_gru_fwd_attributes", dtype == torch.bfloat16)


def scan_kernel_attributes(dtype: torch.dtype, plan: ScanPlan) -> dict:
    """K4's persistent kernel for ``dtype`` as built under ``plan`` (needs
    the card), as ``ops.lstm.persistent_attributes`` gives it."""
    return persistent_attributes("dsjax_torch_gru_scan_attributes", dtype, plan)


def bwd_kernel_attributes(dtype: torch.dtype) -> dict:
    """K5's step kernel for ``dtype`` as built (needs the card): registers a
    thread, static and dynamic shared memory a CTA, local memory (spills) a
    thread, and the hidden units a CTA owns."""
    return _build.kernel_attributes("dsjax_torch_gru_bwd_attributes", dtype == torch.bfloat16)


def gru_param_grads(dxp: Tensor, g_seq: Tensor, h_prev: Tensor) -> Tuple[Tensor, Tensor]:
    """dW_hh (D, 3H, H) and db_hh (D, 3H) in float32, reduced outside the
    kernel as dsjax does (gru_pallas.py:308-323): the h-side gate gradients
    dhp = [dxp_r, dxp_z, dxp_n * r] in float32, then dW = dhp^T . h_prev over
    all T * B rows, one product per direction."""
    n_dir, n_t, n_b, g3 = dxp.shape
    n_h = g3 // 3
    dhp = torch.cat([dxp[..., :2 * n_h].float(),
                     dxp[..., 2 * n_h:].float() * g_seq[..., :n_h].float()], dim=-1)
    dw = torch.matmul(dhp.reshape(n_dir, n_t * n_b, g3).transpose(1, 2),
                      h_prev.reshape(n_dir, n_t * n_b, n_h).float())
    return dw, dhp.sum(dim=(1, 2))


class GRUScan(torch.autograd.Function):
    """``gru_scan`` under autograd: K4 with residuals, the K5 reverse scan,
    and dW, db reduced outside the kernel (dsjax's gru_scan custom VJP)."""

    @staticmethod
    def forward(ctx, xp, mask, w_hh, b_hh, h0, reverse):
        y, h_t, g_seq = gru_scan_fwd(xp, mask, w_hh, b_hh, h0, reverse, save_residuals=True)
        ctx.save_for_backward(g_seq, mask, w_hh, h0, y)
        ctx.reverse = reverse
        return y, h_t

    @staticmethod
    def backward(ctx, dy, dh_t):
        # the model never uses h_T in its loss: autograd materializes its
        # cotangent as zeros
        g_seq, mask, w_hh, h0, y = ctx.saved_tensors
        h_prev = _carried_h_prev(y, mask, h0, ctx.reverse)
        dxp, dh0 = gru_scan_bwd(g_seq, mask, w_hh, h_prev, dy, dh_t, ctx.reverse)
        dw, db = gru_param_grads(dxp, g_seq, h_prev)
        return dxp, None, dw.to(w_hh.dtype), db.to(w_hh.dtype), dh0, None


def gru_scan(xp: Tensor, mask: Tensor, w_hh: Tensor, b_hh: Tensor, h0: Tensor,
             reverse: Sequence[bool]) -> Tuple[Tensor, Tensor]:
    """Masked GRU recurrence over time for D directions. See the module
    docstring for the contract. Differentiable: a call autograd will
    differentiate saves residuals for the reverse scan (K5); any other call
    (eval, serving) runs K4 and writes none."""
    check_scan(xp, mask, w_hh, b_hh, (h0,), reverse, 3, "gru_scan")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xp, w_hh, b_hh, h0)):
        return GRUScan.apply(xp, mask, w_hh, b_hh, h0, tuple(reverse))
    return gru_scan_fwd(xp, mask, w_hh, b_hh, h0, reverse)
