"""Masked LSTM recurrence: the CUDA kernels, their plain versions, the wrappers
and the autograd Function that ties them together.

Counterpart of dsjax/ops/lstm_pallas.py. The input projections of all time
steps are computed outside, as one large matrix product; these ops run only
the sequential half, h_{t-1} . W_hh^T per step, and its reverse.

Every tensor carries a leading direction axis D (1 or 2), so one call, and
one kernel launch sequence, covers both directions of a layer:

  xp    (D, T, B, 4H)  input projections with b_ih added, gate order i, f, g, o
  mask  (T, B) f32     1 where t < length
  w_hh  (D, 4H, H)     recurrent weights in torch's layout (one row per gate
                       column, as the forward kernel reads them)
  b_hh  (D, 4H)
  h0/c0 (D, B, H)      initial carry
  reverse              D bools: direction d scans time backwards, which
                       equals flipping xp and mask, scanning, and flipping y
                       back (dsjax/model/ds2.py:334-346)

``lstm_scan`` returns (y (D, T, B, H), h_T (D, B, H), c_T (D, B, H)). The
carry freezes where the mask is 0; y is h' * m computed from the unrounded
h'. xp, w_hh, b_hh, h0 and c0 share one working dtype, float32 or bfloat16;
sums and the cell math run in float32 and the carry is rounded to the
working dtype every step, as in the Pallas kernels.

Three kernels, as in dsjax:
  K1  ``lstm_scan_fwd``       forward without residuals (inference): one
      persistent cooperative launch a layer call (csrc/scan_persist.cuh,
      shared with the GRU's K4), laid out by ``scan_plan``;
  K2  ``lstm_scan_fwd(save_residuals=True)``  the forward of training, which
      also writes the post-activation gates (D, T, B, 4H) and the kept carry
      c (D, T, B, H), both at natural time t (csrc/lstm_fwd.cu, on the step
      product of csrc/scan_mma.cuh that K3 runs too);
  K3  ``lstm_scan_bwd``       the reverse scan: dgates (= dxp), dh0, dc0
      (csrc/lstm_bwd.cu): in bf16 one cooperative launch a layer call with
      W_hh^T resident and the step's dgates split over a thread block
      cluster, laid out by ``bwd_plan``; else (f32, larger H or B) one
      launch a scan step.
``lstm_scan`` is the op: a call that autograd will differentiate (grad mode
on and an input requiring grad) goes through ``LSTMScan``, which runs K2 then
K3 and reduces dW and db outside the kernel, as dsjax's custom VJP does
(lstm_pallas.py:367-416); any other call runs K1 and writes no residuals.
On CUDA tensors the wrappers always launch their kernel; on CPU tensors they
run the plain versions ``lstm_scan_reference`` and
``lstm_scan_backward_reference``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from dsjax_torch.ops import _build
from dsjax_torch.ops._card import SMEM_LIMIT, plan_array, sm_count

Tensor = torch.Tensor

# wrapper calls on CUDA tensors so far, one per call of a C entry point,
# which covers every direction of a layer: LAUNCHES for K1 (one kernel
# launch a call with n_t > 0, none at n_t = 0; STEPS counts the time steps
# those calls scanned; of those, WIDE_PASS_LAUNCHES the f32 calls whose
# plan takes more than 8 batch rows a pass), RESIDUAL_LAUNCHES for K2,
# BWD_LAUNCHES for K3, and of those BWD_RESIDENT_LAUNCHES the calls that
# took K3's resident route (``bwd_plan``: one kernel launch a call)
LAUNCHES = 0
STEPS = 0
WIDE_PASS_LAUNCHES = 0
RESIDUAL_LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_RESIDENT_LAUNCHES = 0
_launch_lock = threading.Lock()

# the kernels copy 16 bytes at a time, so H must be a multiple of 8; up to
# MAX_HIDDEN, ``scan_plan`` finds a layout for K1 and K4 on 132 SMs
MAX_HIDDEN = 4096
DTYPES = (torch.float32, torch.bfloat16)

# what scan_persist.cuh takes: column tiles of 8 units (one a warp), ring
# stages, chunk widths in bytes; register rows (f32): the last gate's rows of
# a CTA of 16 units, at most 4096 bytes of each (H <= 1024), read in
# 1024-byte chunks up to 12 rows a pass and in 512-byte chunks at 16 and 20;
# batch rows a pass: bf16 16 (one m16 tile), f32 8 or a wide pass of 12, 16
# or 20 (the kernel's builds)
_WARPS = 8
_MAX_STAGES = 5
_CHUNK_BYTES = (2048, 1024, 512, 256, 128, 64, 32)
_REG_UNITS, _REG_BYTES = 16, 4096
_BF16_ROWS = 16
_F32_ROWS = (8, 12, 16, 20)
_BAR_BYTES = 48   # a wide pass's mbarriers, one a ring stage
_TMA_ALIGN = 128  # where a wide pass's ring starts


def _reg_chunk(rows: int) -> int:
    return 1024 if rows <= 12 else 512


class ScanPlan(NamedTuple):
    """The layout of K1's and K4's persistent kernel (csrc/scan_persist.cuh,
    ``persist::Plan``, in this order): hidden units a CTA, CTAs a direction,
    the W_hh rows a CTA keeps in shared memory, those it streams from L2
    each step and those it keeps in registers, ring stages, the ring's chunk
    of a row in bytes, the shared memory a CTA, and the batch rows a pass
    (the step product's rows at once)."""

    units: int
    ctas: int
    resident_rows: int
    streamed_rows: int
    register_rows: int
    stages: int
    chunk_bytes: int
    smem_bytes: int
    pass_rows: int


def _plan_smem(gates: int, esize: int, n_h: int, n_b: int, units: int, resident: int,
               streamed: int, stages: int, chunk: int, rows: int) -> int:
    """Shared memory a CTA, as ``persist::layout`` sums it: resident rows,
    the ring (each stage a chunk of the pass's h rows and of the streamed
    rows, each row padded by 16 bytes), the K splits' partial sums, xp's
    columns, the mask, b_hh's columns, and the h (and c) of the CTA's own
    units for every batch row. A wide f32 pass (more than 8 rows) starts
    its ring's stages on 128 bytes, leaves its rows unpadded (tensor copies
    write them), keeps its partial sums over the ring and adds the ring's
    mbarriers. The register rows take none."""
    cols, tiles = gates * units, units // 8
    r16 = lambda x: -(-x // 16) * 16
    n_state = 2 if gates == 4 else 1
    wide = esize == 4 and rows > 8
    r128 = lambda x: -(-x // _TMA_ALIGN) * _TMA_ALIGN
    ring = stages * (r128((rows + streamed) * chunk) if wide else (rows + streamed) * (chunk + 16))
    part = (_WARPS // tiles) * rows * cols * 4
    resident_bytes = resident * (n_h * esize + 16)
    if wide:
        resident_bytes = r128(resident_bytes)
    return (resident_bytes + (max(ring, part) if wide else ring + part)
            + r16(rows * cols * esize) + r16(rows * 4) + r16(cols * 4)
            + n_state * n_b * units * 4 + (_BAR_BYTES if wide else 0))


def scan_plan(n_dir: int, n_h: int, gates: int, dtype: torch.dtype, n_b: int,
              sm_count: int) -> ScanPlan:
    """The persistent scan's plan for D directions of H units with G gates
    (4 LSTM, 3 GRU) at batch B on a card of ``sm_count`` SMs, one CTA an SM:
    units a CTA the least multiple of 8 with D * ceil(H / units) <= SMs;
    every W_hh row resident where all fit a CTA, with the ring's chunk and
    stages that keep the most bytes of h in flight (then the fewest
    chunks; a wide f32 pass the fewest chunks first). Else, in f32 at 16
    units a CTA and H <= 1024, the last gate's 16 rows in registers and the
    others resident as above (in 1024-byte chunks up to 12 rows a pass,
    512-byte ones at 16 and 20), or as many as fit beside a 2-stage ring;
    else as many rows as fit beside a 2-stage ring of 512-byte chunks
    (narrower where that does not fit). What is not kept is streamed. Rows a pass: 16 in bf16; in f32 8 up to B = 8, and
    past it, of the row counts the kernel is built for, the plan that
    streams the fewest W_hh rows, then takes the fewest passes, then the
    fewest rows a pass. Raises ValueError where no plan fits (more than 8
    column tiles of 8 units a CTA, or the shared memory). Pure: the CPU
    tests reach it."""
    if dtype not in DTYPES:
        raise TypeError(f"dtype {dtype} is not one of {DTYPES}")
    if n_h <= 0 or n_h % 8:
        raise ValueError(f"hidden size {n_h} must be a positive multiple of 8")
    if n_dir < 1 or sm_count < n_dir:
        raise ValueError(f"no plan: {n_dir} directions on {sm_count} SMs")
    units = 8 * -(-n_h // (8 * (sm_count // n_dir)))
    if units // 8 > _WARPS:
        raise ValueError(f"no plan: {units} units a CTA ({n_dir} directions of {n_h} on "
                         f"{sm_count} SMs) pass {_WARPS} column tiles of 8")
    esize = 2 if dtype == torch.bfloat16 else 4
    if esize == 2:
        found = [_plan_at(n_h, gates, esize, n_b, units, _BF16_ROWS)]
    elif n_b <= _F32_ROWS[0]:
        found = [_plan_at(n_h, gates, esize, n_b, units, _F32_ROWS[0])]
    else:
        found = [_plan_at(n_h, gates, esize, n_b, units, rows) for rows in _F32_ROWS]
    found = [p for p in found if p is not None]
    if not found:
        raise ValueError(f"no plan: {n_dir} x H={n_h} with {gates} gates at B={n_b} in "
                         f"{dtype} does not fit {SMEM_LIMIT} bytes of shared memory a CTA")
    return min(found, key=lambda p: (p.streamed_rows, -(-n_b // p.pass_rows), p.pass_rows))


def _plan_at(n_h: int, gates: int, esize: int, n_b: int, units: int,
             rows: int) -> Optional[ScanPlan]:
    """``scan_plan``'s layout at ``rows`` batch rows a pass, or None where
    none fits."""
    cols, row_bytes = gates * units, n_h * esize
    row32 = -(-row_bytes // 32) * 32
    wide = esize == 4 and rows > 8

    def plan(r, reg, st, ch):
        streamed = cols - reg - r
        return ScanPlan(units, -(-n_h // units), r, streamed, reg, st, ch,
                        _plan_smem(gates, esize, n_h, n_b, units, r, streamed, st, ch, rows),
                        rows)

    def resident_all(reg, chunks):
        # every row not in registers resident: the chunk and stages that
        # keep the most bytes of h in flight, then the fewest chunks (a
        # single chunk takes one stage); a wide pass takes the fewest
        # chunks first (each chunk costs the CTA a barrier and a wait)
        fits = []
        for chunk in chunks:
            chunk = min(chunk, row32)
            n_chunks = -(-row_bytes // chunk)
            for stages in range(1 if n_chunks == 1 else 2, _MAX_STAGES + 1):
                ahead = min(max(1, stages - 1), n_chunks)
                if plan(cols - reg, reg, stages, chunk).smem_bytes <= SMEM_LIMIT:
                    key = (-ahead * chunk, n_chunks)
                    fits.append((key[::-1] if wide else key) + (stages, chunk))
        return plan(cols - reg, reg, *min(fits)[2:]) if fits else None

    def resident_most(reg, chunk):
        # as many rows resident as fit beside a 2-stage ring, or None; a
        # row moved from the ring saves its 2 chunks there (the partial
        # sums over the ring can take some of that back)
        streamed_all = plan(0, reg, 2, chunk).smem_bytes
        per_row = n_h * esize + 16 - 2 * (chunk + 16)
        if streamed_all > SMEM_LIMIT or per_row <= 0:
            return None
        r = min(cols - reg, (SMEM_LIMIT - streamed_all) // per_row)
        while plan(r, reg, 2, chunk).smem_bytes > SMEM_LIMIT:
            r -= 1
        return plan(r, reg, 2, chunk)

    found = resident_all(0, _CHUNK_BYTES[1:] if wide else _CHUNK_BYTES)   # a box: 1024 bytes
    reg_chunk = _reg_chunk(rows)
    if found is None and (esize == 4 and units == _REG_UNITS
                          and reg_chunk <= row32 and row_bytes <= _REG_BYTES):
        found = resident_all(_REG_UNITS, (reg_chunk,)) or resident_most(_REG_UNITS, reg_chunk)
    for chunk in _CHUNK_BYTES[_CHUNK_BYTES.index(512):]:
        if found is None:
            found = resident_most(0, min(chunk, row32))
    return found


# The resident route's layout is laid out here alone; csrc/lstm_bwd.cu
# builds a kernel for each (cluster size, units a CTA) of BWD_SHAPES and
# checks a plan only for what its memory and co-residency need
# (resident::fits). The pairs in the order of preference (16 units, 20
# where an H100 holds too few clusters of 16-unit CTAs), dgates in K atoms
# of 64 bf16 (one 128-byte row), B in one or two 64-row tiles (the kernel's
# kMaxTiles), rows of partial sums padded by 8 floats (its kPad), a
# 1024-byte alignment pad, an 8-byte mbarrier a buffer
BWD_UNITS = 16
BWD_SHAPES = ((8, 16), (8, 20), (4, 16), (4, 20), (2, 16), (1, 16))
_BWD_MAX_TILES = 2
_ATOM_K = 64
_BWD_PAD = 8
_ALIGN = 1024


class BwdPlan(NamedTuple):
    """K3's route and layout (csrc/lstm_bwd.cu ``resident::Plan``, in this
    order): the route (1 the resident kernel, one cooperative launch a call;
    0 the per-step kernel, T + 1 launches), hidden units a CTA, 64-row tiles
    of the batch, the cluster size, CTAs in all and a direction, K atoms of
    64 of the 4H columns and the most a CTA owns, dgates buffers of one atom
    a CTA, and the dynamic shared memory a CTA. The per-step route keeps
    only its units, tiles and CTAs (cluster 1, the rest 0)."""

    route: int
    units: int
    tiles: int
    cluster: int
    ctas: int
    ctas_per_dir: int
    atoms: int
    atoms_per_cta: int
    stages: int
    smem_bytes: int


def bwd_layout(n_dir: int, n_h: int, n_b: int, sm_count: int, cluster: int,
               units: int = BWD_UNITS) -> Optional[BwdPlan]:
    """The resident route's layout with clusters of ``cluster`` CTAs of
    ``units`` units, or None where it does not fit: ceil(H / units) CTAs a
    direction rounded up to whole clusters, at most ``sm_count`` in all;
    each CTA of a cluster one slice of the ceil(4H / 64) K atoms, none
    empty; W_hh^T's rows of the cluster's N = C x units over the slice (N x
    128 bytes an atom) and the dgates buffers (64 rows x 128 bytes a tile,
    every atom of the slice where they fit, 2 at least) within the shared
    memory a CTA may take, the buffers large enough for the CTA's partial
    sums (64 rows a tile of N + 8 floats). Pure."""
    tiles = -(-n_b // 64)
    ctas_dir = -(-(-(-n_h // units)) // cluster) * cluster
    atoms = -(-4 * n_h // _ATOM_K)
    atoms_cta = -(-atoms // cluster)
    n = cluster * units
    w_bytes = atoms_cta * n * 128
    stage = 64 * tiles * 128
    stages = min(atoms_cta, (SMEM_LIMIT - _ALIGN - w_bytes) // (stage + 8))
    if not (1 <= tiles <= _BWD_MAX_TILES and n_dir * ctas_dir <= sm_count
            and (cluster - 1) * atoms_cta < atoms and stages >= min(atoms_cta, 2)
            and stages * stage >= 64 * tiles * (n + _BWD_PAD) * 4):
        return None
    return BwdPlan(1, units, tiles, cluster, n_dir * ctas_dir, ctas_dir, atoms, atoms_cta,
                   stages, _ALIGN + w_bytes + stages * (stage + 8))


def bwd_plan(dtype: torch.dtype, n_dir: int, n_h: int, n_b: int, sm_count: int,
             active_clusters: Optional[Mapping[Tuple[int, int], int]] = None) -> BwdPlan:
    """K3's route for D directions of H units at batch B in ``dtype`` on a
    card of ``sm_count`` SMs: in bf16 the resident route, with the first
    (cluster size, units) of ``BWD_SHAPES`` whose ``bwd_layout`` fits and
    whose clusters are all co-resident, ``active_clusters[(C, units)]``
    being how many clusters the card holds at once under that layout
    (cudaOccupancyMaxActiveClusters; sm_count // C where not given); else
    (f32, no layout fits, or none co-resident) the per-step kernel. The
    choice depends on the dtype and shapes alone. Pure: the CPU tests reach
    it."""
    if dtype not in DTYPES:
        raise TypeError(f"dtype {dtype} is not one of {DTYPES}")
    if dtype == torch.bfloat16:
        for cluster, units in BWD_SHAPES:
            plan = bwd_layout(n_dir, n_h, n_b, sm_count, cluster, units)
            if plan is None:
                continue
            active = (sm_count // cluster if active_clusters is None
                      else active_clusters.get((cluster, units), 0))
            if active * cluster >= plan.ctas:
                return plan
    ctas_dir = -(-n_h // BWD_UNITS)
    return BwdPlan(0, BWD_UNITS, -(-n_b // 64), 1, n_dir * ctas_dir, ctas_dir, 0, 0, 0, 0)


def card_bwd_plan(dtype: torch.dtype, n_dir: int, n_h: int, n_b: int,
                  device: torch.device) -> BwdPlan:
    """``bwd_plan`` on the card of ``device`` (needs it in bf16): its SM
    count and the clusters of each layout it holds at once."""
    sms = sm_count(device)
    active = (_active_clusters(device, n_dir, n_h, n_b, sms)
              if dtype == torch.bfloat16 else None)
    return bwd_plan(dtype, n_dir, n_h, n_b, sms, active)


_active_cache: dict = {}


def _active_clusters(device: torch.device, n_dir: int, n_h: int, n_b: int, sms: int) -> dict:
    """For each (cluster size, units) whose ``bwd_layout`` fits, the
    clusters of the resident kernel under that layout that the card holds
    at once (cached per device and shape)."""
    key = (device.index, n_dir, n_h, n_b)
    if key not in _active_cache:
        lib = _build.load_library()
        found = {}
        for shape in BWD_SHAPES:
            plan = bwd_layout(n_dir, n_h, n_b, sms, *shape)
            if plan is None:
                continue
            out = (ctypes.c_int * 1)()
            _build.check(lib, lib.dsjax_torch_lstm_bwd_clusters(plan_array(plan), out),
                         f"lstm_bwd clusters ({plan})")
            found[shape] = out[0]
        _active_cache[key] = found
    return _active_cache[key]


def _scan_one(xp: Tensor, mask: Tensor, w_hh: Tensor, b_hh: Tensor, h: Tensor,
              c: Tensor, save_residuals: bool):
    """One forward-in-time direction; mirrors lstm_pallas.lstm_scan_reference
    and, when saving, the residual writes of lstm_pallas._fwd_kernel."""
    dtype = xp.dtype
    w_t = w_hh.t().float()
    b = b_hh.float()
    ys, gs, cs = [], [], []
    for t in range(xp.shape[0]):
        z = xp[t].float() + h.float() @ w_t + b
        i, f, g, o = z.chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c_new = f * c.float() + i * g
        h_new = o * torch.tanh(c_new)
        m = mask[t][:, None].float()
        h = (m * h_new + (1 - m) * h.float()).to(dtype)
        c = (m * c_new + (1 - m) * c.float()).to(dtype)
        ys.append((h_new * m).to(dtype))
        if save_residuals:
            gs.append(torch.cat([i, f, g, o], dim=-1).to(dtype))
            cs.append(c)
    y = torch.stack(ys) if ys else xp.new_zeros((0,) + h.shape)
    if not save_residuals:
        return y, h, c
    g_seq = torch.stack(gs) if gs else xp.new_zeros(xp.shape)
    c_seq = torch.stack(cs) if cs else xp.new_zeros((0,) + c.shape)
    return y, h, c, g_seq, c_seq


def _flip(a: Tensor, rev: bool) -> Tensor:
    return a.flip(0) if rev else a


def lstm_scan_reference(xp: Tensor, mask: Tensor, w_hh: Tensor, b_hh: Tensor,
                        h0: Tensor, c0: Tensor, reverse: Sequence[bool],
                        save_residuals: bool = False) -> Tuple[Tensor, ...]:
    """Plain PyTorch version of K1 (and, with ``save_residuals``, of K2):
    same contract, a loop over time. With ``save_residuals`` it also returns
    the gates (D, T, B, 4H) and the kept carry c (D, T, B, H), both at
    natural time. Autograd can differentiate it."""
    outs = []
    for d, rev in enumerate(reverse):
        out = _scan_one(_flip(xp[d], rev), _flip(mask, rev), w_hh[d], b_hh[d], h0[d],
                        c0[d], save_residuals)
        outs.append((_flip(out[0], rev), out[1], out[2])
                    + tuple(_flip(r, rev) for r in out[3:]))
    return tuple(torch.stack(parts) for parts in zip(*outs))


def _bwd_one(g_seq: Tensor, mask: Tensor, w_hh: Tensor, c0: Tensor, c_seq: Tensor,
             dy: Tensor, dh: Tensor, dc: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """One forward-in-time direction in reverse; mirrors lstm_pallas._bwd_kernel."""
    dtype = g_seq.dtype
    w = w_hh.float()
    dh, dc = dh.float(), dc.float()
    dgs = [None] * g_seq.shape[0]
    for t in reversed(range(g_seq.shape[0])):
        cp = (c0 if t == 0 else c_seq[t - 1]).float()
        i, f, g, o = g_seq[t].float().chunk(4, dim=-1)
        tc = torch.tanh(f * cp + i * g)
        m = mask[t][:, None].float()
        dh_acc = dh + dy[t].float() * m
        dc_acc = dc
        dh_new, dc_new = dh_acc * m, dc_acc * m
        d_o = dh_new * tc
        dc_t = dc_new + dh_new * o * (1 - tc * tc)
        dg = torch.cat([(dc_t * g) * i * (1 - i), (dc_t * cp) * f * (1 - f),
                        (dc_t * i) * (1 - g * g), d_o * o * (1 - o)], dim=-1).to(dtype)
        dgs[t] = dg
        dh = dg.float() @ w + dh_acc * (1 - m)
        dc = dc_t * f + dc_acc * (1 - m)
    dgates = torch.stack(dgs) if dgs else g_seq.new_zeros(g_seq.shape)
    return dgates, dh.to(dtype), dc.to(dtype)


def lstm_scan_backward_reference(g_seq: Tensor, mask: Tensor, w_hh: Tensor, c0: Tensor,
                                 c_seq: Tensor, dy: Tensor, dh_t: Tensor, dc_t: Tensor,
                                 reverse: Sequence[bool]) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of K3: the gates and kept carry that K2 saved,
    the cotangents dy (D, T, B, H), dh_T and dc_T (D, B, H), all in the
    working dtype -> (dgates (D, T, B, 4H), dh0, dc0 (D, B, H)). dh and dc
    run in float32; dgates are rounded to the working dtype before the
    product with W_hh, as lstm_pallas.py:294-298 does."""
    outs = []
    for d, rev in enumerate(reverse):
        dg, dh0, dc0 = _bwd_one(_flip(g_seq[d], rev), _flip(mask, rev), w_hh[d], c0[d],
                                _flip(c_seq[d], rev), _flip(dy[d], rev), dh_t[d], dc_t[d])
        outs.append((_flip(dg, rev), dh0, dc0))
    return tuple(torch.stack(parts) for parts in zip(*outs))


def check_scan(xp: Tensor, mask: Tensor, w_hh: Tensor, b_hh: Tensor, carry: Sequence[Tensor],
               reverse: Sequence[bool], gates: int, op: str) -> None:
    """Raise on what a scan kernel does not take: xp (D, T, B, G*H) with G
    ``gates`` columns a unit, w_hh (D, G*H, H), b_hh (D, G*H), each carry
    (D, B, H), all in one working dtype; mask (T, B) f32; contiguous, on one
    device, cuda or cpu. Shared by ``lstm_scan`` (G=4) and ``gru_scan`` (G=3)."""
    if xp.dim() != 4:
        raise ValueError(f"xp must be (D, T, B, {gates}H), got {tuple(xp.shape)}")
    n_dir, n_t, n_b, g = xp.shape
    n_h = g // gates
    if n_dir not in (1, 2) or len(reverse) != n_dir:
        raise ValueError(f"{n_dir} directions with reverse={tuple(reverse)}")
    if g != gates * n_h or n_h % 8 or n_h > MAX_HIDDEN:
        raise ValueError(f"hidden size {g / gates} must be a multiple of 8 "
                         f"and at most {MAX_HIDDEN}")
    if xp.dtype not in DTYPES:
        raise TypeError(f"xp dtype {xp.dtype} is not one of {DTYPES}")
    expect = {"w_hh": (w_hh, (n_dir, g, n_h), xp.dtype),
              "b_hh": (b_hh, (n_dir, g), xp.dtype),
              "mask": (mask, (n_t, n_b), torch.float32)}
    expect.update({f"carry {i}": (c, (n_dir, n_b, n_h), xp.dtype) for i, c in enumerate(carry)})
    _check_like("xp", xp, expect, op)
    # the kernels read W_hh rows with 16-byte loads; a misaligned one would
    # fault after the launch returned, where no error check can see it
    if w_hh.data_ptr() % 16:
        raise ValueError("w_hh must start on a 16-byte boundary")


def _check_like(first_name: str, first: Tensor, expect: dict, op: str) -> None:
    """Raise unless each ``expect`` entry, name -> (tensor, shape, dtype),
    has that shape and dtype and lies on ``first``'s device, every tensor is
    contiguous, and the device is cuda or cpu."""
    for name, (t, shape, dtype) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, {first_name} on {first.device}")
    for name, (t, _, _) in [(first_name, (first, None, None))] + list(expect.items()):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if first.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{op} runs on cuda or cpu tensors, not {first.device}")


def check_pairs(tensors: dict) -> None:
    """Raise unless each tensor, name -> tensor, starts on a boundary of two
    elements: the tensor-core scans (K2, K3, K4r, K5) read and write a pair
    of neighbouring units at a time."""
    for name, t in tensors.items():
        if t.data_ptr() % (2 * t.element_size()):
            raise ValueError(f"{name} must start on a boundary of two elements "
                             f"({2 * t.element_size()} bytes)")


def _reverse_bits(reverse: Sequence[bool]) -> int:
    return sum(1 << d for d, rev in enumerate(reverse) if rev)


def lstm_scan_fwd(xp: Tensor, mask: Tensor, w_hh: Tensor, b_hh: Tensor, h0: Tensor,
                  c0: Tensor, reverse: Sequence[bool], save_residuals: bool = False
                  ) -> Tuple[Tensor, ...]:
    """The forward scan: K1, or K2 with ``save_residuals`` (then also the
    gates and the kept carry). Inputs as ``check_scan`` takes them; K2 also
    needs xp and b_hh on a boundary of two elements (``check_pairs``, on
    every device), and K1 on a CUDA tensor xp on a 16-byte boundary. K1 is
    one cooperative launch of ``scan_plan``'s grid; where the card cannot
    hold that grid at once (another process holding SMs) it raises."""
    global LAUNCHES, STEPS, RESIDUAL_LAUNCHES, WIDE_PASS_LAUNCHES
    if save_residuals:
        check_pairs({"xp": xp, "b_hh": b_hh})
    if xp.device.type == "cpu":
        return lstm_scan_reference(xp, mask, w_hh, b_hh, h0, c0, reverse,
                                   save_residuals=save_residuals)
    n_dir, n_t, n_b, g4 = xp.shape
    n_h = g4 // 4
    plan = None
    if not save_residuals:
        check_aligned("xp", xp)
        plan = scan_plan(n_dir, n_h, 4, xp.dtype, n_b, sm_count(xp.device))
    # slot 0 holds the carry entering step 0; step s reads slot s % 2
    h = torch.empty((2, n_dir, n_b, n_h), dtype=xp.dtype, device=xp.device)
    c = torch.empty_like(h)
    h[0].copy_(h0)
    c[0].copy_(c0)
    y = torch.empty((n_dir, n_t, n_b, n_h), dtype=xp.dtype, device=xp.device)
    g_seq: Optional[Tensor] = None
    c_seq: Optional[Tensor] = None
    if save_residuals:
        g_seq = torch.empty_like(xp)
        c_seq = torch.empty_like(y)
    if n_t == 0 and not save_residuals:
        return y, h[0], c[0]
    # arrivals at each direction's barrier between steps (K1)
    counters = None if save_residuals else torch.zeros(n_dir, dtype=torch.int32,
                                                       device=xp.device)
    lib = _build.load_library()
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dsjax_torch_lstm_fwd(
            xp.data_ptr(), mask.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            h.data_ptr(), c.data_ptr(), y.data_ptr(),
            g_seq.data_ptr() if save_residuals else None,
            c_seq.data_ptr() if save_residuals else None, n_dir, n_t, n_b, n_h,
            _reverse_bits(reverse), int(xp.dtype == torch.bfloat16), stream,
            None if plan is None else plan_array(plan),
            None if counters is None else counters.data_ptr())
    _build.check(lib, err, "lstm_fwd launch" if save_residuals else
                 f"lstm_fwd launch (K1, cooperative, {plan})")
    with _launch_lock:
        if save_residuals:
            RESIDUAL_LAUNCHES += 1
        else:
            LAUNCHES += 1
            STEPS += n_t
            WIDE_PASS_LAUNCHES += wide_pass(plan, xp.dtype)
    out = (y, h[n_t % 2], c[n_t % 2])
    return out + (g_seq, c_seq) if save_residuals else out


def wide_pass(plan: ScanPlan, dtype: torch.dtype) -> bool:
    """Whether an f32 plan takes more than 8 batch rows a pass."""
    return dtype == torch.float32 and plan.pass_rows > _F32_ROWS[0]


def check_aligned(name: str, t: Tensor) -> None:
    """Raise unless ``t`` starts on a 16-byte boundary: K1 and K4 copy xp's
    columns into shared memory 16 bytes at a time."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def check_reverse_scan(op: str, g_seq: Tensor, mask: Tensor, w_hh: Tensor, gates: int,
                       reverse: Sequence[bool], seq: dict, state: dict) -> None:
    """Raise on what a reverse scan kernel (K3, K5) does not take: g_seq
    (D, T, B, 4H) with H a multiple of 8, mask (T, B) f32, w_hh
    (D, gates * H, H), the ``seq`` tensors (D, T, B, H) and the ``state``
    tensors (D, B, H), name -> tensor, in g_seq's dtype; contiguous, on one
    device; g_seq, seq and state starting on a boundary of two elements
    (the kernels read and write a pair of neighbouring units at a time)."""
    if g_seq.dim() != 4:
        raise ValueError(f"g_seq must be (D, T, B, 4H), got {tuple(g_seq.shape)}")
    n_dir, n_t, n_b, g4 = g_seq.shape
    n_h = g4 // 4
    if n_dir not in (1, 2) or len(reverse) != n_dir:
        raise ValueError(f"{n_dir} directions with reverse={tuple(reverse)}")
    if g4 != 4 * n_h or n_h % 8:
        raise ValueError(f"hidden size {g4 / 4} must be a multiple of 8: the reverse scan "
                         f"stages rows of {gates}H columns in 16-byte copies")
    if g_seq.dtype not in DTYPES:
        raise TypeError(f"g_seq dtype {g_seq.dtype} is not one of {DTYPES}")
    dtype = g_seq.dtype
    paired = {**{k: (t, (n_dir, n_t, n_b, n_h), dtype) for k, t in seq.items()},
              **{k: (t, (n_dir, n_b, n_h), dtype) for k, t in state.items()}}
    _check_like("g_seq", g_seq, {"mask": (mask, (n_t, n_b), torch.float32),
                                 "w_hh": (w_hh, (n_dir, gates * n_h, n_h), dtype), **paired},
                op)
    check_pairs({"g_seq": g_seq, **{k: v[0] for k, v in paired.items()}})


def check_scan_bwd(g_seq: Tensor, mask: Tensor, w_hh: Tensor, c0: Tensor, c_seq: Tensor,
                   cotangents: Sequence[Tensor], reverse: Sequence[bool]) -> None:
    """Raise on what K3 does not take (``check_reverse_scan``): c0 (D, B, H),
    c_seq (D, T, B, H) and the cotangents dy, dh_T, dc_T beside g_seq."""
    dy, dh_t, dc_t = cotangents
    check_reverse_scan("lstm_scan_bwd", g_seq, mask, w_hh, 4, reverse,
                       {"c_seq": c_seq, "dy": dy}, {"c0": c0, "dh_T": dh_t, "dc_T": dc_t})


def lstm_scan_bwd(g_seq: Tensor, mask: Tensor, w_hh: Tensor, c0: Tensor, c_seq: Tensor,
                  dy: Tensor, dh_t: Tensor, dc_t: Tensor, reverse: Sequence[bool]
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """The reverse scan, K3: the contract of ``lstm_scan_backward_reference``.
    The residuals come from ``lstm_scan_fwd(save_residuals=True)``; the
    cotangents are cast to the working dtype and made contiguous here.

    What the kernel requires, checked by ``check_scan_bwd`` on every device:
    H a multiple of 8, so that each row of 4H columns of dgates and of
    W_hh^T is whole 16-byte ``cp.async`` copies, and the inputs contiguous,
    in one dtype, each starting on a boundary of two elements. The two
    operands of its step product, W_hh^T and dgates, must start on 16-byte
    boundaries: they are tensors this wrapper allocates, which the
    allocator aligns further. The route is ``bwd_plan``'s; the resident
    route raises where the card cannot hold its grid at once (another
    process holding SMs)."""
    global BWD_LAUNCHES, BWD_RESIDENT_LAUNCHES
    dtype = g_seq.dtype
    dy, dh_t, dc_t = (a.to(dtype).contiguous() for a in (dy, dh_t, dc_t))
    check_scan_bwd(g_seq, mask, w_hh, c0, c_seq, (dy, dh_t, dc_t), reverse)
    if g_seq.device.type == "cpu":
        return lstm_scan_backward_reference(g_seq, mask, w_hh, c0, c_seq, dy, dh_t, dc_t,
                                            reverse)
    n_dir, n_t, n_b, g4 = g_seq.shape
    w_t = w_hh.transpose(1, 2).contiguous()          # (D, H, 4H): a unit's weights per row
    dg = torch.empty_like(g_seq)
    dh_rest = dh_t.to(torch.float32, copy=True)      # the kernel's f32 carries, overwritten
    dc = dc_t.to(torch.float32, copy=True)
    dh0 = torch.empty_like(c0)
    dc0 = torch.empty_like(c0)
    n_h = g4 // 4
    plan = card_bwd_plan(dtype, n_dir, n_h, n_b, g_seq.device)
    # arrivals at each direction's barrier between steps (the resident route)
    counters = torch.zeros(n_dir, dtype=torch.int32, device=g_seq.device) if plan.route else None
    lib = _build.load_library()
    with torch.cuda.device(g_seq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dsjax_torch_lstm_bwd(
            g_seq.data_ptr(), mask.data_ptr(), w_t.data_ptr(), c0.data_ptr(),
            c_seq.data_ptr(), dy.data_ptr(), dg.data_ptr(), dh_rest.data_ptr(),
            dc.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), n_dir, n_t, n_b, n_h,
            _reverse_bits(reverse), int(dtype == torch.bfloat16), plan_array(plan),
            None if counters is None else counters.data_ptr(), stream)
    _build.check(lib, err, f"lstm_bwd launch ({plan})")
    with _launch_lock:
        BWD_LAUNCHES += 1
        BWD_RESIDENT_LAUNCHES += plan.route
    return dg, dh0, dc0


def fwd_kernel_attributes(dtype: torch.dtype) -> dict:
    """K2's step kernel for ``dtype`` as built (needs the card): registers a
    thread, static and dynamic shared memory a CTA, local memory (spills) a
    thread, and the hidden units a CTA owns."""
    return _build.kernel_attributes("dsjax_torch_lstm_fwd_attributes", dtype == torch.bfloat16)


def scan_kernel_attributes(dtype: torch.dtype, plan: ScanPlan) -> dict:
    """K1's persistent kernel for ``dtype`` as built under ``plan`` (needs
    the card), as ``persistent_attributes`` gives it."""
    return persistent_attributes("dsjax_torch_lstm_scan_attributes", dtype, plan)


def persistent_attributes(entry: str, dtype: torch.dtype, plan: ScanPlan) -> dict:
    """The persistent scan kernel behind ``entry`` as built for ``plan``
    (with or without register rows): ``_build.kernel_attributes`` with the
    plan's shared memory, units and CTAs a direction, its W_hh rows a CTA
    by where they stay, and the share of them kept on the SM (in shared
    memory or registers) for the whole call."""
    attrs = _build.kernel_attributes(entry, dtype == torch.bfloat16, plan.register_rows,
                                     plan.pass_rows)
    rows = plan.resident_rows + plan.streamed_rows + plan.register_rows
    attrs.update(dynamic_smem_bytes=plan.smem_bytes, units=plan.units, ctas=plan.ctas,
                 pass_rows=plan.pass_rows,
                 resident_rows=plan.resident_rows, streamed_rows=plan.streamed_rows,
                 register_rows=plan.register_rows,
                 resident_share=(plan.resident_rows + plan.register_rows) / rows)
    return attrs


def bwd_kernel_attributes(dtype: torch.dtype, plan: Optional[BwdPlan] = None) -> dict:
    """K3's kernel for ``dtype`` on ``plan``'s route as built (needs the
    card; without a plan the per-step kernel): the route ("resident" or
    "step"), registers a thread, static and dynamic shared memory a CTA (the
    plan's on the resident route), local memory (spills) a thread, the
    hidden units a CTA, and the plan's CTAs and cluster size."""
    resident = plan is not None and plan.route == 1
    attrs = _build.kernel_attributes(
        "dsjax_torch_lstm_bwd_attributes", dtype == torch.bfloat16,
        plan.cluster if resident else 0, plan.units if resident else 0,
        int(resident and plan.stages < plan.atoms_per_cta))
    attrs["route"] = "resident" if resident else "step"
    if plan is not None:
        attrs.update(ctas=plan.ctas, cluster=plan.cluster)
        if resident:
            attrs["dynamic_smem_bytes"] = plan.smem_bytes
    return attrs


def _carried_h_prev(y: Tensor, mask: Tensor, h0: Tensor, reverse: Sequence[bool]) -> Tensor:
    """(D, T, B, H): the h entering each step of each direction, at natural
    time. That is y of the previous scan step once a valid step has been
    seen (masked y equals the carry there), else h0: the "else" matters for
    the suffix masks of a reverse direction with a nonzero carry
    (lstm_pallas.py:396-405)."""
    outs = []
    for d, rev in enumerate(reverse):
        y_s, m_s = _flip(y[d], rev), _flip(mask, rev)
        h_prev = torch.cat([h0[d][None], y_s[:-1]], dim=0)
        seen = (torch.cumsum(m_s, dim=0) - m_s) > 0
        h_prev = torch.where(seen[..., None], h_prev, h0[d][None])
        outs.append(_flip(h_prev, rev))
    return torch.stack(outs)


class LSTMScan(torch.autograd.Function):
    """``lstm_scan`` under autograd: K2 forward, K3 reverse scan, and dW, db
    reduced outside the kernel (dsjax's lstm_scan custom VJP)."""

    @staticmethod
    def forward(ctx, xp, mask, w_hh, b_hh, h0, c0, reverse):
        y, h_t, c_t, g_seq, c_seq = lstm_scan_fwd(xp, mask, w_hh, b_hh, h0, c0, reverse,
                                                  save_residuals=True)
        # the gates residual replaces xp (same shape and dtype)
        ctx.save_for_backward(g_seq, mask, w_hh, h0, c0, y, c_seq)
        ctx.reverse = reverse
        return y, h_t, c_t

    @staticmethod
    def backward(ctx, dy, dh_t, dc_t):
        # the model never uses h_T and c_T in its loss: autograd materializes
        # their cotangents as zeros
        g_seq, mask, w_hh, h0, c0, y, c_seq = ctx.saved_tensors
        dgates, dh0, dc0 = lstm_scan_bwd(g_seq, mask, w_hh, c0, c_seq, dy, dh_t, dc_t,
                                         ctx.reverse)
        n_dir, n_t, n_b, g4 = dgates.shape
        h_prev = _carried_h_prev(y, mask, h0, ctx.reverse)
        # dW[d] = dgates[d]^T . h_prev[d] over all T * B rows, one large
        # product per direction; cuBLAS and the CPU accumulate bf16 products
        # in f32, as the f32-accumulated dot of _vjp_bwd does
        dw = torch.matmul(dgates.reshape(n_dir, n_t * n_b, g4).transpose(1, 2),
                          h_prev.reshape(n_dir, n_t * n_b, -1))
        db = dgates.sum(dim=(1, 2), dtype=torch.float32).to(dgates.dtype)
        return dgates, None, dw.to(w_hh.dtype), db, dh0, dc0, None


def lstm_scan(xp: Tensor, mask: Tensor, w_hh: Tensor, b_hh: Tensor,
              h0: Tensor, c0: Tensor, reverse: Sequence[bool]
              ) -> Tuple[Tensor, Tensor, Tensor]:
    """Masked LSTM recurrence over time for D directions. See the module
    docstring for the contract. Differentiable: a call autograd will
    differentiate saves residuals (K2) for the reverse scan (K3); any other
    call (eval, serving) runs K1 and writes none."""
    check_scan(xp, mask, w_hh, b_hh, (h0, c0), reverse, 4, "lstm_scan")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xp, w_hh, b_hh, h0, c0)):
        return LSTMScan.apply(xp, mask, w_hh, b_hh, h0, c0, tuple(reverse))
    return lstm_scan_fwd(xp, mask, w_hh, b_hh, h0, c0, reverse)
