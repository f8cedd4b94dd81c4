"""dsjax_torch.ops.lstm against dsjax's Pallas LSTM scan (CPU).

The port's plain version, and its wrapper on CPU tensors, are held against
dsjax's ``lstm_scan`` run in Pallas interpret mode and against dsjax's
``lstm_scan_reference``. Tolerances: f32 atol 1e-5 (sum order only);
bf16 atol 2e-2 (the carry is rounded to bf16 every step, and a different
f32 sum order can flip a rounding). The kernel itself runs only on a CUDA
card: tests/test_torch_cuda.py and chip_smoke.py hold it against the plain
version there.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dsjax.ops.lstm_pallas import lstm_scan as jax_lstm_scan
from dsjax.ops.lstm_pallas import lstm_scan_reference as jax_lstm_scan_reference
from dsjax_torch.ops import lstm

ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def problem(seed, T=12, B=8, H=128, D=1):
    """f32 numpy inputs in dsjax's layout: ragged lengths including 1 and T,
    nonzero initial carry."""
    rng = np.random.default_rng(seed)
    xp = (rng.standard_normal((D, T, B, 4 * H)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((D, H, 4 * H)) * 0.1).astype(np.float32)   # (H, 4H) as dsjax
    b = (rng.standard_normal((D, 4 * H)) * 0.1).astype(np.float32)
    h0 = (rng.standard_normal((D, B, H)) * 0.1).astype(np.float32)
    c0 = (rng.standard_normal((D, B, H)) * 0.1).astype(np.float32)
    lengths = np.full((B,), T)
    lengths[1::2] = T // 2
    lengths[min(2, B - 1)] = 1
    mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    return xp, mask, w, b, h0, c0


def to_port(dtype, xp, mask, w, b, h0, c0):
    """The port's layout: W_hh as (D, 4H, H), inputs in the working dtype."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    return (t(xp), torch.from_numpy(mask), t(np.swapaxes(w, 1, 2)), t(b), t(h0), t(c0))


def dsjax_scan(fn, d, dtype, xp, mask, w, b, h0, c0, flip=False):
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x, m = (xp[d][::-1], mask[::-1]) if flip else (xp[d], mask)
    args = [jnp.asarray(np.ascontiguousarray(a), jd) for a in (x, m, w[d], b[d], h0[d], c0[d])]
    args[1] = args[1].astype(jnp.float32 if fn is jax_lstm_scan else jd)
    out = fn(*args, True) if fn is jax_lstm_scan else fn(*args)
    y, h, c = (np.asarray(o.astype(jnp.float32)) for o in out)
    return (y[::-1] if flip else y), h, c


def assert_close(port_out, jax_out, atol):
    for p, j in zip(port_out, jax_out):
        np.testing.assert_allclose(p.float().numpy(), j, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("jax_fn", [jax_lstm_scan, jax_lstm_scan_reference],
                         ids=["pallas_interpret", "lax_scan"])
@pytest.mark.parametrize("suffix_mask", [False, True], ids=["prefix_mask", "suffix_mask"])
def test_forward_direction_matches_dsjax(dtype, jax_fn, suffix_mask):
    xp, mask, w, b, h0, c0 = problem(0)
    if suffix_mask:  # the time-flipped padded stream of a reverse direction
        mask = np.ascontiguousarray(mask[::-1])
    want = dsjax_scan(jax_fn, 0, dtype, xp, mask, w, b, h0, c0)
    args = to_port(dtype, xp, mask, w, b, h0, c0)
    atol = ATOL[str(dtype).split(".")[1]]
    for fn in (lstm.lstm_scan_reference, lstm.lstm_scan):
        y, h, c = fn(*args, reverse=(False,))
        assert y.dtype == dtype and y.shape == (1, 12, 8, 128)
        assert_close((y[0], h[0], c[0]), want, atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_both_directions_in_one_call_match_dsjax_flip(dtype):
    """reverse=(False, True) equals dsjax's backward direction: flip the
    whole padded array and the mask, scan, flip y back."""
    xp, mask, w, b, h0, c0 = problem(1, D=2)
    y, h, c = lstm.lstm_scan(*to_port(dtype, xp, mask, w, b, h0, c0), reverse=(False, True))
    atol = ATOL[str(dtype).split(".")[1]]
    for d in range(2):
        want = dsjax_scan(jax_lstm_scan, d, dtype, xp, mask, w, b, h0, c0, flip=d == 1)
        assert_close((y[d], h[d], c[d]), want, atol)


def test_carry_freezes_and_outputs_zero_past_length():
    xp, mask, w, b, h0, c0 = problem(2)
    args = to_port(torch.float32, xp, mask, w, b, h0, c0)
    y, h, c = lstm.lstm_scan(*args, reverse=(False,))
    one = [a[:, :1] if a.dim() == 4 else a for a in args]
    one[1] = args[1][:1]
    _, h1, c1 = lstm.lstm_scan(*one, reverse=(False,))
    torch.testing.assert_close(h[0, 2], h1[0, 2], rtol=0, atol=1e-6)
    torch.testing.assert_close(c[0, 2], c1[0, 2], rtol=0, atol=1e-6)
    assert torch.all(y[0, 1:, 2] == 0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    xp, mask, w, b, h0, c0 = problem(3, T=4, B=2, H=16)
    args = list(to_port(torch.float32, xp, mask, w, b, h0, c0))
    lstm.lstm_scan(*args, reverse=(False,))
    bad = {
        "dtype": (0, args[0].double(), TypeError),
        "mask dtype": (1, args[1].bool(), TypeError),
        "shape": (2, args[2][:, :, :8], ValueError),
        "contiguity": (4, args[4].transpose(1, 2).contiguous().transpose(1, 2), ValueError),
        # a contiguous view one element into its storage
        "alignment": (2, torch.empty(args[2].numel() + 1).narrow(0, 1, args[2].numel())
                      .view_as(args[2]).copy_(args[2]), ValueError),
    }
    for name, (i, value, exc) in bad.items():
        a = list(args)
        a[i] = value
        with pytest.raises(exc):
            lstm.lstm_scan(*a, reverse=(False,))
    with pytest.raises(ValueError, match="directions"):
        lstm.lstm_scan(*args, reverse=(False, True))
    odd = problem(4, T=3, B=2, H=12)
    with pytest.raises(ValueError, match="multiple of 8"):
        lstm.lstm_scan(*to_port(torch.float32, *odd), reverse=(False,))
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="cuda or cpu"):
        lstm.lstm_scan(*meta, reverse=(False,))


def test_reverse_scan_wrapper_rejects_what_the_kernel_does_not_take():
    """lstm_scan_bwd checks K3's inputs on every device, so the messages
    show here: H not a multiple of 8, shapes, dtypes, contiguity, and an
    input off a two-element boundary."""
    rng = np.random.default_rng(6)

    def args(H=16, T=3, B=2, D=2):
        r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        return [r(D, T, B, 4 * H), torch.ones(T, B), r(D, 4 * H, H), r(D, B, H),
                r(D, T, B, H), r(D, T, B, H), r(D, B, H), r(D, B, H)]

    def offset(a):
        """a contiguous copy of a, one element into its storage"""
        return torch.empty(a.numel() + 1).narrow(0, 1, a.numel()).view_as(a).copy_(a)

    good = args()
    lstm.lstm_scan_bwd(*good, (False, True))
    bad = {
        "multiple of 8": (None, args(H=12), ValueError),
        "g_seq must start on a boundary of two elements": (0, offset(good[0]), ValueError),
        "c_seq must start on a boundary": (4, offset(good[4]), ValueError),
        "dy must start on a boundary": (5, offset(good[5]), ValueError),
        "w_hh must be": (2, good[2][:, :, :8], ValueError),
        "c0 must be torch.float32": (3, good[3].double(), TypeError),
        "c_seq must be contiguous": (4, good[4].transpose(2, 3).contiguous().transpose(2, 3),
                                     ValueError),
    }
    for match, (i, value, exc) in bad.items():
        a = value if i is None else good[:i] + [value] + good[i + 1:]
        with pytest.raises(exc, match=match):
            lstm.lstm_scan_bwd(*a, (False, True))
    with pytest.raises(ValueError, match="directions"):
        lstm.lstm_scan_bwd(*good, (False,))
    meta = [a.to("meta") for a in good]
    with pytest.raises(ValueError, match="cuda or cpu"):
        lstm.lstm_scan_bwd(*meta, (False, True))


def test_residual_forward_wrapper_rejects_inputs_off_a_pair_boundary():
    """K2 reads xp and b_hh a unit pair at a time, so lstm_scan_fwd with
    residuals, and the differentiated lstm_scan through it, check both on
    every device; K1, which reads them one element at a time, takes them."""
    xp, mask, w, b, h0, c0 = problem(9, T=3, B=2, H=16)
    args = list(to_port(torch.float32, xp, mask, w, b, h0, c0))

    def offset(a):
        """a contiguous copy of a, one element into its storage"""
        return torch.empty(a.numel() + 1).narrow(0, 1, a.numel()).view_as(a).copy_(a)

    for i, name in ((0, "xp"), (3, "b_hh")):
        a = args[:i] + [offset(args[i])] + args[i + 1:]
        with pytest.raises(ValueError, match=f"{name} must start on a boundary of two elements"):
            lstm.lstm_scan_fwd(*a, (False,), save_residuals=True)
        with pytest.raises(ValueError, match=f"{name} must start on a boundary"):
            lstm.lstm_scan(*[t.requires_grad_(k == 0) for k, t in enumerate(a)], (False,))
        want = lstm.lstm_scan_fwd(*args, (False,))
        for got, ref in zip(lstm.lstm_scan_fwd(*a, (False,)), want):
            torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_cpu_path_counts_no_launch_and_import_loads_nothing():
    xp, mask, w, b, h0, c0 = problem(5, T=3, B=2, H=16)
    before = lstm.LAUNCHES
    lstm.lstm_scan(*to_port(torch.float32, xp, mask, w, b, h0, c0), reverse=(False,))
    assert lstm.LAUNCHES == before
    code = ("import sys\n"
            "import dsjax_torch.ops.lstm\n"
            "from dsjax_torch.ops import _build\n"
            "assert _build._lib is None\n"
            "assert 'triton' not in sys.modules and 'jax' not in sys.modules\n"
            "assert not any(m.startswith('torch.utils.cpp_extension') for m in sys.modules)\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


# ---------------------------------------------------------------------------
# The persistent scan's plan (K1 and K4 on the card), pure Python
# ---------------------------------------------------------------------------

# (directions, H, dtype, B, SMs): the serving and streaming widths, the
# evaluation and validation batches, unit edges (the second with register
# rows), the widest H the wrapper takes, the narrowest, and cards of other
# SM counts
PLAN_CASES = [
    (2, 1024, torch.float32, 8, 132), (2, 1024, torch.bfloat16, 8, 132),
    (1, 1024, torch.float32, 8, 132), (2, 1024, torch.float32, 64, 132),
    (2, 1024, torch.bfloat16, 20, 132), (2, 1032, torch.float32, 20, 132),
    (2, 4096, torch.float32, 8, 132), (2, 4096, torch.bfloat16, 64, 132),
    (1, 4096, torch.float32, 64, 132), (2, 8, torch.bfloat16, 1, 132),
    (2, 1024, torch.float32, 8, 114), (1, 2048, torch.bfloat16, 20, 78),
    (2, 1000, torch.float32, 9, 132)]
# f32 past 8 rows, where the plan takes wider passes: the batch edges of its
# row counts, the evaluation batch, two passes of 12 and of 20, validation,
# with two directions (register rows) and one, at a unit edge and with the
# wider register chunk at H < 1024
WIDE_PLAN_CASES = [
    (2, 1024, torch.float32, 9, 132), (2, 1024, torch.float32, 16, 132),
    (2, 1024, torch.float32, 20, 132), (2, 1024, torch.float32, 24, 132),
    (2, 1024, torch.float32, 40, 132), (2, 1024, torch.float32, 64, 132),
    (1, 1024, torch.float32, 20, 132), (1, 1024, torch.float32, 40, 132),
    (2, 1032, torch.float32, 20, 132), (2, 1000, torch.float32, 20, 132),
    (2, 1024, torch.float32, 160, 132), (2, 4096, torch.float32, 20, 132)]


def check_plan(plan, n_dir, n_h, gates, dtype, sms, n_b=None):
    """Every unit owned by exactly one CTA, at most one CTA an SM, the
    shared memory within what a CTA may take, every gate row resident,
    streamed or in registers (only the last gate's 16 rows, in f32, at most
    4096 bytes of each, read in 1024-byte chunks up to 12 rows a pass and
    in 512-byte ones at 16 and 20), a ring of one stage only for a single
    chunk, and rows a pass that the kernel is built for: 16 in bf16, 8 in
    f32 up to B = 8, else 8, 12, 16 or 20 (past 8, chunks of at most 1024
    bytes)."""
    owners = np.arange(n_h) // plan.units
    assert np.array_equal(np.unique(owners), np.arange(plan.ctas))
    assert plan.units % 8 == 0 and n_dir * plan.ctas <= sms
    assert plan.smem_bytes <= lstm.SMEM_LIMIT == 232448
    assert plan.resident_rows + plan.streamed_rows + plan.register_rows == gates * plan.units
    assert min(plan.resident_rows, plan.streamed_rows) >= 0
    assert plan.register_rows in (0, plan.units)
    if dtype == torch.bfloat16:
        assert plan.pass_rows == 16
    else:
        assert plan.pass_rows in (8, 12, 16, 20)
        assert n_b is None or n_b > 8 or plan.pass_rows == 8
        assert plan.pass_rows == 8 or plan.chunk_bytes <= 1024   # a tensor copy's box
    if plan.register_rows:
        assert dtype == torch.float32 and plan.units == 16
        assert plan.chunk_bytes == (1024 if plan.pass_rows <= 12 else 512)
        assert n_h * 4 <= 4 * 1024
    n_chunks = -(-n_h * (2 if dtype == torch.bfloat16 else 4) // plan.chunk_bytes)
    assert 1 <= plan.stages <= 5 and plan.chunk_bytes % 32 == 0
    assert plan.stages >= 2 or n_chunks == 1


@pytest.mark.parametrize("n_dir,n_h,dtype,n_b,sms", PLAN_CASES + WIDE_PLAN_CASES)
def test_scan_plan_covers_every_unit_and_fits_a_cta(n_dir, n_h, dtype, n_b, sms):
    check_plan(lstm.scan_plan(n_dir, n_h, 4, dtype, n_b, sms), n_dir, n_h, 4, dtype, sms, n_b)


# the plans that scan_plan gave before it chose the rows a pass, field for
# field (the rows a pass last): f32 up to B = 8 and bf16 at any B keep them
# (gates, directions, H, dtype, B, SMs) -> plan
KEPT_PLANS = {
    (4, 2, 1024, torch.float32, 8, 132): (16, 64, 48, 0, 16, 2, 1024, 225568, 8),
    (4, 2, 1024, torch.float32, 1, 132): (16, 64, 48, 0, 16, 2, 1024, 224672, 8),
    (4, 1, 1024, torch.float32, 8, 132): (8, 128, 32, 0, 0, 3, 2048, 191008, 8),
    (4, 2, 1032, torch.float32, 5, 132): (16, 65, 47, 17, 0, 2, 512, 232336, 8),
    (3, 2, 1024, torch.float32, 8, 132): (16, 64, 48, 0, 0, 3, 1024, 230752, 8),
    (3, 1, 1024, torch.float32, 1, 132): (8, 128, 24, 0, 0, 3, 2048, 155296, 8),
    (4, 2, 1024, torch.bfloat16, 20, 132): (16, 64, 64, 0, 0, 1, 2048, 186432, 16),
    (3, 2, 1024, torch.bfloat16, 64, 132): (16, 64, 48, 0, 0, 1, 2048, 150272, 16)}


@pytest.mark.parametrize("case", list(KEPT_PLANS), ids=lambda c: "-".join(map(str, c)))
def test_scan_plan_up_to_8_rows_and_in_bf16_is_kept(case):
    gates, n_dir, n_h, dtype, n_b, sms = case
    assert tuple(lstm.scan_plan(n_dir, n_h, gates, dtype, n_b, sms)) == KEPT_PLANS[case]


@pytest.mark.parametrize("n_b,rows", [(1, 8), (8, 8), (9, 12), (12, 12), (13, 16), (17, 20),
                                      (20, 20), (24, 12), (40, 20), (64, 16)])
def test_scan_plan_takes_the_fewest_passes_in_f32(n_b, rows):
    """Past 8 rows an f32 plan takes the fewest passes over the batch, then
    the fewest rows a pass (B = 24 two of 12, not two of 20), keeping every
    W_hh row on the SM (B = 64: four passes of 16, where 8 rows a pass
    streamed one row)."""
    plan = lstm.scan_plan(2, 1024, 4, torch.float32, n_b, 132)
    assert plan.pass_rows == rows
    assert (plan.resident_rows, plan.streamed_rows, plan.register_rows) == (48, 0, 16)


def test_scan_plan_at_the_flagship_width():
    """H=1024 on 132 SMs: two directions take 16 units a CTA, 64 CTAs each;
    a CTA's 64 f32 rows do not fit its shared memory, so the last gate's 16
    stay in registers and the serving, evaluation and validation batches
    stream none (B=160 streams one); the evaluation batch of 20 rows is one
    pass; bf16 keeps them all resident; one direction takes 8 units a
    CTA."""
    f32 = lstm.scan_plan(2, 1024, 4, torch.float32, 8, 132)
    bf16 = lstm.scan_plan(2, 1024, 4, torch.bfloat16, 8, 132)
    one = lstm.scan_plan(1, 1024, 4, torch.float32, 8, 132)
    assert (f32.units, f32.ctas, bf16.units, bf16.ctas) == (16, 64, 16, 64)
    assert (f32.resident_rows, f32.streamed_rows, f32.register_rows) == (48, 0, 16)
    evaluation = lstm.scan_plan(2, 1024, 4, torch.float32, 20, 132)
    assert evaluation.streamed_rows == 0 and evaluation.pass_rows == 20   # one pass
    assert evaluation.chunk_bytes == 512
    assert f32.pass_rows == 8 and bf16.pass_rows == 16
    assert lstm.scan_plan(2, 1024, 4, torch.float32, 64, 132).streamed_rows == 0
    assert lstm.scan_plan(2, 1024, 4, torch.float32, 160, 132).streamed_rows > 0
    assert (bf16.streamed_rows, bf16.register_rows) == (0, 0)
    assert (one.units, one.ctas, one.register_rows) == (8, 128, 0)


@pytest.mark.parametrize("n_dir,n_h,n_b,sms,match", [
    (2, 4096, 8, 16, "column tiles"), (2, 1024, 8, 1, "directions"),
    (2, 1024, 4000, 132, "shared memory"), (2, 1020, 8, 132, "multiple of 8")])
def test_scan_plan_raises_where_no_plan_fits(n_dir, n_h, n_b, sms, match):
    with pytest.raises(ValueError, match=match):
        lstm.scan_plan(n_dir, n_h, 4, torch.float32, n_b, sms)


# ---------------------------------------------------------------------------
# K3's route and layout (csrc/lstm_bwd.cu on the card), pure Python
# ---------------------------------------------------------------------------

# clusters of each (cluster size, units a CTA) that an H100 of 132 SMs holds
# at once under the flagship's layouts (cudaOccupancyMaxActiveClusters: one
# CTA an SM takes over 114 KB of shared memory)
H100_CLUSTERS = {(8, 16): 15, (8, 20): 15, (4, 16): 30, (4, 20): 30, (2, 16): 66, (1, 16): 132}


def check_bwd_layout(plan, n_dir, n_h, n_b, sms):
    """The resident route's layout: every unit owned by one CTA, whole
    clusters in each direction (less than a cluster of them owning no unit),
    at most one CTA an SM; the K atoms of 4H split over a cluster with none
    empty; the shared memory (the alignment pad, W_hh^T's rows of the
    cluster's units over a CTA's atoms, the dgates buffers with an mbarrier
    each) within what a CTA may take and the buffers large enough for the
    CTA's partial sums."""
    assert plan.route == 1 and (plan.cluster, plan.units) in lstm.BWD_SHAPES
    assert plan.tiles == -(-n_b // 64) <= 2
    owners = np.arange(n_h) // plan.units
    assert np.array_equal(np.unique(owners), np.arange(-(-n_h // plan.units)))
    assert plan.ctas_per_dir % plan.cluster == 0
    assert (plan.ctas_per_dir - plan.cluster) * plan.units < n_h
    assert plan.ctas == n_dir * plan.ctas_per_dir <= sms
    assert plan.atoms == -(-4 * n_h // 64)
    slices = [min(plan.atoms_per_cta, plan.atoms - r * plan.atoms_per_cta)
              for r in range(plan.cluster)]
    assert min(slices) >= 1 and sum(slices) == plan.atoms
    assert 2 <= plan.stages <= plan.atoms_per_cta or plan.stages == plan.atoms_per_cta
    n, stage = plan.cluster * plan.units, 64 * plan.tiles * 128
    assert n <= 256 and n % 8 == 0 and plan.units % 2 == 0
    w_bytes = plan.atoms_per_cta * n * 128
    assert plan.smem_bytes == 1024 + w_bytes + plan.stages * (stage + 8) <= lstm.SMEM_LIMIT
    assert plan.stages * stage >= 64 * plan.tiles * (n + 8) * 4


@pytest.mark.parametrize("active", [None, H100_CLUSTERS], ids=["nominal", "h100"])
@pytest.mark.parametrize("n_b", [1, 64, 80, 128, 256])
@pytest.mark.parametrize("n_h", [40, 1024, 1032])
@pytest.mark.parametrize("n_dir", [1, 2])
def test_bwd_plan_routes_bf16_by_shape(n_dir, n_h, n_b, active):
    """bf16 on 132 SMs takes the resident route with one or two 64-row
    tiles of the batch, and the per-step kernel at B=256 (four tiles)."""
    plan = lstm.bwd_plan(torch.bfloat16, n_dir, n_h, n_b, 132, active)
    if n_b > 128:
        assert plan.route == 0 and plan.cluster == 1
        assert (plan.units, plan.ctas) == (16, n_dir * -(-n_h // 16))
    else:
        check_bwd_layout(plan, n_dir, n_h, n_b, 132)
        clusters = 132 // plan.cluster if active is None else active[(plan.cluster, plan.units)]
        assert clusters * plan.cluster >= plan.ctas


@pytest.mark.parametrize("n_dir,n_h,n_b,want", [
    # (route, units, tiles, cluster, ctas, atoms a CTA, buffers, shared memory)
    (2, 1024, 64, (1, 20, 1, 8, 112, 8, 8, 230464)),     # the flagship: every atom resident
    (2, 1024, 80, (1, 20, 2, 4, 104, 16, 4, 230432)),    # two tiles, the second ragged: a ring
    (2, 1024, 128, (1, 20, 2, 4, 104, 16, 4, 230432)),
    (1, 1024, 64, (1, 16, 1, 8, 64, 8, 8, 197696)),      # 8 clusters of 16-unit CTAs
    (2, 1032, 64, (1, 20, 1, 4, 104, 17, 6, 224304)),    # a unit edge: the last CTA 12 units
    (1, 1032, 64, (1, 16, 1, 8, 72, 9, 9, 222280)),      # the last CTA of a cluster 2 atoms
    (2, 40, 1, (1, 16, 1, 2, 8, 2, 2, 25616)),           # 3 atoms: clusters of 2 at most
    (2, 1024, 256, (0, 16, 4, 1, 128, 0, 0, 0))])
def test_bwd_plan_at_the_flagship_and_its_edges(n_dir, n_h, n_b, want):
    """The layouts an H100 gets: at H=1024 in two directions 16-unit CTAs
    would need 16 clusters of 8 where it holds 15, so the CTAs take 20
    units (14 clusters)."""
    p = lstm.bwd_plan(torch.bfloat16, n_dir, n_h, n_b, 132, H100_CLUSTERS)
    assert (p.route, p.units, p.tiles, p.cluster, p.ctas, p.atoms_per_cta, p.stages,
            p.smem_bytes) == want


@pytest.mark.parametrize("n_b", [8, 64])
def test_bwd_plan_keeps_f32_on_the_per_step_kernel(n_b):
    """f32's 256 KB of W_hh^T a CTA at H=1024 would not fit: the per-step
    kernel, whatever the shape."""
    plan = lstm.bwd_plan(torch.float32, 2, 1024, n_b, 132, H100_CLUSTERS)
    assert plan == lstm.BwdPlan(0, 16, 1, 1, 128, 64, 0, 0, 0, 0)
    assert lstm.bwd_plan(torch.float32, 1, 40, 1, 132).route == 0
    with pytest.raises(TypeError):
        lstm.bwd_plan(torch.float16, 2, 1024, 64, 132)


# the resident kernels csrc/lstm_bwd.cu builds (resident::kernel_for):
# each (cluster size, units) of BWD_SHAPES with and without a ring of
# dgates buffers, but (8, 20) without one only
BUILT_BWD_KERNELS = {(c, u, ring) for c, u in lstm.BWD_SHAPES for ring in (False, True)} - {
    (8, 20, True)}


@pytest.mark.parametrize("n_b", [1, 64, 65, 128])
@pytest.mark.parametrize("n_dir", [1, 2])
def test_bwd_layouts_take_only_built_kernels(n_dir, n_b):
    """Every layout of BWD_SHAPES that fits, at every H up to where none
    does, takes a kernel csrc/lstm_bwd.cu builds: (8, 20)'s never needs a
    ring."""
    taken = set()
    for n_h in range(8, 4104, 8):
        for shape in lstm.BWD_SHAPES:
            p = lstm.bwd_layout(n_dir, n_h, n_b, 132, *shape)
            if p is not None:
                taken.add((p.cluster, p.units, p.stages < p.atoms_per_cta))
    assert taken <= BUILT_BWD_KERNELS
    assert (8, 20, False) in taken


@pytest.mark.parametrize("active,want", [
    (H100_CLUSTERS, (8, 20)), ({**H100_CLUSTERS, (8, 16): 16}, (8, 16)),
    ({**H100_CLUSTERS, (8, 20): 13}, (4, 20)),
    ({**H100_CLUSTERS, (8, 20): 13, (4, 16): 32}, (4, 16)),
    ({(8, 16): 0, (8, 20): 0, (4, 16): 31, (4, 20): 25, (2, 16): 64}, (2, 16)),
    ({(2, 16): 63, (1, 16): 128}, (1, 16)), ({(8, 20): 14}, (8, 20)),
    ({(2, 16): 63, (1, 16): 127}, None), ({}, None), (None, (8, 16))])
def test_bwd_plan_takes_the_largest_co_resident_cluster(active, want):
    """The (cluster size, units) is the first of BWD_SHAPES whose clusters
    the card holds at once (the counts passed in, as
    cudaOccupancyMaxActiveClusters gives them); where none is, the per-step
    kernel (None here)."""
    plan = lstm.bwd_plan(torch.bfloat16, 2, 1024, 64, 132, active)
    assert ((plan.cluster, plan.units) if plan.route else None) == want
    earlier = lstm.BWD_SHAPES[:lstm.BWD_SHAPES.index(want)] if want else lstm.BWD_SHAPES
    for shape in earlier:
        layout = lstm.bwd_layout(2, 1024, 64, 132, *shape)
        assert layout is None or (active or {}).get(shape, 0) * shape[0] < layout.ctas
    if plan.route:
        check_bwd_layout(plan, 2, 1024, 64, 132)
