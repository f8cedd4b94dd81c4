"""dsjax_torch's CUDA kernels on the card (marked `cuda`; skips without one).

Run on a machine with an NVIDIA card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Each LSTM kernel (K1 the forward, K2 the residual-saving forward, K3 the
reverse scan) is held against its plain PyTorch version on the same CUDA
tensors (f32: atol 2e-5, rtol 1e-4 forward, sum order only; bf16: atol
3e-2, the carry rounds to bf16 every step; the reverse scan's looser bounds
are stated at BWD_TOL; K3 in bf16 on its resident route, one cooperative
launch in thread block clusters, up to the flagship's full shape, in f32 on
the per-step kernel), the differentiated op against autograd through the
plain loop, and the model's CUDA forward and gradients against its CPU ones
with TF32 off. K6 (the exact top-k) and K7 (the fused beam scan) are held
against their plain versions exactly, K7's float totals and carry to atol
1e-5 (logaddexp sums the same floats in the same order on both sides), with
their launch counts per decode route and the raise when the kernel library
cannot load; K6 also on signed zeros and subnormals, values compared bit
for bit. K5 (the GRU reverse scan) runs at K3's tiling edges, as K2 and
K4 with residuals (the forwards on the same step product) do; the step
kernels of all four are checked to fit one CTA an SM, the forwards' also
to spill nothing. K1 and K4, the persistent forwards (one cooperative
launch a call), run at the flagship's width where f32 rows stream from L2,
at a unit edge inside the last CTA, at B = 1, 20 and 64, at T = 0 and 1,
and with one direction under a suffix mask with a zero-length row; their
kernels are checked to spill nothing under their plans, and K1 to run
beside K2 on a second stream. The LM-fused beam scan selecting with K6 is
held bit for bit against the same scan with the plain top-k, the device
LM's scores on the card against the CPU's, and an LM decode makes T + 1 K6
launches and no K7 launch even under DSJAX_FUSED_BEAM=1. The data-parallel
bundle, on two replicas sharing one card and on every card where there are
several, gives one card's posteriors and strings, with K1's launches
counted a shard.
"""

import numpy as np
import pytest
import torch

from dsjax_torch.ops import lstm

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4), torch.bfloat16: dict(atol=3e-2, rtol=0.0)}
# dh and dc carry sums of 4H products through every step: f32 sum order
# only; in bf16 each step's dgates round to bf16 before the product, so a
# flipped rounding propagates back through the steps
BWD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4), torch.bfloat16: dict(atol=5e-2, rtol=2e-2)}
SHAPES = [(12, 8, 128, (False, True)), (7, 3, 64, (False,)), (33, 20, 256, (True, False))]
# K3's tiling: two 64-row blocks, the second ragged (B=80); one row (B=1);
# a unit edge inside a CTA's 16 units (H=40); the flagship's width
BWD_SHAPES = [(9, 80, 128, (False, True)), (10, 1, 64, (True,)), (11, 5, 40, (False, True)),
              (64, 64, 1024, (False, True))]
# K3's resident route at the flagship's full shape, at one direction with
# two 64-row tiles of the batch (the second ragged at B=80), and at a unit
# edge (H=1032: the last CTA's units cut short); with SHAPES and
# BWD_SHAPES they reach a kernel of each N = cluster x units (16: one K
# atom, H=16; 128 without a ring: one direction at B=64)
K3_SHAPES = [(512, 64, 1024, (False, True)), (24, 80, 1024, (True,)), (24, 128, 1024, (False,)),
             (16, 64, 1032, (False, True)), (12, 8, 16, (False, True)), (24, 64, 1024, (True,))]


@pytest.fixture
def full_fp32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def problem(shape, dtype, suffix=False, empty_row=False):
    """Inputs on the card: ragged lengths including 1 and T (a suffix mask
    when asked, as a time-flipped padded stream has), and 0 in row 1 when
    asked and B > 2; nonzero carry."""
    T, B, H, reverse = shape
    D = len(reverse)
    rng = np.random.default_rng(T)
    dev = lambda a, dt=dtype: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to("cuda", dt)
    lengths = rng.integers(1, T + 1, B) if T else np.zeros(B, np.int64)
    lengths[0], lengths[-1] = min(1, T), T
    if empty_row and B > 2:
        lengths[1] = 0
    mask = np.arange(T)[:, None] < lengths[None, :]
    mask = dev(mask[::-1] if suffix else mask, torch.float32)
    # W_hh at 0.1 makes the reverse recurrence at H=1024 grow about 6x a
    # step, and any sum order's rounding with it: the flagship's width takes
    # chip_smoke.py's 0.03, about 1/sqrt(H)
    w_scale = 0.1 if H < 1024 else 0.03
    return (dev(rng.standard_normal((D, T, B, 4 * H)) * 0.3), mask,
            dev(rng.standard_normal((D, 4 * H, H)) * w_scale),
            dev(rng.standard_normal((D, 4 * H)) * 0.1),
            dev(rng.standard_normal((D, B, H)) * 0.1), dev(rng.standard_normal((D, B, H)) * 0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_version(full_fp32, dtype, shape):
    T, B, H, reverse = shape
    args = problem(shape, dtype)
    before = lstm.LAUNCHES
    out = lstm.lstm_scan(*args, reverse)
    torch.cuda.synchronize()
    assert lstm.LAUNCHES == before + 1
    ref = lstm.lstm_scan_reference(*args, reverse)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o.float(), r.float(), **TOL[dtype])


def test_model_cuda_forward_matches_cpu(full_fp32):
    from dsjax_torch.config import BiDirectionalConfig, SpectConfig
    from dsjax_torch.model.ds2 import DeepSpeech2

    cfg = BiDirectionalConfig(hidden_size=64, hidden_layers=3)
    model = DeepSpeech2(29, SpectConfig(), cfg, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 161, 50)).astype(np.float32))
    lengths = torch.tensor([50, 31, 12, 1], dtype=torch.int32)
    with torch.inference_mode():
        want, want_lens, _ = model(x, lengths)
        before = lstm.LAUNCHES
        got, got_lens, carry = model.cuda()(x.cuda(), lengths.cuda())
        torch.cuda.synchronize()
    assert lstm.LAUNCHES == before + cfg.hidden_layers
    assert torch.equal(got_lens.cpu(), want_lens)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES + BWD_SHAPES)
def test_residual_forward_matches_plain_version(full_fp32, dtype, shape):
    """K2: y, h_T, c_T, the gates and the kept carry c, prefix and suffix
    masks with a zero-length row, at its tiling edges too (BWD_SHAPES: the
    64-row block crossed, one row, a unit edge inside a CTA's 16 units, the
    flagship's width)."""
    for suffix in (False, True):
        args = problem(shape, dtype, suffix, empty_row=True)
        before = (lstm.LAUNCHES, lstm.RESIDUAL_LAUNCHES)
        out = lstm.lstm_scan_fwd(*args, shape[3], save_residuals=True)
        torch.cuda.synchronize()
        assert (lstm.LAUNCHES, lstm.RESIDUAL_LAUNCHES) == (before[0], before[1] + 1)
        ref = lstm.lstm_scan_reference(*args, shape[3], save_residuals=True)
        assert len(out) == len(ref) == 5
        for o, r in zip(out, ref):
            torch.testing.assert_close(o.float(), r.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES + BWD_SHAPES + K3_SHAPES)
def test_reverse_scan_matches_plain_version(full_fp32, dtype, shape):
    """K3 on the residuals of the plain forward, with nonzero dh_T, dc_T,
    prefix and suffix masks: bf16 (B <= 128 here) on the resident route,
    f32 on the per-step kernel, as the resident launch counter shows."""
    T, B, H, reverse = shape
    for suffix in (False, True):
        xp, mask, w, b, h0, c0 = problem(shape, dtype, suffix)
        _, _, _, g_seq, c_seq = lstm.lstm_scan_reference(xp, mask, w, b, h0, c0, reverse,
                                                         save_residuals=True)
        rng = np.random.default_rng(T + 1)
        cot = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to("cuda", dtype)
               for s in (c_seq.shape, h0.shape, c0.shape)]
        before = (lstm.BWD_LAUNCHES, lstm.BWD_RESIDENT_LAUNCHES)
        out = lstm.lstm_scan_bwd(g_seq, mask, w, c0, c_seq, *cot, reverse)
        torch.cuda.synchronize()
        resident = int(dtype == torch.bfloat16)
        assert (lstm.BWD_LAUNCHES, lstm.BWD_RESIDENT_LAUNCHES) == \
            (before[0] + 1, before[1] + resident)
        ref = lstm.lstm_scan_backward_reference(g_seq, mask, w, c0, c_seq, *cot, reverse)
        for o, r in zip(out, ref):
            assert o.dtype == dtype and o.shape == r.shape
            torch.testing.assert_close(o.float(), r.float(), **BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("rnn", ["lstm", "gru"])
def test_residual_forward_kernel_fits_one_cta_an_sm(full_fp32, rnn, dtype):
    """K2's and K4 with residuals' step kernels as built: 16 units a CTA,
    their shared memory within the 227 KB a CTA may take, registers within
    255 a thread, and no local memory (the bf16 product holds 128 f32
    accumulators a thread in K2)."""
    from dsjax_torch.ops import gru

    attrs = {"lstm": lstm, "gru": gru}[rnn].fwd_kernel_attributes(dtype)
    assert attrs["units"] == 16
    assert attrs["static_smem_bytes"] + attrs["dynamic_smem_bytes"] <= 232448
    assert 0 < attrs["registers"] <= 255
    assert attrs["local_bytes"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("n_b", [64, 128])
def test_reverse_scan_kernel_fits_one_cta_an_sm(full_fp32, dtype, n_b):
    """K3's kernel as built for the flagship's width on the card's plan:
    bf16 the resident kernel (16 or 20 units a CTA, one CTA an SM, every
    cluster co-resident, no local memory), f32 the per-step kernel (16
    units); the shared memory within the 227 KB a CTA may take, registers
    within 255 a thread."""
    plan = lstm.card_bwd_plan(dtype, 2, 1024, n_b, torch.device("cuda", 0))
    attrs = lstm.bwd_kernel_attributes(dtype, plan)
    assert attrs["static_smem_bytes"] + attrs["dynamic_smem_bytes"] <= 232448
    assert 0 < attrs["registers"] <= 255
    if dtype == torch.bfloat16:
        assert attrs["route"] == "resident" and attrs["units"] in (16, 20)
        assert attrs["local_bytes"] == 0 and attrs["ctas"] <= torch.cuda.get_device_properties(
            0).multi_processor_count
        assert (attrs["cluster"], attrs["units"]) in lstm.BWD_SHAPES
    else:
        assert attrs["route"] == "step" and attrs["units"] == 16


def test_differentiated_scan_runs_k2_k3_and_matches_autograd(full_fp32):
    """The gradient cut is repaired: with inputs that require grad the
    outputs carry a grad_fn, every input gets its gradient through K2 and
    K3, and they match autograd through the plain loop; a call without
    grad still runs K1 only."""
    shape = (20, 12, 128, (False, True))
    args = [a.requires_grad_(a.dtype == torch.float32 and i != 1)
            for i, a in enumerate(problem(shape, torch.float32, suffix=False))]
    rng = np.random.default_rng(5)
    weights = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda()
               for s in ((2, 20, 12, 128), (2, 12, 128), (2, 12, 128))]
    counts = (lstm.LAUNCHES, lstm.RESIDUAL_LAUNCHES, lstm.BWD_LAUNCHES)
    out = lstm.lstm_scan(*args, shape[3])
    assert all(o.grad_fn is not None for o in out)
    grads = torch.autograd.grad(sum((o * wt).sum() for o, wt in zip(out, weights)),
                                [args[i] for i in (0, 2, 3, 4, 5)])
    torch.cuda.synchronize()
    assert (lstm.LAUNCHES, lstm.RESIDUAL_LAUNCHES, lstm.BWD_LAUNCHES) == \
        (counts[0], counts[1] + 1, counts[2] + 1)
    ref = lstm.lstm_scan_reference(*args, shape[3])
    want = torch.autograd.grad(sum((o * wt).sum() for o, wt in zip(ref, weights)),
                               [args[i] for i in (0, 2, 3, 4, 5)])
    for g, w in zip(grads, want):
        assert g.abs().max() > 0
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        lstm.lstm_scan(*args, shape[3])
    assert (lstm.LAUNCHES, lstm.RESIDUAL_LAUNCHES, lstm.BWD_LAUNCHES) == \
        (counts[0] + 1, counts[1] + 1, counts[2] + 1)


def test_model_cuda_gradients_match_cpu(full_fp32):
    """A training forward and backward of a small model on the card against
    the same on the CPU: every parameter's gradient and the BatchNorm
    running stats."""
    from dsjax_torch.config import BiDirectionalConfig, SpectConfig
    from dsjax_torch.model.ds2 import DeepSpeech2

    cfg = BiDirectionalConfig(hidden_size=64, hidden_layers=2)
    cpu = DeepSpeech2(29, SpectConfig(), cfg, generator=torch.Generator().manual_seed(0)).train()
    gpu = DeepSpeech2(29, SpectConfig(), cfg).cuda().train()
    gpu.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 161, 50)).astype(np.float32))
    lengths = torch.tensor([50, 31, 12, 1], dtype=torch.int32)
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        out, _, _ = model(x.to(dev), lengths.to(dev))
        torch.log_softmax(out.float(), -1)[..., 1].sum().backward()
    for (name, p), q in zip(cpu.named_parameters(), gpu.parameters()):
        scale = float(p.grad.abs().max())
        torch.testing.assert_close(q.grad.cpu(), p.grad, atol=1e-4 * scale + 1e-6, rtol=1e-4,
                                   msg=lambda m: f"{name}: {m}")
    for name, buf in cpu.named_buffers():
        torch.testing.assert_close(dict(gpu.named_buffers())[name].cpu(), buf, atol=1e-5,
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# K6, the exact top-k, and K7, the fused beam scan
# ---------------------------------------------------------------------------


def tie_heavy(rng, b, n):
    """Scores with the beam pool's ties: a share at -1e30, repeated values."""
    s = rng.standard_normal((b, n)).astype(np.float32)
    s[:, ::3] = np.float32(-1e30)
    s[:, 1::7] = np.float32(0.5)
    s[0] = 0.0
    return s


EDGE_POOL = np.array([0.0, -0.0, 5e-45, -5e-45, 1e-40, -1e-40, 1e-38, -1e-38, -np.inf, -1e30,
                      1.0, -1.0], np.float32)


def kth_key_ties(rng, b, n, k):
    """Rows whose k-th key ties across hundreds of positions: k // 2 scores
    above 1, 700 at 0.25, the rest below -1."""
    s = -1.0 - rng.random((b, n)).astype(np.float32)
    for row in s:
        pos = rng.permutation(n)
        row[pos[:k // 2]] = 1.0 + rng.random(k // 2).astype(np.float32)
        row[pos[k // 2:k // 2 + 700]] = 0.25
    return s


# the beam pools; k = N on both ordering routes (ranked up to k = 256,
# sorted above); k = 1; the largest row; signed zeros, subnormals, -inf and
# -1e30; rows whose k-th key ties across hundreds of positions
@pytest.mark.parametrize("scores,b,n,k", [
    ("tie-heavy", 16, 3840, 128), ("tie-heavy", 20, 300, 10), ("tie-heavy", 64, 7680, 256),
    ("tie-heavy", 3, 1, 1), ("tie-heavy", 2, 16384, 300), ("tie-heavy", 5, 129, 129),
    ("tie-heavy", 4, 5000, 5000), ("tie-heavy", 16, 3840, 1), ("tie-heavy", 2, 16384, 16384),
    ("signed zeros", 8, 300, 1), ("signed zeros", 8, 300, 64), ("signed zeros", 4, 3840, 128),
    ("signed zeros", 4, 3840, 3840), ("k-th key ties", 16, 3840, 128),
    ("k-th key ties", 4, 7680, 1000)])
def test_topk_kernel_matches_plain_version(full_fp32, scores, b, n, k):
    """Indices equal, values equal bit for bit (torch.equal takes -0.0 for
    +0.0)."""
    from dsjax_torch.ops import topk

    rng = np.random.default_rng(n + k)
    s_np = {"tie-heavy": lambda: tie_heavy(np.random.default_rng(n), b, n),
            "signed zeros": lambda: rng.choice(EDGE_POOL, (b, n)).astype(np.float32),
            "k-th key ties": lambda: kth_key_ties(rng, b, n, k)}[scores]()
    s = torch.from_numpy(s_np).cuda()
    before = topk.LAUNCHES
    values, idx = topk.topk(s, k)
    torch.cuda.synchronize()
    assert topk.LAUNCHES == before + 1
    want_v, want_i = topk.topk_reference(s, k)
    assert idx.dtype == want_i.dtype == torch.int32
    assert torch.equal(idx, want_i)
    assert torch.equal(values.view(torch.int32), want_v.view(torch.int32))


def test_topk_kernel_refuses_rows_over_its_limit(full_fp32):
    from dsjax_torch.ops import topk

    with pytest.raises(ValueError, match="at most"):
        topk.topk(torch.zeros((1, topk.MAX_N + 1), device="cuda"), 4)


def beam_problem(b, t, c, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, c)) * 3.0
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lp[0, : t // 2] = np.maximum(lp[0, : t // 2], np.log(1e-30))
    sizes = rng.integers(2, t + 1, b).astype(np.int32)
    sizes[:3] = (0, 1, t)
    return (torch.from_numpy(lp.astype(np.float32)).cuda(), torch.from_numpy(sizes).cuda())


def assert_same_scan(got, want):
    for name, g, w in (("backptr", got[0], want[0]), ("emit", got[1], want[1]),
                       ("h1", got[2][0], want[2][0]), ("h2", got[2][1], want[2][1])):
        assert torch.equal(g, w), name
    torch.testing.assert_close(got[3], want[3], atol=1e-5, rtol=0)
    for i, (g, w) in enumerate(zip(got[4], want[4])):
        if g.dtype == torch.int32:
            assert torch.equal(g, w), f"carry[{i}]"
        else:
            torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


# the four first shapes, then W = 1 (the narrowest), 11 (past evaluation's
# width), 32 and 33 (a warp's width and past it)
@pytest.mark.parametrize("b,t,c,w,blank", [(16, 60, 29, 128, 0), (20, 60, 29, 10, 0),
                                           (3, 25, 6, 32, 2), (4, 9, 4, 128, 0),
                                           (5, 30, 29, 1, 0), (6, 40, 29, 11, 0),
                                           (6, 40, 29, 32, 0), (6, 40, 29, 33, 0)])
def test_fused_beam_scan_matches_plain_scan(full_fp32, b, t, c, w, blank):
    from dsjax_torch.ops import beam

    lp, sizes = beam_problem(b, t, c, seed=t + w)
    before = beam.LAUNCHES
    got = beam.fused_beam_scan(lp, sizes, w, blank)
    torch.cuda.synchronize()
    assert beam.LAUNCHES == before + 1
    want = beam.fused_beam_scan_reference(lp, sizes, w, blank)
    assert_same_scan(got, want)
    assert torch.equal(got[5][1], want[5][1])
    torch.testing.assert_close(got[5][0], want[5][0], atol=1e-5, rtol=0)
    # a stream that switches routes between chunks: resume K7 from the
    # plain scan's carry of the first half, and the reverse
    half = t // 2
    first = beam.fused_beam_scan_reference(lp[:, :half], sizes, w, blank)
    got2 = beam.fused_beam_scan(lp[:, half:], sizes - half, w, blank, carry0=first[4])
    want2 = beam.fused_beam_scan_reference(lp[:, half:], sizes - half, w, blank,
                                           carry0=first[4])
    assert_same_scan(got2, want2)


def signed_zero_problem(b, t, c, w, seed):
    """Posteriors of log-probs 0.0, -0.0, -1 and -2 only (blank 0), and a
    carry whose live slots hold p_b = -0.0 with distinct last chars (slot
    q's is q + 1) and prefixes no slot extends. In the first frame the
    stays score -1 and every extend +0.0, but slot 0's by its last char
    -0.0 + -0.0 = -0.0, first in pool order: K7's float order takes it
    first among the ties, K6's total order after every +0.0."""
    rng = np.random.default_rng(seed)
    lp = rng.choice(np.array([0.0, -0.0, -1.0, -2.0], np.float32), (b, t, c))
    lp[:, 0, 0] = -1.0
    lp[:, 0, 1:] = rng.choice(np.array([0.0, -0.0], np.float32), (b, c - 1))
    lp[:, 0, 1] = -0.0
    sizes = np.full(b, t, np.int32)
    sizes[0] = max(1, t - 1)
    live = min(w, c - 1)
    slot = np.arange(w, dtype=np.int32)
    sentinel = -(slot + 2)
    p_b = np.full((b, w), -1e30, np.float32)
    p_b[:, :live] = -0.0
    last = np.where(slot < live, slot % (c - 1) + 1, -1).astype(np.int32)
    h1 = np.where(slot < live, 7 * slot + 11, sentinel).astype(np.int32)
    h2 = np.where(slot < live, 13 * slot + 5, sentinel).astype(np.int32)
    ph1 = np.where(slot < live, h1 + 100003, sentinel).astype(np.int32)
    ph2 = np.where(slot < live, h2 + 100019, sentinel).astype(np.int32)
    carry = (p_b, np.full((b, w), -1e30, np.float32)) + tuple(
        np.ascontiguousarray(np.broadcast_to(a, (b, w))) for a in (last, h1, h2, ph1, ph2))
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    return cuda(lp), cuda(sizes), tuple(cuda(a) for a in carry)


@pytest.mark.parametrize("w", [4, 40])
def test_fused_beam_scan_on_a_pool_of_signed_zeros(full_fp32, w):
    """K7 against its plain version, bit for bit (floats compared as bits:
    torch.equal takes -0.0 for +0.0), on pools of signed zeros and ties,
    at a narrow beam (W = 4) and a wide one (W = 40)."""
    from dsjax_torch.decode.beam_device import _beam_scan
    from dsjax_torch.ops import beam, topk

    lp, sizes, carry = signed_zero_problem(3, 6, 6, w, seed=w)
    got = beam.fused_beam_scan(lp, sizes, w, 0, carry0=carry)
    want = beam.fused_beam_scan_reference(lp, sizes, w, 0, carry0=carry)
    total_order = _beam_scan(lp, sizes, w, 0, carry0=carry, top_k=topk.topk_reference)
    torch.cuda.synchronize()
    assert not torch.equal(want[1], total_order[1]), "the pool no longer ties -0.0 with +0.0"
    for name, g, r in (("backptr", got[0], want[0]), ("emit", got[1], want[1]),
                       ("h1", got[2][0], want[2][0]), ("h2", got[2][1], want[2][1]),
                       ("order", got[5][1], want[5][1])):
        assert torch.equal(g, r), name
    for i, (g, r) in enumerate(zip((got[3], got[5][0]) + got[4], (want[3], want[5][0]) + want[4])):
        bits = (lambda a: a.view(torch.int32)) if g.dtype == torch.float32 else (lambda a: a)
        assert torch.equal(bits(g), bits(r)), f"output {i}"


def test_backtrack_kernel_matches_plain_version(full_fp32):
    """The backtrack kernel against _backtrack, exactly, on K7's outputs, on
    the scan route's and on a two-chunk K7 stream's second chunk, one
    launch a call; T = 0 gives the slots back."""
    from dsjax_torch.decode.beam_device import _backtrack, _beam_scan
    from dsjax_torch.ops import beam

    lp, sizes = beam_problem(7, 50, 29, seed=11)
    k7 = beam.fused_beam_scan(lp, sizes, 10, 0)
    scan = _beam_scan(lp, sizes, 12, 0)
    first = beam.fused_beam_scan(lp[:, :20], sizes.clamp(max=20), 40, 0)
    second = beam.fused_beam_scan(lp[:, 20:], (sizes - 20).clamp(min=0), 40, 0, carry0=first[4])
    every = lambda w: torch.arange(w, dtype=torch.int32, device="cuda")[None].expand(7, -1)
    for name, (bp, em, order) in (("K7 top 3", (k7[0], k7[1], k7[5][1][:, :3])),
                                  ("scan, every slot", (scan[0], scan[1], every(12))),
                                  ("stream chunk", (second[0], second[1], every(40))),
                                  ("T = 0", (k7[0][:0], k7[1][:0], k7[5][1]))):
        before = beam.BACKTRACK_LAUNCHES
        chars, start = beam.backtrack(bp, em, order)
        torch.cuda.synchronize()
        assert beam.BACKTRACK_LAUNCHES == before + 1, name
        want = _backtrack(bp, em, order)
        assert chars.dtype == torch.int16 and torch.equal(chars, want[0]), name
        assert start.dtype == torch.int32 and torch.equal(start, want[1]), name


def test_beam_decoder_routes_and_launch_counts(full_fp32, monkeypatch):
    """T + 1 K6 launches a decode on the scan route, one K7 launch and no
    K6 on the fused route, one backtrack launch on either; both give the
    plain decode's strings."""
    from dsjax_torch.decode.beam_device import DeviceBeamDecoder
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.ops import beam, topk

    lp, sizes = beam_problem(6, 40, len(DEFAULT_LABELS), seed=3)
    probs = lp.exp()
    dec = DeviceBeamDecoder(DEFAULT_LABELS, beam_width=10)
    want = dec.decode(probs.cpu(), sizes.cpu(), n_best=3, with_scores=True)
    counts = []
    for fused in ("0", "1"):
        monkeypatch.setenv("DSJAX_FUSED_BEAM", fused)
        before = (topk.LAUNCHES, beam.LAUNCHES, beam.BACKTRACK_LAUNCHES)
        got = dec.decode(probs, sizes, n_best=3, with_scores=True)
        torch.cuda.synchronize()
        counts.append((topk.LAUNCHES - before[0], beam.LAUNCHES - before[1],
                       beam.BACKTRACK_LAUNCHES - before[2]))
        assert got[0] == want[0]
        for a, b in zip(got[1], want[1]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(got[2], want[2], atol=1e-5, rtol=0)
    assert counts == [(lp.shape[1] + 1, 0, 1), (0, 1, 1)]


def test_cuda_decode_without_the_library_raises(full_fp32, monkeypatch):
    """No quiet fallback: a CUDA decode whose kernels cannot load raises."""
    from dsjax_torch.decode.beam_device import DeviceBeamDecoder
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.ops import _build

    def refuse():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "load_library", refuse)
    lp, sizes = beam_problem(3, 8, len(DEFAULT_LABELS), seed=4)
    dec = DeviceBeamDecoder(DEFAULT_LABELS, beam_width=4)
    for fused in ("0", "1"):
        monkeypatch.setenv("DSJAX_FUSED_BEAM", fused)
        with pytest.raises(RuntimeError, match="nvcc"):
            dec.decode(lp.exp(), sizes)


@pytest.fixture(scope="module")
def letter_lm(tmp_path_factory):
    """A 3-gram over A-Z (tests/synthetic_lm.py: every word of 1-3 letters,
    20k bigrams and 20k trigrams) as ARPA text."""
    from tests.synthetic_lm import letter_trigram, write_arpa

    path = tmp_path_factory.mktemp("lm") / "letters.arpa"
    return write_arpa(path, letter_trigram(seed=3, n_words=0, n_bi=20000, n_tri=20000))


def bits_equal(a, b):
    """Equal tensors, floats bit for bit (signed zeros told apart)."""
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("b,t,w,top_n,alpha,beta", [(20, 60, 10, 10 ** 9, 0.8, 0.3),
                                                    (6, 40, 32, 10 ** 9, 2.0, -1.0),
                                                    (6, 40, 1, 10 ** 9, 0.8, 0.3),
                                                    (8, 30, 16, 10, 0.8, 0.3)])
def test_lm_scan_k6_matches_plain_top_k(full_fp32, letter_lm, b, t, w, top_n, alpha, beta):
    """The LM-fused scan selecting with K6 (T launches) against the same
    scan on the card with the plain top-k: every output and the whole
    carry, the LM hashes included, bit for bit."""
    from dsjax_torch.decode.beam_device import _beam_scan
    from dsjax_torch.decode.lm_device import DeviceNgramLM
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.ops import topk

    packed = DeviceNgramLM(letter_lm, DEFAULT_LABELS).device("cuda")
    lp, sizes = beam_problem(b, t, len(DEFAULT_LABELS), seed=t + w)
    kw = dict(cutoff_top_n=top_n, lm=packed, alpha=alpha, beta=beta, space=28)
    before = topk.LAUNCHES
    got = _beam_scan(lp, sizes, w, 0, **kw)
    torch.cuda.synchronize()
    assert topk.LAUNCHES == before + t
    want = _beam_scan(lp, sizes, w, 0, top_k=topk.topk_reference, **kw)
    flat = lambda r: (r[0], r[1], *r[2], r[3], *r[4][0], *r[4][1])
    for i, (g, x) in enumerate(zip(flat(got), flat(want))):
        assert bits_equal(g, x), f"output {i}"


def test_score_word_ln_on_the_card_matches_the_cpu(full_fp32, letter_lm):
    """score_word_ln on 4096 sampled words and 2-word contexts: the card's
    scores, pairs and backoff carries equal the CPU's bit for bit."""
    from dsjax_torch.decode import lm_device
    from dsjax_torch.labels import DEFAULT_LABELS

    lm = lm_device.DeviceNgramLM(letter_lm, DEFAULT_LABELS)
    rng = np.random.default_rng(5)
    n = 4096
    letters = rng.integers(2, 28, size=(3 * n, 4))
    lens = rng.integers(1, 5, size=3 * n)
    hashes = np.array([lm_device._word_hash(row[:k].tolist()) for row, k in zip(letters, lens)],
                      np.int64).reshape(3, n, 2)
    ctx = np.stack([hashes[1], hashes[2]], axis=1)                  # (n, 2, 2)
    ctx[: n // 4, 0] = int(lm_device.CTX_ABSENT)                    # shorter histories
    outs = []
    for device in ("cpu", "cuda"):
        packed = lm.device(device)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        outs.append([o.cpu() for o in lm_device.score_word_ln(
            packed, t(hashes[0, :, 0]), t(hashes[0, :, 1]), t(ctx))])
    for g, x in zip(*outs):
        assert bits_equal(g, x)


def test_lm_decode_launches_k6_and_never_k7(full_fp32, letter_lm, monkeypatch):
    """An LM decode on the card: T + 1 K6 launches (a frame, then the
    ranking), one backtrack, and no K7 even under DSJAX_FUSED_BEAM=1; the
    CPU decode's strings and offsets."""
    from dsjax_torch.decode.beam_device import DeviceBeamDecoder
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.ops import beam, topk

    lp, sizes = beam_problem(6, 40, len(DEFAULT_LABELS), seed=8)
    probs = lp.exp()
    dec = DeviceBeamDecoder(DEFAULT_LABELS, beam_width=10, lm_path=letter_lm, alpha=0.8,
                            beta=0.3)
    want = dec.decode(probs.cpu(), sizes.cpu(), n_best=3, with_scores=True)
    for fused in ("0", "1"):
        monkeypatch.setenv("DSJAX_FUSED_BEAM", fused)
        before = (topk.LAUNCHES, beam.LAUNCHES, beam.BACKTRACK_LAUNCHES)
        got = dec.decode(probs, sizes, n_best=3, with_scores=True)
        torch.cuda.synchronize()
        assert (topk.LAUNCHES - before[0], beam.LAUNCHES - before[1],
                beam.BACKTRACK_LAUNCHES - before[2]) == (lp.shape[1] + 1, 0, 1)
        assert got[0] == want[0]
        for a, b in zip(got[1], want[1]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(got[2], want[2], atol=1e-5, rtol=1e-6)


# ---------------------------------------------------------------------------
# K4 (the GRU forward, with and without residuals), K5 (its reverse scan)
# and K8 (the matmul-only chain)
# ---------------------------------------------------------------------------


def gru_problem(shape, dtype, suffix=False, carry=True, empty_row=False):
    """GRU inputs on the card: ragged lengths including 1 and T (and 0 in
    row 1 when asked and B > 2), a suffix mask when asked, a nonzero carry
    when asked."""
    T, B, H, reverse = shape
    D = len(reverse)
    rng = np.random.default_rng(T + 100)
    dev = lambda a, dt=dtype: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to("cuda", dt)
    lengths = rng.integers(0, T + 1, B)
    lengths[0], lengths[-1] = 1, T
    if empty_row and B > 2:
        lengths[1] = 0
    mask = np.arange(T)[:, None] < lengths[None, :]
    mask = dev(mask[::-1] if suffix else mask, torch.float32)
    w_scale = 0.1 if H < 1024 else 0.03              # as problem() takes it
    return (dev(rng.standard_normal((D, T, B, 3 * H)) * 0.3), mask,
            dev(rng.standard_normal((D, 3 * H, H)) * w_scale),
            dev(rng.standard_normal((D, 3 * H)) * 0.1),
            dev(rng.standard_normal((D, B, H)) * 0.3 * carry))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_gru_kernel_matches_plain_version(full_fp32, dtype, shape):
    """K4: y and h_T, prefix and suffix masks, nonzero carry."""
    from dsjax_torch.ops import gru

    for suffix in (False, True):
        args = gru_problem(shape, dtype, suffix)
        before = (gru.LAUNCHES, gru.STEPS)
        out = gru.gru_scan(*args, shape[3])
        torch.cuda.synchronize()
        assert (gru.LAUNCHES, gru.STEPS) == (before[0] + 1, before[1] + shape[0])
        ref = gru.gru_scan_reference(*args, shape[3])
        for o, r in zip(out, ref):
            torch.testing.assert_close(o.float(), r.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES + BWD_SHAPES)
def test_gru_residual_forward_and_reverse_scan_match_plain_versions(full_fp32, dtype, shape):
    """K4 with residuals (y, h_T, (r, z, n, hn)) and K5 on the plain
    forward's residuals with nonzero dh_T: a prefix mask with a nonzero carry
    and a suffix mask with a zero one, each with a zero-length row, at the
    tiling edges of their step product too (BWD_SHAPES)."""
    from dsjax_torch.ops import gru
    from dsjax_torch.ops.lstm import _carried_h_prev

    T, B, H, reverse = shape
    for suffix in (False, True):
        xp, mask, w, b, h0 = gru_problem(shape, dtype, suffix, carry=not suffix, empty_row=True)
        before = (gru.LAUNCHES, gru.RESIDUAL_LAUNCHES, gru.BWD_LAUNCHES)
        out = gru.gru_scan_fwd(xp, mask, w, b, h0, reverse, save_residuals=True)
        torch.cuda.synchronize()
        ref = gru.gru_scan_reference(xp, mask, w, b, h0, reverse, save_residuals=True)
        assert len(out) == len(ref) == 3
        for o, r in zip(out, ref):
            torch.testing.assert_close(o.float(), r.float(), **TOL[dtype])
        y, _, g_seq = ref
        h_prev = _carried_h_prev(y, mask, h0, reverse)
        rng = np.random.default_rng(T + 7)
        dy, dh_t = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to("cuda", dtype)
                    for s in (y.shape, h0.shape))
        got = gru.gru_scan_bwd(g_seq, mask, w, h_prev, dy, dh_t, reverse)
        torch.cuda.synchronize()
        assert (gru.LAUNCHES, gru.RESIDUAL_LAUNCHES, gru.BWD_LAUNCHES) == \
            (before[0], before[1] + 1, before[2] + 1)
        want = gru.gru_scan_backward_reference(g_seq, mask, w, h_prev, dy, dh_t, reverse)
        for o, r in zip(got, want):
            assert o.dtype == dtype and o.shape == r.shape
            torch.testing.assert_close(o.float(), r.float(), **BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_gru_reverse_scan_matches_plain_version_at_the_tiling_edges(full_fp32, dtype, shape):
    """K5 at K3's tiling edges (B=80 crosses the 64-row block, B=1, H=40
    ends inside a CTA's 16 units, and the flagship's width) on the plain
    forward's residuals with nonzero dh_T: a prefix mask with a nonzero carry
    and a suffix mask with a zero one."""
    from dsjax_torch.ops import gru
    from dsjax_torch.ops.lstm import _carried_h_prev

    T, B, H, reverse = shape
    for suffix in (False, True):
        xp, mask, w, b, h0 = gru_problem(shape, dtype, suffix, carry=not suffix)
        y, _, g_seq = gru.gru_scan_reference(xp, mask, w, b, h0, reverse, save_residuals=True)
        h_prev = _carried_h_prev(y, mask, h0, reverse)
        rng = np.random.default_rng(T + 9)
        dy, dh_t = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to("cuda", dtype)
                    for s in (y.shape, h0.shape))
        before = gru.BWD_LAUNCHES
        got = gru.gru_scan_bwd(g_seq, mask, w, h_prev, dy, dh_t, reverse)
        torch.cuda.synchronize()
        assert gru.BWD_LAUNCHES == before + 1
        want = gru.gru_scan_backward_reference(g_seq, mask, w, h_prev, dy, dh_t, reverse)
        for o, r in zip(got, want):
            assert o.dtype == dtype and o.shape == r.shape
            torch.testing.assert_close(o.float(), r.float(), **BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_gru_reverse_scan_kernel_fits_one_cta_an_sm(full_fp32, dtype):
    """K5's step kernel as built: 16 units a CTA, its shared memory within
    the 227 KB a CTA may take, registers within 255 a thread."""
    from dsjax_torch.ops import gru

    attrs = gru.bwd_kernel_attributes(dtype)
    assert attrs["units"] == 16
    assert attrs["static_smem_bytes"] + attrs["dynamic_smem_bytes"] <= 232448
    assert 0 < attrs["registers"] <= 255


def test_differentiated_gru_scan_runs_k4_k5_and_matches_autograd(full_fp32):
    """With inputs that require grad the GRU scan runs K4 with residuals and
    K5 and its gradients match autograd through the plain loop, including a
    reverse direction with a nonzero carry (a suffix mask in scan order); a
    call without grad runs K4 only."""
    from dsjax_torch.ops import gru

    shape = (20, 12, 128, (False, True))
    args = [a.requires_grad_(i != 1) for i, a in enumerate(gru_problem(shape, torch.float32))]
    rng = np.random.default_rng(5)
    weights = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda()
               for s in ((2, 20, 12, 128), (2, 12, 128))]
    counts = (gru.LAUNCHES, gru.RESIDUAL_LAUNCHES, gru.BWD_LAUNCHES)
    out = gru.gru_scan(*args, shape[3])
    grads = torch.autograd.grad(sum((o * wt).sum() for o, wt in zip(out, weights)),
                                [args[i] for i in (0, 2, 3, 4)])
    torch.cuda.synchronize()
    assert (gru.LAUNCHES, gru.RESIDUAL_LAUNCHES, gru.BWD_LAUNCHES) == \
        (counts[0], counts[1] + 1, counts[2] + 1)
    ref = gru.gru_scan_reference(*args, shape[3])
    want = torch.autograd.grad(sum((o * wt).sum() for o, wt in zip(ref, weights)),
                               [args[i] for i in (0, 2, 3, 4)])
    for g, w in zip(grads, want):
        assert g.abs().max() > 0
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        gru.gru_scan(*args, shape[3])
    assert gru.LAUNCHES == counts[0] + 1


@pytest.mark.parametrize("unidirectional", [False, True], ids=["bigru", "unigru_lookahead"])
def test_gru_model_cuda_forward_and_gradients_match_cpu(full_fp32, unidirectional):
    """A GRU model's eval forward and its training gradients on the card
    against the CPU's, with exact K4 / K4-with-residuals / K5 counts."""
    from dsjax_torch.config import BiDirectionalConfig, RNNType, SpectConfig, UniDirectionalConfig
    from dsjax_torch.model.ds2 import DeepSpeech2
    from dsjax_torch.ops import gru

    kw = dict(rnn_type=RNNType.gru, hidden_size=64, hidden_layers=2)
    cfg = (UniDirectionalConfig(lookahead_context=5, **kw) if unidirectional
           else BiDirectionalConfig(**kw))
    cpu = DeepSpeech2(29, SpectConfig(), cfg, generator=torch.Generator().manual_seed(0))
    gpu = DeepSpeech2(29, SpectConfig(), cfg).cuda()
    gpu.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 161, 50)).astype(np.float32))
    lengths = torch.tensor([50, 31, 12, 1], dtype=torch.int32)
    with torch.inference_mode():
        want, _, _ = cpu.eval()(x, lengths)
        before = gru.LAUNCHES
        got, _, _ = gpu.eval()(x.cuda(), lengths.cuda())
        torch.cuda.synchronize()
    assert gru.LAUNCHES == before + cfg.hidden_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-4)
    before = (gru.RESIDUAL_LAUNCHES, gru.BWD_LAUNCHES)
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        out, _, _ = model.train()(x.to(dev), lengths.to(dev))
        torch.log_softmax(out.float(), -1)[..., 1].sum().backward()
    torch.cuda.synchronize()
    assert (gru.RESIDUAL_LAUNCHES, gru.BWD_LAUNCHES) == \
        (before[0] + cfg.hidden_layers, before[1] + cfg.hidden_layers)
    for (name, p), q in zip(cpu.named_parameters(), gpu.parameters()):
        scale = float(p.grad.abs().max())
        torch.testing.assert_close(q.grad.cpu(), p.grad, atol=1e-4 * scale + 1e-6, rtol=1e-4,
                                   msg=lambda m: f"{name}: {m}")


# the microbench's shape (h resident), a partial K atom (H = 32), T = 0, and
# B = 128 (two warpgroups, h streamed through the ring)
@pytest.mark.parametrize("t,b,h", [(512, 64, 1024), (9, 16, 32), (0, 16, 64), (17, 128, 1024)])
def test_mm_chain_kernel_matches_plain_version(full_fp32, t, b, h):
    """K8 against its plain loop: h_T and the last step's full product (bf16
    values of f32 sums; a rounding flipped by the sum order propagates); one
    launch a chain of T > 0 steps, none at T = 0."""
    from dsjax_torch.ops import mm_chain

    rng = np.random.default_rng(t + b)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to("cuda", torch.bfloat16)
    xp = bf(rng.standard_normal((t, b, 4 * h)))
    w = bf(rng.standard_normal((h, 4 * h)) * 0.01)
    h0 = bf(rng.standard_normal((b, h)))
    before = mm_chain.LAUNCHES
    got = mm_chain.mm_chain(xp, w, h0)
    torch.cuda.synchronize()
    assert mm_chain.LAUNCHES == before + (1 if t else 0)
    want = mm_chain.mm_chain_reference(xp, w, h0)
    for g, r in zip(got, want):
        assert g.shape == r.shape and g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), r.float(), **BWD_TOL[torch.bfloat16])


@pytest.mark.parametrize("b", [16, 64, 128])
def test_mm_chain_kernel_fits_its_plan(full_fp32, b):
    """K8's kernel as built: no local memory, one CTA an SM under the plan
    at H = 1024 (h resident up to B = 64, streamed at 128)."""
    from dsjax_torch.ops import _card, mm_chain

    plan = mm_chain.chain_plan(b, 1024, _card.sm_count(torch.device("cuda")))
    attrs = mm_chain.kernel_attributes(plan)
    assert attrs["local_bytes"] == 0 and attrs["cols"] == plan.cols == 32
    assert attrs["static_smem_bytes"] + attrs["dynamic_smem_bytes"] <= _card.SMEM_LIMIT
    assert plan.ctas == 128 and plan.resident == (b <= 64)


# ---------------------------------------------------------------------------
# K1 and K4, the persistent forwards
# ---------------------------------------------------------------------------

# (T, B, H, reverse, suffix mask and a zero-length row): the flagship's width
# (the f32 LSTM's last gate in registers), its evaluation batch (B = 20: one
# f32 pass of 20 rows over the registers), a unit edge inside the last CTA
# (H=1032: 65 CTAs of 16 units, the last with 8, f32 LSTM rows streamed;
# H=1000: the last of 63 CTAs with 8 units and a short last chunk, with
# register rows, in a pass of 12 rows), B = 1, 20 and 64 (more passes over
# the resident rows; at H=1024 f32 in four of 16), T = 0 and 1, one
# direction under a suffix mask, and B = 160 (the f32 LSTM streams 3 rows
# beside its registers, in passes of 16)
PERSISTENT_SHAPES = [
    (40, 8, 1024, (False, True), False), (6, 20, 1024, (False, True), False),
    (9, 5, 1032, (False, True), False), (11, 9, 1000, (False, True), False),
    (10, 1, 128, (True,), False), (12, 20, 256, (False, True), False),
    (7, 64, 1024, (False, True), False), (0, 4, 64, (False, True), False),
    (1, 3, 64, (False, True), False), (33, 6, 1024, (False,), True),
    (5, 160, 1024, (False, True), False)]


def scan_case(rnn, shape, dtype):
    from dsjax_torch.ops import gru

    T, B, H, reverse, suffix = shape
    if rnn == "lstm":
        return lstm, problem((T, B, H, reverse), dtype, suffix, empty_row=suffix)
    return gru, gru_problem((T, B, H, reverse), dtype, suffix, empty_row=suffix)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", PERSISTENT_SHAPES)
@pytest.mark.parametrize("rnn", ["lstm", "gru"])
def test_persistent_scan_matches_plain_version(full_fp32, rnn, dtype, shape):
    """K1 and K4: every output against the plain loop, one launch a call
    (none at T = 0) and T steps counted."""
    T, B, H, reverse, _ = shape
    mod, args = scan_case(rnn, shape, dtype)
    scan = mod.lstm_scan if rnn == "lstm" else mod.gru_scan
    before = (mod.LAUNCHES, mod.STEPS)
    out = scan(*args, reverse)
    torch.cuda.synchronize()
    assert (mod.LAUNCHES, mod.STEPS) == (before[0] + (T > 0), before[1] + T)
    ref = (mod.lstm_scan_reference if rnn == "lstm" else mod.gru_scan_reference)(*args, reverse)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert o.dtype == dtype and o.shape == r.shape
        torch.testing.assert_close(o.float(), r.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("n_dir", [2, 1])
@pytest.mark.parametrize("rnn", ["lstm", "gru"])
def test_persistent_scan_kernel_fits_its_plan(full_fp32, rnn, n_dir, dtype):
    """K1's and K4's kernels as built under the serving plan (H=1024, B=8):
    one CTA an SM within 227 KB, no local memory, 16 units a CTA with two
    directions and 8 with one, no W_hh row streamed: every row resident in
    shared memory, but for the LSTM's f32 with two directions, which keeps
    its last gate's 16 rows in registers."""
    from dsjax_torch.ops import gru

    mod, gates = (lstm, 4) if rnn == "lstm" else (gru, 3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = lstm.scan_plan(n_dir, 1024, gates, dtype, 8, sms)
    attrs = mod.scan_kernel_attributes(dtype, plan)
    assert attrs["local_bytes"] == 0
    assert 0 < attrs["registers"] <= 255
    assert attrs["static_smem_bytes"] + attrs["dynamic_smem_bytes"] <= 232448
    assert attrs["units"] == (16 if n_dir == 2 else 8) and attrs["ctas"] * n_dir <= sms
    in_registers = rnn == "lstm" and n_dir == 2 and dtype == torch.float32
    assert attrs["register_rows"] == (16 if in_registers else 0)
    assert attrs["streamed_rows"] == 0 and attrs["resident_share"] == 1.0
    assert attrs["resident_rows"] + attrs["register_rows"] == gates * attrs["units"]


# f32 at the batch edges of the plan's rows a pass (H=1024): one pass of 8
# rows up to B = 8, B = 9 one of 12, 17 and 20 one of 20, 24 two of 12, 40
# two of 20
WIDE_BATCHES = [1, 8, 9, 17, 20, 24, 40]


@pytest.mark.parametrize("n_b", WIDE_BATCHES)
@pytest.mark.parametrize("reverse", [(False, True), (True,)], ids=["2 dir", "1 dir"])
@pytest.mark.parametrize("rnn", ["lstm", "gru"])
def test_persistent_scan_takes_the_batch_in_wide_f32_passes(full_fp32, rnn, reverse, n_b):
    """K1 and K4 in f32 with ragged lengths, both directions (the LSTM's
    last gate in registers) and one: every output against the plain loop,
    and WIDE_PASS_LAUNCHES counting the calls whose plan takes more than 8
    rows a pass (those past B = 8)."""
    T, H = 23, 1024
    mod, args = scan_case(rnn, (T, n_b, H, reverse, False), torch.float32)
    scan = mod.lstm_scan if rnn == "lstm" else mod.gru_scan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = lstm.scan_plan(len(reverse), H, 4 if rnn == "lstm" else 3, torch.float32, n_b, sms)
    assert (plan.pass_rows > 8) == (n_b > 8)
    before = (mod.LAUNCHES, mod.WIDE_PASS_LAUNCHES)
    out = scan(*args, reverse)
    torch.cuda.synchronize()
    assert (mod.LAUNCHES, mod.WIDE_PASS_LAUNCHES) == (before[0] + 1, before[1] + (n_b > 8))
    ref = (mod.lstm_scan_reference if rnn == "lstm" else mod.gru_scan_reference)(*args, reverse)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, **TOL[torch.float32])


@pytest.mark.parametrize("n_b", [9, 13, 20, 160])
@pytest.mark.parametrize("n_dir", [2, 1])
@pytest.mark.parametrize("rnn", ["lstm", "gru"])
def test_persistent_scan_wide_passes_fit_their_plans(full_fp32, rnn, n_dir, n_b):
    """The f32 kernels of 12, 16 and 20 rows a pass, with register rows
    (the LSTM, two directions) and without: one CTA an SM within 227 KB,
    no local memory."""
    from dsjax_torch.ops import gru

    mod, gates = (lstm, 4) if rnn == "lstm" else (gru, 3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = lstm.scan_plan(n_dir, 1024, gates, torch.float32, n_b, sms)
    assert plan.pass_rows > 8
    attrs = mod.scan_kernel_attributes(torch.float32, plan)
    assert attrs["local_bytes"] == 0 and 0 < attrs["registers"] <= 255
    assert attrs["static_smem_bytes"] + attrs["dynamic_smem_bytes"] <= 232448
    assert attrs["pass_rows"] == plan.pass_rows
    assert attrs["register_rows"] == (16 if rnn == "lstm" and n_dir == 2 else 0)


def test_persistent_scan_beside_a_second_stream(full_fp32):
    """K1 on one stream while K2 runs on another: both finish and match."""
    shape = (24, 8, 256, (False, True))
    args = problem(shape, torch.float32)
    train_args = problem((20, 16, 256, (False, True)), torch.float32)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        res = lstm.lstm_scan_fwd(*train_args, (False, True), save_residuals=True)
    out = lstm.lstm_scan(*args, shape[3])
    torch.cuda.synchronize()
    for o, r in zip(out, lstm.lstm_scan_reference(*args, shape[3])):
        torch.testing.assert_close(o, r, **TOL[torch.float32])
    want = lstm.lstm_scan_reference(*train_args, (False, True), save_residuals=True)
    for o, r in zip(res, want):
        torch.testing.assert_close(o, r, **TOL[torch.float32])


def test_persistent_scan_refuses_a_plan_it_does_not_take(full_fp32, monkeypatch):
    """The C entry point checks the plan again: one whose shared memory
    disagrees with its layout raises, naming the launch; nothing runs."""
    shape = (5, 4, 64, (False, True))
    args = problem(shape, torch.float32)
    good = lstm.scan_plan
    monkeypatch.setattr(lstm, "scan_plan", lambda *a: good(*a)._replace(
        smem_bytes=good(*a).smem_bytes + 16))
    before = lstm.LAUNCHES
    with pytest.raises(RuntimeError, match="lstm_fwd launch"):
        lstm.lstm_scan(*args, shape[3])
    assert lstm.LAUNCHES == before


@pytest.mark.parametrize("spec", ["cuda:0,cuda:0", "cuda"], ids=["one card twice", "every card"])
def test_replicated_bundle_matches_one_card(full_fp32, spec, monkeypatch):
    """The data-parallel bundle on two replicas sharing cuda:0, and on every
    card where there are two or more: an 8-row raw-audio batch in row
    shards, one K1 launch a layer and shard, the shards' posteriors
    gathered onto cuda:0 within the f32 tolerance of one card's, out_lens
    equal; greedy, the scan-route beam (T + 1 K6 launches) and K7's route
    (one K7 and one backtrack) give one card's strings."""
    from dsjax_torch.audio.features import pad_audio_for_device
    from dsjax_torch.config import BiDirectionalConfig, SpectConfig
    from dsjax_torch.decode.beam_device import DeviceBeamDecoder
    from dsjax_torch.decode.greedy import GreedyDecoder
    from dsjax_torch.inference import ModelBundle
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.model.ds2 import DeepSpeech2
    from dsjax_torch.ops import beam, topk

    if spec == "cuda" and torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    layers = 2
    model = DeepSpeech2(len(DEFAULT_LABELS), SpectConfig(),
                        BiDirectionalConfig(hidden_size=256, hidden_layers=layers),
                        generator=torch.Generator().manual_seed(5))
    dp = ModelBundle(model, list(DEFAULT_LABELS), SpectConfig(), spec)
    one = ModelBundle(model, list(DEFAULT_LABELS), SpectConfig(), "cuda:0")
    n = len(dp.devices)
    assert n >= 2 and all(d.type == "cuda" and d.index is not None for d in dp.devices)
    rng = np.random.default_rng(11)
    ys = [rng.standard_normal(int(16000 * s)).astype(np.float32) * 0.1
          for s in rng.uniform(0.5, 2.0, 8)]
    n_valid = np.array([pad_audio_for_device(y, SpectConfig())[1] for y in ys], np.int32)
    audio = np.stack([np.clip(np.rint(pad_audio_for_device(y, SpectConfig(), int(n_valid.max()))[0]
                                      * 32768.0), -32768, 32767).astype(np.int16) for y in ys])
    before = lstm.LAUNCHES
    probs, out_lens, _ = dp.forward(audio, n_valid)
    torch.cuda.synchronize()
    assert lstm.LAUNCHES - before == dp.shards(8) * layers
    assert probs.device == out_lens.device == torch.device("cuda", 0)
    want, want_lens, _ = one.forward(audio, n_valid)
    assert torch.equal(out_lens, want_lens)
    torch.testing.assert_close(probs, want, **TOL[torch.float32])
    t_dim = want.shape[1]
    for name, dec, fused, expected in (
            ("greedy", GreedyDecoder(DEFAULT_LABELS), "0", (0, 0, 0)),
            ("scan", DeviceBeamDecoder(DEFAULT_LABELS, beam_width=10), "0", (t_dim + 1, 0, 1)),
            ("K7", DeviceBeamDecoder(DEFAULT_LABELS, beam_width=10), "1", (0, 1, 1))):
        monkeypatch.setenv("DSJAX_FUSED_BEAM", fused)
        before = (topk.LAUNCHES, beam.LAUNCHES, beam.BACKTRACK_LAUNCHES)
        got = dec.decode(probs, out_lens, n_best=1)[0]
        torch.cuda.synchronize()
        counts = (topk.LAUNCHES - before[0], beam.LAUNCHES - before[1],
                  beam.BACKTRACK_LAUNCHES - before[2])
        assert counts == expected, name
        assert got == dec.decode(want, want_lens, n_best=1)[0], name
