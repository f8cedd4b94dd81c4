"""dsjax_torch.ops.gru (K4's plain version and its wrapper) against dsjax's
Pallas GRU scan (CPU), and the full-width GRU models against the golden
fixture.

The port's plain version, and its wrapper on CPU tensors, are held against
dsjax's ``gru_scan`` in Pallas interpret mode (as tests/test_gru_pallas.py
runs it; its route needs H % 128 == 0 and B % 8 == 0) and against dsjax's
``gru_scan_reference``; the residuals (r, z, n, hn) against
``_gru_fwd_pallas(save_residuals=True)``. Tolerances: f32 atol 1e-5, rtol
1e-4 (sum order only); bf16 atol 3e-2 (the carry is rounded to bf16 every
step, and a different f32 sum order can flip a rounding). The kernels
themselves run only on a CUDA card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dsjax.ops.gru_pallas import _gru_fwd_pallas
from dsjax.ops.gru_pallas import gru_scan as jax_gru_scan
from dsjax.ops.gru_pallas import gru_scan_reference as jax_gru_scan_reference
from dsjax_torch.ops import gru, lstm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"float32": dict(atol=1e-5, rtol=1e-4), "bfloat16": dict(atol=3e-2, rtol=0.0)}
# mask shape of the scan, and whether the carry h0 is nonzero
MASKS = {"prefix_mask_carry": (False, True), "suffix_mask_zero_carry": (True, False),
         "suffix_mask_carry": (True, True)}


def problem(seed, D=1, T=12, B=8, H=128, suffix=False, carry=True):
    """f32 numpy inputs in dsjax's layout (w (D, H, 3H)): ragged lengths
    including 0, 1 and T, a suffix mask when asked (the time-flipped padded
    stream of a reverse direction)."""
    rng = np.random.default_rng(seed)
    xp = (rng.standard_normal((D, T, B, 3 * H)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((D, H, 3 * H)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((D, 3 * H)) * 0.1).astype(np.float32)
    h0 = (rng.standard_normal((D, B, H)) * 0.3).astype(np.float32) * carry
    lengths = np.full((B,), T)
    lengths[1::2] = T // 2
    if B > 3:
        lengths[2], lengths[3] = 1, 0
    mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    if suffix:
        mask = np.ascontiguousarray(mask[::-1])
    return xp, mask, w, b, h0


def to_port(dtype, xp, mask, w, b, h0):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    return t(xp), torch.from_numpy(mask), t(np.swapaxes(w, 1, 2)), t(b), t(h0)


def dsjax_scan(fn, d, dtype, xp, mask, w, b, h0, flip=False):
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x, m = (xp[d][::-1], mask[::-1]) if flip else (xp[d], mask)
    args = [jnp.asarray(np.ascontiguousarray(a), jd) for a in (x, m, w[d], b[d], h0[d])]
    if fn is jax_gru_scan:
        args[1] = args[1].astype(jnp.float32)
        out = fn(*args, True)
    else:
        out = fn(*args)
    y, h = (np.asarray(o.astype(jnp.float32)) for o in out)
    return (y[::-1] if flip else y), h


def assert_close(port_out, jax_out, dtype):
    for p, j in zip(port_out, jax_out):
        np.testing.assert_allclose(p.float().numpy(), j, **TOL[str(dtype).split(".")[1]])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("jax_fn", [jax_gru_scan, jax_gru_scan_reference],
                         ids=["pallas_interpret", "lax_scan"])
@pytest.mark.parametrize("masks", list(MASKS))
def test_forward_direction_matches_dsjax(dtype, jax_fn, masks):
    suffix, carry = MASKS[masks]
    xp, mask, w, b, h0 = problem(0, suffix=suffix, carry=carry)
    want = dsjax_scan(jax_fn, 0, dtype, xp, mask, w, b, h0)
    args = to_port(dtype, xp, mask, w, b, h0)
    for fn in (gru.gru_scan_reference, gru.gru_scan):
        y, h = fn(*args, reverse=(False,))
        assert y.dtype == dtype and y.shape == (1, 12, 8, 128) and h.shape == (1, 8, 128)
        assert_close((y[0], h[0]), want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [(False, True), (True, False)], ids=["fwd_bwd", "bwd_fwd"])
def test_both_directions_in_one_call_match_dsjax_flip(dtype, reverse):
    """A reversed direction equals dsjax's backward direction: flip the
    whole padded array and the mask, scan, flip y back."""
    xp, mask, w, b, h0 = problem(1, D=2)
    y, h = gru.gru_scan(*to_port(dtype, xp, mask, w, b, h0), reverse=reverse)
    for d, rev in enumerate(reverse):
        want = dsjax_scan(jax_gru_scan, d, dtype, xp, mask, w, b, h0, flip=rev)
        assert_close((y[d], h[d]), want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_residual_forward_plain_matches_dsjax(dtype):
    """K4 with residuals: y, h_T and (r, z, n, hn), stored at natural time
    for a reversed direction (dsjax stores them in its flipped time)."""
    reverse = (False, True)
    xp, mask, w, b, h0 = problem(2, D=2)
    y, h, g_seq = gru.gru_scan_reference(*to_port(dtype, xp, mask, w, b, h0), reverse,
                                         save_residuals=True)
    assert g_seq.shape == (2, 12, 8, 4 * 128) and g_seq.dtype == dtype
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    for d, rev in enumerate(reverse):
        f = (lambda a: np.ascontiguousarray(a[::-1])) if rev else (lambda a: a)
        jy, jh, jg = (np.asarray(o.astype(jnp.float32)) for o in _gru_fwd_pallas(
            jnp.asarray(f(xp[d]), jd), jnp.asarray(f(mask)), jnp.asarray(w[d], jd),
            jnp.asarray(b[d], jd), jnp.asarray(h0[d], jd), True, save_residuals=True))
        assert_close((y[d], h[d], g_seq[d]), (f(jy), jh, f(jg)), dtype)


def test_carry_freezes_and_outputs_zero_past_length():
    xp, mask, w, b, h0 = problem(3)
    args = to_port(torch.float32, xp, mask, w, b, h0)
    y, h = gru.gru_scan(*args, reverse=(False,))
    # row 2 has length 1, row 3 length 0: its carry is h0 untouched
    one = [a[:, :1] if a.dim() == 4 else a for a in args]
    one[1] = args[1][:1]
    _, h1 = gru.gru_scan(*one, reverse=(False,))
    torch.testing.assert_close(h[0, 2], h1[0, 2], rtol=0, atol=1e-6)
    torch.testing.assert_close(h[0, 3], args[4][0, 3], rtol=0, atol=0)
    assert torch.all(y[0, 1:, 2] == 0) and torch.all(y[0, :, 3] == 0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    xp, mask, w, b, h0 = problem(4, T=4, B=2, H=16)
    args = list(to_port(torch.float32, xp, mask, w, b, h0))
    gru.gru_scan(*args, reverse=(False,))
    bad = {
        "dtype": (0, args[0].double(), TypeError),
        "mask dtype": (1, args[1].bool(), TypeError),
        "shape": (2, args[2][:, :, :8], ValueError),
        "contiguity": (4, args[4].transpose(1, 2).contiguous().transpose(1, 2), ValueError),
        "alignment": (2, torch.empty(args[2].numel() + 1).narrow(0, 1, args[2].numel())
                      .view_as(args[2]).copy_(args[2]), ValueError),
    }
    for name, (i, value, exc) in bad.items():
        a = list(args)
        a[i] = value
        with pytest.raises(exc):
            gru.gru_scan(*a, reverse=(False,))
    with pytest.raises(ValueError, match="directions"):
        gru.gru_scan(*args, reverse=(False, True))
    odd = problem(5, T=3, B=2, H=12)
    with pytest.raises(ValueError, match="multiple of 8"):
        gru.gru_scan(*to_port(torch.float32, *odd), reverse=(False,))
    with pytest.raises(ValueError, match="cuda or cpu"):
        gru.gru_scan(*[a.to("meta") for a in args], reverse=(False,))


def test_reverse_scan_wrapper_rejects_what_the_kernel_does_not_take():
    """gru_scan_bwd checks K5's inputs on every device, so the messages
    show here: H not a multiple of 8, shapes, dtypes, contiguity, and an
    input off a two-element boundary."""
    rng = np.random.default_rng(8)

    def args(H=16, T=3, B=2, D=2):
        r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        return [r(D, T, B, 4 * H), torch.ones(T, B), r(D, 3 * H, H), r(D, T, B, H),
                r(D, T, B, H), r(D, B, H)]

    def offset(a):
        """a contiguous copy of a, one element into its storage"""
        return torch.empty(a.numel() + 1).narrow(0, 1, a.numel()).view_as(a).copy_(a)

    good = args()
    dxp, dh0 = gru.gru_scan_bwd(*good, (False, True))
    assert dxp.shape == (2, 3, 2, 48) and dh0.shape == (2, 2, 16)
    bad = {
        "multiple of 8": (None, args(H=12), ValueError),
        "g_seq must start on a boundary of two elements": (0, offset(good[0]), ValueError),
        "h_prev must start on a boundary": (3, offset(good[3]), ValueError),
        "dy must start on a boundary": (4, offset(good[4]), ValueError),
        "w_hh must be": (2, good[2][:, :, :8], ValueError),
        "mask must be torch.float32": (1, good[1].double(), TypeError),
        "g_seq dtype": (0, good[0].double(), TypeError),
        r"dh_T must be \(2, 2, 16\)": (5, good[5][:, :1], ValueError),
        "g_seq must be contiguous": (0, good[0].transpose(2, 3).contiguous().transpose(2, 3),
                                     ValueError),
    }
    for match, (i, value, exc) in bad.items():
        a = value if i is None else good[:i] + [value] + good[i + 1:]
        with pytest.raises(exc, match=match):
            gru.gru_scan_bwd(*a, (False, True))
    with pytest.raises(ValueError, match="directions"):
        gru.gru_scan_bwd(*good, (False,))
    with pytest.raises(ValueError, match="cuda or cpu"):
        gru.gru_scan_bwd(*[a.to("meta") for a in good], (False, True))


def test_residual_forward_wrapper_rejects_inputs_off_a_pair_boundary():
    """K4 with residuals reads xp and b_hh a unit pair at a time, so
    gru_scan_fwd with residuals, and the differentiated gru_scan through it,
    check both on every device; K4, which reads them one element at a time,
    takes them."""
    xp, mask, w, b, h0 = problem(9, T=3, B=2, H=16)
    args = list(to_port(torch.float32, xp, mask, w, b, h0))

    def offset(a):
        """a contiguous copy of a, one element into its storage"""
        return torch.empty(a.numel() + 1).narrow(0, 1, a.numel()).view_as(a).copy_(a)

    for i, name in ((0, "xp"), (3, "b_hh")):
        a = args[:i] + [offset(args[i])] + args[i + 1:]
        with pytest.raises(ValueError, match=f"{name} must start on a boundary of two elements"):
            gru.gru_scan_fwd(*a, (False,), save_residuals=True)
        with pytest.raises(ValueError, match=f"{name} must start on a boundary"):
            gru.gru_scan(*[t.requires_grad_(k == 0) for k, t in enumerate(a)], (False,))
        want = gru.gru_scan_fwd(*args, (False,))
        for got, ref in zip(gru.gru_scan_fwd(*a, (False,)), want):
            torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_cpu_path_counts_no_launch_and_import_loads_nothing():
    xp, mask, w, b, h0 = problem(6, T=3, B=2, H=16)
    before = (gru.LAUNCHES, gru.RESIDUAL_LAUNCHES, gru.BWD_LAUNCHES)
    gru.gru_scan(*to_port(torch.float32, xp, mask, w, b, h0), reverse=(False,))
    assert (gru.LAUNCHES, gru.RESIDUAL_LAUNCHES, gru.BWD_LAUNCHES) == before
    code = ("import sys\n"
            "import dsjax_torch.ops.gru, dsjax_torch.ops.mm_chain\n"
            "from dsjax_torch.ops import _build\n"
            "assert _build._lib is None\n"
            "assert 'triton' not in sys.modules and 'jax' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_mm_chain_plain_version_is_the_pallas_chain():
    """K8's plain version: z = h . W + xp[t] over 4H columns in f32, then
    h <- z[:, :H] in bf16 (tools/lstm_microbench.py:_mm_kernel), computed
    here in numpy step by step."""
    from dsjax_torch.ops import mm_chain

    rng = np.random.default_rng(7)
    T, B, H = 5, 16, 32
    xp = torch.from_numpy(rng.standard_normal((T, B, 4 * H)).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.standard_normal((H, 4 * H)) * 0.1).astype(np.float32)).bfloat16()
    h0 = torch.from_numpy(rng.standard_normal((B, H)).astype(np.float32)).bfloat16()
    h, z = mm_chain.mm_chain(xp, w, h0)
    want_h = h0
    for t in range(T):
        want_z = (want_h.float().numpy() @ w.float().numpy() + xp[t].float().numpy())
        want_z = torch.from_numpy(want_z).bfloat16()
        want_h = want_z[:, :H]
    assert h.shape == (B, H) and z.shape == (B, 4 * H) and mm_chain.LAUNCHES == 0
    torch.testing.assert_close(z.float(), want_z.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(h.float(), want_h.float(), atol=2e-2, rtol=2e-2)
    with pytest.raises(ValueError, match="multiples of 16"):
        mm_chain.mm_chain(xp[:, :8], w, h0[:8])
    with pytest.raises(TypeError):
        mm_chain.mm_chain(xp.float(), w, h0)


@pytest.mark.parametrize("name", ["bigru", "unigru"])
def test_full_width_models_match_the_golden_fixture(name):
    """5 x BiGRU-1024 and 5 x GRU-1024 + Lookahead 20 (tests/golden_gru.py)
    against dsjax's posteriors in tests/fixtures/golden_gru.npz, at the
    golden tolerance, on the CPU."""
    from dsjax_torch.config import SpectConfig
    from dsjax_torch.model.convert import from_reference_state_dict, infer_architecture
    from dsjax_torch.model.ds2 import DeepSpeech2
    from tests.golden_gru import GOLDEN_TOL, gru_input, gru_state

    golden = np.load(os.path.join(ROOT, "tests", "fixtures", "golden_gru.npz"))
    state = gru_state(name)
    model_cfg, classes = infer_architecture(state)
    model = DeepSpeech2(classes, SpectConfig(), model_cfg)
    model.load_state_dict(from_reference_state_dict(state))
    del state
    x, lengths = gru_input()
    with torch.inference_mode():
        probs, out_lens, _ = model.eval()(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_array_equal(out_lens.numpy(), golden[f"{name}_out_lens"])
    for i, n in enumerate(golden[f"{name}_out_lens"]):
        np.testing.assert_allclose(probs[i, :n].numpy(), golden[f"{name}_probs"][i, :n],
                                   atol=GOLDEN_TOL[0], rtol=GOLDEN_TOL[1])


# the persistent scan's plan for K4 (three gates), as tests/test_torch_lstm.py
# holds K1's


@pytest.mark.parametrize("n_dir,n_h,dtype,n_b,sms", [
    (2, 1024, torch.float32, 8, 132), (1, 1024, torch.float32, 1, 132),
    (1, 1024, torch.bfloat16, 8, 132), (2, 1024, torch.float32, 64, 132),
    (2, 1032, torch.bfloat16, 20, 132), (2, 4096, torch.float32, 64, 132),
    (1, 4096, torch.bfloat16, 8, 132), (2, 2048, torch.float32, 8, 100),
    # f32 past 8 rows: wider passes
    (2, 1024, torch.float32, 9, 132), (2, 1024, torch.float32, 16, 132),
    (2, 1024, torch.float32, 20, 132), (2, 1024, torch.float32, 24, 132),
    (2, 1024, torch.float32, 40, 132), (1, 1024, torch.float32, 20, 132),
    (2, 1032, torch.float32, 17, 132)])
def test_scan_plan_covers_every_unit_and_fits_a_cta(n_dir, n_h, dtype, n_b, sms):
    from tests.test_torch_lstm import check_plan

    check_plan(lstm.scan_plan(n_dir, n_h, 3, dtype, n_b, sms), n_dir, n_h, 3, dtype, sms, n_b)


def test_scan_plan_at_the_flagship_width():
    """H=1024 on 132 SMs: the BiGRU keeps all 48 rows of a CTA resident in
    f32 and bf16, and in f32 takes an evaluation batch of 20 rows in one
    pass (8 rows a pass up to B = 8); the streaming model's one direction
    takes 8 units a CTA."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = lstm.scan_plan(2, 1024, 3, dtype, 8, 132)
        assert (plan.units, plan.ctas, plan.streamed_rows) == (16, 64, 0)
    one = lstm.scan_plan(1, 1024, 3, torch.float32, 1, 132)
    assert (one.units, one.ctas, one.streamed_rows) == (8, 128, 0)
    assert lstm.scan_plan(2, 1024, 3, torch.float32, 8, 132).pass_rows == 8
    for n_dir in (2, 1):
        wide = lstm.scan_plan(n_dir, 1024, 3, torch.float32, 20, 132)
        assert (wide.pass_rows, wide.streamed_rows, wide.register_rows) == (20, 0, 0)


@pytest.mark.parametrize("n_dir,n_h,n_b,sms,match", [
    (1, 4096, 8, 8, "column tiles"), (2, 1024, 6000, 132, "shared memory")])
def test_scan_plan_raises_where_no_plan_fits(n_dir, n_h, n_b, sms, match):
    with pytest.raises(ValueError, match=match):
        lstm.scan_plan(n_dir, n_h, 3, torch.float32, n_b, sms)
