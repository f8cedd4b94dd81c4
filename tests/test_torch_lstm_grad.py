"""The LSTM scan's training path against dsjax's Pallas kernels (CPU).

The plain versions of K2 (``lstm_scan_reference(save_residuals=True)``) and
K3 (``lstm_scan_backward_reference``) are held against dsjax's
``_lstm_fwd_pallas(save_residuals=True)`` and ``_lstm_bwd_pallas`` in Pallas
interpret mode, and the port's differentiated ``lstm_scan`` (the autograd
Function, which on CPU tensors runs those two plain versions) against
``jax.grad`` of dsjax's ``lstm_scan`` custom VJP. Tolerances: K2 f32
atol/rtol 1e-5 and K3 f32 atol 1e-5, rtol 1e-4 (sum order only); the
Function's gradients f32 atol 2e-4, rtol 2e-3 (dsjax's own gradient
tolerance, tests/test_lstm_pallas.py) and bf16 atol 4e-2, rtol 4e-2 (every
residual, dgate and carry rounds to bf16, and the two frameworks round
bf16 products and sums at different places). The kernels themselves run
only on a card (tests/test_torch_cuda.py, chip_smoke.py).

dsjax stores a reverse direction's residuals in flipped time (it scans the
flipped arrays); the port stores them at natural time, so the comparison
flips them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dsjax.ops.lstm_pallas import _lstm_bwd_pallas, _lstm_fwd_pallas
from dsjax.ops.lstm_pallas import lstm_scan as jax_lstm_scan
from dsjax_torch.ops import lstm

CASES = {"bidirectional_prefix_mask": ((False, True), False),
         "forward_suffix_mask": ((False,), True),
         "reverse_suffix_mask": ((True,), True)}


def problem(seed, reverse, suffix, T=12, B=8, H=128):
    """f32 numpy inputs in dsjax's layout: ragged lengths including 1 and T,
    nonzero initial carry; a suffix mask when asked (the time-flipped
    padded stream of a reverse direction)."""
    D = len(reverse)
    rng = np.random.default_rng(seed)
    xp = (rng.standard_normal((D, T, B, 4 * H)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((D, H, 4 * H)) * 0.1).astype(np.float32)   # (H, 4H) as dsjax
    b = (rng.standard_normal((D, 4 * H)) * 0.1).astype(np.float32)
    h0 = (rng.standard_normal((D, B, H)) * 0.1).astype(np.float32)
    c0 = (rng.standard_normal((D, B, H)) * 0.1).astype(np.float32)
    lengths = np.full((B,), T)
    lengths[1::2] = T // 2
    lengths[2] = 1
    mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    if suffix:
        mask = np.ascontiguousarray(mask[::-1])
    return xp, mask, w, b, h0, c0


def port(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def flip(a, rev):
    return np.ascontiguousarray(a[::-1]) if rev else a


def jax_direction(d, rev, dtype, xp, mask, w, b, h0, c0):
    """Direction d's inputs as dsjax scans them (flipped time if reverse)."""
    return ([jnp.asarray(flip(xp[d], rev), dtype), jnp.asarray(flip(mask, rev), jnp.float32)]
            + [jnp.asarray(a[d], dtype) for a in (w, b, h0, c0)])


@pytest.mark.parametrize("case", list(CASES))
def test_residual_forward_plain_matches_dsjax(case):
    """K2's plain version: y, h_T, c_T and the residuals c_seq, gates."""
    reverse, suffix = CASES[case]
    xp, mask, w, b, h0, c0 = problem(0, reverse, suffix)
    y, h_t, c_t, g_seq, c_seq = lstm.lstm_scan_reference(
        port(xp), port(mask), port(np.swapaxes(w, 1, 2)), port(b), port(h0), port(c0),
        reverse, save_residuals=True)
    for d, rev in enumerate(reverse):
        jy, jh, jc, jc_seq, jg_seq = (np.asarray(o) for o in _lstm_fwd_pallas(
            *jax_direction(d, rev, jnp.float32, xp, mask, w, b, h0, c0), interpret=True,
            save_residuals=True))
        for name, got, want in (("y", y[d], flip(jy, rev)), ("h_T", h_t[d], jh),
                                ("c_T", c_t[d], jc), ("c_seq", c_seq[d], flip(jc_seq, rev)),
                                ("gates", g_seq[d], flip(jg_seq, rev))):
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5,
                                       err_msg=f"{name}, direction {d}")


@pytest.mark.parametrize("case", list(CASES))
def test_reverse_scan_plain_matches_dsjax(case):
    """K3's plain version on dsjax's own residuals, nonzero dh_T and dc_T."""
    reverse, suffix = CASES[case]
    xp, mask, w, b, h0, c0 = problem(1, reverse, suffix)
    D, T, B, G = xp.shape
    rng = np.random.default_rng(2)
    dy = rng.standard_normal((D, T, B, G // 4)).astype(np.float32)
    dh_t = rng.standard_normal((D, B, G // 4)).astype(np.float32)
    dc_t = rng.standard_normal((D, B, G // 4)).astype(np.float32)
    g_seq, c_seq, want = [], [], []
    for d, rev in enumerate(reverse):
        args = jax_direction(d, rev, jnp.float32, xp, mask, w, b, h0, c0)
        _, _, _, jc_seq, jg_seq = _lstm_fwd_pallas(*args, interpret=True, save_residuals=True)
        want.append([np.asarray(o) for o in _lstm_bwd_pallas(
            jg_seq, args[1], args[2], args[5], jc_seq, jnp.asarray(flip(dy[d], rev)),
            jnp.asarray(dh_t[d]), jnp.asarray(dc_t[d]), True)])
        g_seq.append(flip(np.asarray(jg_seq), rev))
        c_seq.append(flip(np.asarray(jc_seq), rev))
    dg, dh0, dc0 = lstm.lstm_scan_backward_reference(
        port(np.stack(g_seq)), port(mask), port(np.swapaxes(w, 1, 2)), port(c0),
        port(np.stack(c_seq)), port(dy), port(dh_t), port(dc_t), reverse)
    for d, rev in enumerate(reverse):
        for name, got, w_ in (("dgates", dg[d], flip(want[d][0], rev)),
                              ("dh0", dh0[d], want[d][1]), ("dc0", dc0[d], want[d][2])):
            np.testing.assert_allclose(got.numpy(), w_, atol=1e-5, rtol=1e-4,
                                       err_msg=f"{name}, direction {d}")


GRAD_TOL = {"float32": dict(atol=2e-4, rtol=2e-3), "bfloat16": dict(atol=4e-2, rtol=4e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["bidirectional_prefix_mask", "forward_suffix_mask"])
def test_function_gradients_match_jax_grad(case, dtype):
    """(dxp, dW, db, dh0, dc0) of the port's differentiated lstm_scan
    against jax.grad of dsjax's lstm_scan (custom VJP, Pallas interpret),
    with the loss of tests/test_lstm_pallas.py."""
    reverse, suffix = CASES[case]
    xp, mask, w, b, h0, c0 = problem(3, reverse, suffix, T=8)
    tangent = np.random.default_rng(4).standard_normal(3).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                          torch.float32)

    def jax_loss(xp_d, w_d, b_d, h0_d, c0_d, mask_d):
        y, h_t, c_t = jax_lstm_scan(xp_d, mask_d, w_d, b_d, h0_d, c0_d, True)
        return (tangent[0] * jnp.sum(y.astype(jnp.float32) ** 2)
                + tangent[1] * jnp.sum(h_t.astype(jnp.float32))
                + tangent[2] * jnp.sum(jnp.tanh(c_t.astype(jnp.float32))))

    args = [port(a, tdt).requires_grad_(True)
            for a in (xp, np.swapaxes(w, 1, 2), b, h0, c0)]
    y, h_t, c_t = lstm.lstm_scan(args[0], port(mask), *args[1:], reverse)
    assert all(o.grad_fn is not None for o in (y, h_t, c_t))
    loss = (tangent[0] * (y.float() ** 2).sum() + tangent[1] * h_t.float().sum()
            + tangent[2] * torch.tanh(c_t.float()).sum())
    got = torch.autograd.grad(loss, args)
    for d, rev in enumerate(reverse):
        a = jax_direction(d, rev, jdt, xp, mask, w, b, h0, c0)
        want = jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4))(a[0], a[2], a[3], a[4], a[5], a[1])
        want = [np.asarray(g.astype(jnp.float32)) for g in want]
        pairs = (("dxp", got[0][d], flip(want[0], rev)), ("dW", got[1][d], want[1].T),
                 ("db", got[2][d], want[2]), ("dh0", got[3][d], want[3]),
                 ("dc0", got[4][d], want[4]))
        for name, g, w_ in pairs:
            np.testing.assert_allclose(g.float().numpy(), w_, **GRAD_TOL[dtype],
                                       err_msg=f"{name}, direction {d}")


def test_gradient_flows_through_the_scan_and_primal_saves_nothing(monkeypatch):
    """The repaired gradient cut: a differentiated call gives every input a
    nonzero gradient through the Function; a call without grad runs the
    forward without residuals (K1's path), and so does eval of a model."""
    calls = []
    reference = lstm.lstm_scan_reference

    def spy(*args, save_residuals=False):
        calls.append(save_residuals)
        return reference(*args, save_residuals=save_residuals)

    monkeypatch.setattr(lstm, "lstm_scan_reference", spy)
    xp, mask, w, b, h0, c0 = problem(5, (False, True), False, T=6, B=4, H=16)
    inputs = [port(a).requires_grad_(True) for a in (xp, np.swapaxes(w, 1, 2), b, h0, c0)]
    out = lstm.lstm_scan(inputs[0], port(mask), *inputs[1:], (False, True))
    assert all(o.grad_fn is not None for o in out)
    (out[0].sum() + out[1].sum() + out[2].sum()).backward()
    for name, t in zip(("xp", "weight_hh", "bias_hh", "h0", "c0"), inputs):
        assert t.grad is not None and t.grad.abs().max() > 0, name
    assert calls == [True]
    with torch.no_grad():
        lstm.lstm_scan(inputs[0], port(mask), *inputs[1:], (False, True))
    plain = [t.detach() for t in inputs]
    lstm.lstm_scan(plain[0], port(mask), *plain[1:], (False, True))
    assert calls == [True, False, False]

    from dsjax_torch.config import BiDirectionalConfig, SpectConfig
    from dsjax_torch.model.ds2 import DeepSpeech2

    cfg = BiDirectionalConfig(hidden_size=16, hidden_layers=2)
    model = DeepSpeech2(29, SpectConfig(), cfg, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 161, 30)).astype(np.float32))
    lengths = torch.tensor([30, 17], dtype=torch.int32)
    calls.clear()
    model.train()
    logits, _, _ = model(x, lengths)
    torch.log_softmax(logits, -1)[..., 3].sum().backward()
    assert calls == [True, True]
    # every recurrent weight, and the first conv below all of them
    for name, p in model.named_parameters():
        if name.startswith("rnns.") or name == "conv.conv1.weight":
            assert p.grad is not None and p.grad.abs().max() > 0, name
    calls.clear()
    with torch.inference_mode():
        model.eval()(x, lengths)
    assert calls == [False, False]
