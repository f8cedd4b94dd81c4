"""The GRU scan's training path against dsjax (CPU).

The plain version of K5 (``gru_scan_backward_reference``) is held against
dsjax's ``_gru_bwd_pallas`` in Pallas interpret mode on dsjax's own
residuals, and the port's differentiated ``gru_scan`` (the autograd
Function ``GRUScan``, which on CPU tensors runs the plain versions) against
``jax.grad`` of dsjax's ``gru_scan`` custom VJP. Tolerances: K5 f32 atol
1e-5, rtol 1e-4 (sum order only), bf16 chip_smoke.py's BWD_TOLERANCE (atol
5e-2, rtol 2e-2: each step's h-side gradients round to bf16 before the
product with W_hh, and a flipped rounding propagates back through the
steps); the Function's gradients f32 atol 2e-4, rtol 2e-3 (dsjax's own
gradient tolerance, tests/test_gru_pallas.py) and bf16 atol 5e-2, rtol
5e-2 (every residual, gradient and carry rounds to bf16, at different
places in the two frameworks).

Those cases cover prefix masks with a nonzero carry and suffix masks with
a zero carry, where dsjax's kernel is right. Under a suffix mask with a
nonzero carry it is not (gru_pallas.py:192 takes the masked y as h_prev,
which is 0 before the first valid step): there the port is held against
``jax.grad`` of dsjax's ``gru_scan_reference`` and autograd through the
port's plain loop, and dsjax's Pallas VJP is shown to differ.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dsjax.ops.gru_pallas import _gru_bwd_pallas, _gru_fwd_pallas
from dsjax.ops.gru_pallas import gru_scan as jax_gru_scan
from dsjax.ops.gru_pallas import gru_scan_reference as jax_gru_scan_reference
from dsjax_torch.ops import gru
from dsjax_torch.ops.lstm import _carried_h_prev
from tests.test_torch_gru import problem

# reverse flags, suffix mask (of the mask as given), nonzero carry per
# direction; a reversed direction scans the flipped mask. In every case the
# scan meets a prefix mask with a nonzero carry or a suffix mask with a zero
# one, where dsjax's Pallas backward is right.
CASES = {"bidirectional_prefix_mask": ((False, True), False, (True, False)),
         "forward_prefix_mask_carry": ((False,), False, (True,)),
         "forward_suffix_mask_zero_carry": ((False,), True, (False,)),
         "reverse_suffix_mask_carry": ((True,), True, (True,))}
# the case it gets wrong: direction 0 scans a suffix mask with a nonzero carry
# (the reverse direction of a bidirectional layer that carries state)
WRONG = ((True, False), False, (True, False))
BWD_TOL = {"float32": dict(atol=1e-5, rtol=1e-4), "bfloat16": dict(atol=5e-2, rtol=2e-2)}
GRAD_TOL = {"float32": dict(atol=2e-4, rtol=2e-3), "bfloat16": dict(atol=5e-2, rtol=5e-2)}


def case_problem(case, seed, **kw):
    reverse, suffix, carry = CASES[case] if isinstance(case, str) else case
    xp, mask, w, b, h0 = problem(seed, D=len(reverse), suffix=suffix, **kw)
    h0 = h0 * np.array(carry, np.float32)[:, None, None]
    return reverse, (xp, mask, w, b, h0)


def port(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def flip(a, rev):
    return np.ascontiguousarray(a[::-1]) if rev else a


def jax_direction(d, rev, dtype, xp, mask, w, b, h0):
    """Direction d's inputs as dsjax scans them (flipped time if reverse)."""
    return ([jnp.asarray(flip(xp[d], rev), dtype), jnp.asarray(flip(mask, rev), jnp.float32)]
            + [jnp.asarray(a[d], dtype) for a in (w, b, h0)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_reverse_scan_plain_matches_dsjax(case, dtype):
    """K5's plain version on dsjax's own residuals, nonzero dh_T; h_prev is
    the carried one, which equals dsjax's y wherever its kernel is right."""
    reverse, arrays = case_problem(case, 1)
    xp, mask, w, b, h0 = arrays
    D, T, B, G = xp.shape
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                          torch.float32)
    rng = np.random.default_rng(2)
    dy = rng.standard_normal((D, T, B, G // 3)).astype(np.float32)
    dh_t = rng.standard_normal((D, B, G // 3)).astype(np.float32)
    g_seq, ys, want = [], [], []
    for d, rev in enumerate(reverse):
        args = jax_direction(d, rev, jdt, xp, mask, w, b, h0)
        jy, _, jg = _gru_fwd_pallas(*args, interpret=True, save_residuals=True)
        want.append([np.asarray(o.astype(jnp.float32)) for o in _gru_bwd_pallas(
            jg, args[1], args[2], args[4], jy, jnp.asarray(flip(dy[d], rev), jdt),
            jnp.asarray(dh_t[d], jdt), True)])
        g_seq.append(flip(np.asarray(jg.astype(jnp.float32)), rev))
        ys.append(flip(np.asarray(jy.astype(jnp.float32)), rev))
    g_seq, y = port(np.stack(g_seq), tdt), port(np.stack(ys), tdt)
    h_prev = _carried_h_prev(y, port(mask), port(h0, tdt), reverse)
    dxp, dh0 = gru.gru_scan_backward_reference(g_seq, port(mask), port(np.swapaxes(w, 1, 2), tdt),
                                               h_prev, port(dy, tdt), port(dh_t, tdt), reverse)
    assert dxp.dtype == dh0.dtype == tdt
    for d, rev in enumerate(reverse):
        for name, got, w_ in (("dxp", dxp[d], flip(want[d][0], rev)), ("dh0", dh0[d], want[d][1])):
            np.testing.assert_allclose(got.float().numpy(), w_, **BWD_TOL[dtype],
                                       err_msg=f"{name}, direction {d}")


def jax_loss_fn(scan, tangent, mask_d, interpret):
    def loss(xp_d, w_d, b_d, h0_d):
        if interpret:
            y, h_t = scan(xp_d, mask_d, w_d, b_d, h0_d, True)
        else:
            y, h_t = scan(xp_d, mask_d.astype(xp_d.dtype), w_d, b_d, h0_d)
        return (tangent[0] * jnp.sum(y.astype(jnp.float32) ** 2)
                + tangent[1] * jnp.sum(jnp.tanh(h_t.astype(jnp.float32))))
    return loss


def port_grads(reverse, arrays, tangent, dtype=torch.float32):
    xp, mask, w, b, h0 = arrays
    args = [port(a, dtype).requires_grad_(True) for a in (xp, np.swapaxes(w, 1, 2), b, h0)]
    y, h_t = gru.gru_scan(args[0], port(mask), *args[1:], reverse)
    assert y.grad_fn is not None and h_t.grad_fn is not None
    loss = tangent[0] * (y.float() ** 2).sum() + tangent[1] * torch.tanh(h_t.float()).sum()
    return torch.autograd.grad(loss, args)


def jax_grads(scan, interpret, d, rev, jdt, arrays, tangent):
    a = jax_direction(d, rev, jdt, *arrays)
    want = jax.grad(jax_loss_fn(scan, tangent, a[1], interpret), argnums=(0, 1, 2, 3))(
        a[0], a[2], a[3], a[4])
    return [np.asarray(g.astype(jnp.float32)) for g in want]


def assert_grads(got, want, d, rev, tol):
    pairs = (("dxp", got[0][d], flip(want[0], rev)), ("dW", got[1][d], want[1].T),
             ("db", got[2][d], want[2]), ("dh0", got[3][d], want[3]))
    for name, g, w_ in pairs:
        np.testing.assert_allclose(g.float().numpy(), w_, **tol, err_msg=f"{name}, direction {d}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["bidirectional_prefix_mask", "forward_suffix_mask_zero_carry",
                                  "reverse_suffix_mask_carry"])
def test_function_gradients_match_jax_grad(case, dtype):
    """(dxp, dW, db, dh0) of the port's differentiated gru_scan against
    jax.grad of dsjax's gru_scan (custom VJP, Pallas interpret), with the
    loss of tests/test_gru_pallas.py."""
    reverse, arrays = case_problem(case, 3, T=8)
    tangent = np.random.default_rng(4).standard_normal(2).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                          torch.float32)
    got = port_grads(reverse, arrays, tangent, tdt)
    for d, rev in enumerate(reverse):
        want = jax_grads(jax_gru_scan, True, d, rev, jdt, arrays, tangent)
        assert_grads(got, want, d, rev, GRAD_TOL[dtype])


def test_suffix_mask_with_nonzero_carry_where_dsjax_pallas_is_wrong():
    """The case dsjax's Pallas backward gets wrong: a reverse direction (a
    suffix mask after dsjax's flip) with a nonzero carry. The port's
    gradients equal jax.grad of dsjax's lax.scan twin and autograd through
    the port's own plain loop; dsjax's Pallas VJP differs from both, by far
    more than any tolerance (gru_pallas.py:192 reads y, which is 0 before the
    first valid step, as h_prev)."""
    reverse, arrays = case_problem(WRONG, 5, T=6)
    tangent = np.random.default_rng(6).standard_normal(2).astype(np.float32)
    got = port_grads(reverse, arrays, tangent)
    xp, mask, w, b, h0 = arrays
    plain = [port(a).requires_grad_(True) for a in (xp, np.swapaxes(w, 1, 2), b, h0)]
    y, h_t = gru.gru_scan_reference(plain[0], port(mask), *plain[1:], reverse)
    loss = tangent[0] * (y ** 2).sum() + tangent[1] * torch.tanh(h_t).sum()
    autograd = torch.autograd.grad(loss, plain)
    for g, a in zip(got, autograd):
        torch.testing.assert_close(g, a, atol=1e-5, rtol=1e-4)
    # direction 0 scans reversed time: after dsjax's flip its mask is a
    # suffix mask, and its carry is nonzero
    rev = reverse[0]
    want = jax_grads(jax_gru_scan_reference, False, 0, rev, jnp.float32, arrays, tangent)
    assert_grads(got, want, 0, rev, GRAD_TOL["float32"])
    pallas = jax_grads(jax_gru_scan, True, 0, rev, jnp.float32, arrays, tangent)
    for name, p, w_ in zip(("dxp", "dW", "db", "dh0"), pallas, want):
        assert np.abs(p - w_).max() > 0.05, f"dsjax's Pallas {name} no longer differs"
    # direction 1 (forward time, zero carry) is a case dsjax gets right
    assert_grads(got, jax_grads(jax_gru_scan, True, 1, reverse[1], jnp.float32, arrays, tangent),
                 1, reverse[1], GRAD_TOL["float32"])


def test_gradient_flows_through_the_scan_and_primal_saves_nothing(monkeypatch):
    """A differentiated call gives every input a nonzero gradient through the
    Function; a call without grad runs the forward without residuals (K4's
    path), and so does eval of a GRU model."""
    calls = []
    reference = gru.gru_scan_reference

    def spy(*args, save_residuals=False):
        calls.append(save_residuals)
        return reference(*args, save_residuals=save_residuals)

    monkeypatch.setattr(gru, "gru_scan_reference", spy)
    reverse, arrays = case_problem("bidirectional_prefix_mask", 7, T=6, B=4, H=16)
    xp, mask, w, b, h0 = arrays
    h0 = h0 + 0.1
    inputs = [port(a).requires_grad_(True) for a in (xp, np.swapaxes(w, 1, 2), b, h0)]
    out = gru.gru_scan(inputs[0], port(mask), *inputs[1:], reverse)
    (out[0].sum() + out[1].sum()).backward()
    for name, t in zip(("xp", "weight_hh", "bias_hh", "h0"), inputs):
        assert t.grad is not None and t.grad.abs().max() > 0, name
    assert calls == [True]
    with torch.no_grad():
        gru.gru_scan(inputs[0], port(mask), *inputs[1:], reverse)
    assert calls == [True, False]

    from dsjax_torch.config import BiDirectionalConfig, RNNType, SpectConfig, UniDirectionalConfig
    from dsjax_torch.model.ds2 import DeepSpeech2

    x = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 161, 30)).astype(np.float32))
    lengths = torch.tensor([30, 17], dtype=torch.int32)
    for cfg in (BiDirectionalConfig(rnn_type=RNNType.gru, hidden_size=16, hidden_layers=2),
                UniDirectionalConfig(rnn_type=RNNType.gru, hidden_size=16, hidden_layers=2,
                                     lookahead_context=3)):
        model = DeepSpeech2(29, SpectConfig(), cfg, generator=torch.Generator().manual_seed(0))
        calls.clear()
        model.train()
        logits, _, _ = model(x, lengths)
        torch.log_softmax(logits, -1)[..., 3].sum().backward()
        assert calls == [True, True]
        for name, p in model.named_parameters():
            if name.startswith(("rnns.", "lookahead.")) or name == "conv.conv1.weight":
                assert p.grad is not None and p.grad.abs().max() > 0, name
        calls.clear()
        with torch.inference_mode():
            model.eval()(x, lengths)
        assert calls == [False, False]


@pytest.mark.parametrize("model", [["model.rnn_type=gru"],
                                   ["model=unidirectional", "model.rnn_type=gru",
                                    "model.lookahead_context=5"]],
                         ids=["bigru", "unigru_lookahead"])
def test_gru_train_step_matches_dsjax_trainer(tmp_path, model):
    """One training step of a GRU model against dsjax's Trainer, as
    tests/test_torch_train.py holds the LSTM's: equal batches, gradients per
    parameter (atol 1e-4 x the parameter's largest gradient), BatchNorm
    running stats (atol 1e-5, rtol 1e-4) and the losses of 2 train_steps
    (rtol 1e-4)."""
    from dsjax import config as jax_config
    from dsjax.parallel.mesh import make_mesh
    from dsjax.train.loop import Trainer as JaxTrainer
    from dsjax.workflows import _pipelines as jax_pipelines
    from dsjax_torch import config, workflows
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.model.convert import from_dsjax_variables
    from dsjax_torch.train.loop import Trainer
    from tests.synthetic_manifest import write_manifest

    train = write_manifest(str(tmp_path), "train", [1.0, 1.12, 0.7, 1.1, 0.9, 1.05], seed=0)
    argv = [f"data.train_path={train}", f"data.val_path={train}", "data.batch_size=3",
            "data.device_features=false", "data.num_workers=1", *model, "model.hidden_size=32",
            "model.hidden_layers=2", "trainer.precision=32", "seed=7"]
    jcfg = jax_config.compose(jax_config.TrainConfig, argv + ["trainer.mesh_data=1"])
    cfg = config.compose(config.TrainConfig, argv + ["trainer.device=cpu"])
    labels = list(DEFAULT_LABELS)
    jbatches = list(jax_pipelines(jcfg, labels, dp=1)[0])
    pbatches = list(workflows._pipelines(cfg, labels)[0])
    for jb, pb in zip(jbatches, pbatches):
        np.testing.assert_array_equal(jb.inputs, pb.inputs)

    jtrainer = JaxTrainer(jcfg, labels, mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    trainer = Trainer(cfg, labels)
    jstate = jtrainer.init_state()
    weights = from_dsjax_variables(jax.tree_util.tree_map(np.asarray, jstate.variables()))
    state = trainer.init_state()
    state.model.load_state_dict(weights)

    jgrads, jstats, jloss = jtrainer.grad_step(jstate, jbatches[0])
    grads, loss = trainer.grad_step(state, pbatches[0])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = from_dsjax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": jgrads, "batch_stats": jstats}))
    assert sorted(grads) == sorted(k for k in want if not k.endswith(("_mean", "_var")))
    for name, g in grads.items():
        scale = float(np.abs(want[name].numpy()).max())
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-4 * scale, rtol=0,
                                   err_msg=name)
    for name, buf in state.model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)

    state = trainer.init_state()
    state.model.load_state_dict(weights)
    jstate = jtrainer.init_state()
    for i in range(2):
        jstate, jloss = jtrainer.train_step(jstate, jbatches[i % 2])
        state, loss = trainer.train_step(state, pbatches[i % 2])
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4, err_msg=f"step {i}")
