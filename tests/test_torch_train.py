"""dsjax_torch's training step against dsjax's (CPU).

  * CTC: per-row nll (feasible, infeasible and empty-target rows) at
    rtol 1e-5, and the gradient with respect to the logits before the
    log-softmax at atol 1e-5 (F.ctc_loss's gradient with respect to the
    log-probabilities differs from dsjax's by a term the log-softmax's
    backward cancels, so only the logits' gradient is compared).
  * The optimizer against optax (AdamW and SGD, clip active and inactive,
    epochs 0 and 2): identical gradients for 3 steps, parameters at 1e-6
    relative to each tensor's largest magnitude (f32 rounding of the
    parameter in the decay and update, a few ulps).
  * The whole step against dsjax's Trainer on the same weights and the
    same batch from each package's own pipeline: the batches are equal,
    grad_step's gradients match per parameter (atol 1e-4 x the parameter's
    largest gradient; measured 1.5e-5 to 3.7e-5: the training-mode forward
    already differs by about 3e-6 relative, because both packages take
    BatchNorm's variance as E[x^2] - E[x]^2 in f32, which magnifies their
    different sum orders, and the backward through BatchNorm and the LSTM
    layers carries it on), the BatchNorm running stats match after the
    step (atol 1e-5, rtol 1e-4, as tests/test_torch_model.py holds them),
    and the loss matches over 3 train_steps at rtol 1e-4. Gradients and the
    optimizer are compared apart, never parameters after Adam (its first
    step is about lr * sign(g), which magnifies noise in near-zero
    gradients).
  * ``python -m dsjax_torch.train`` end to end on the CPU.
  * ``trainer.profile``: the trace of dsjax's window of steps, one span a
    step, closed when fit returns inside the window; nothing when off.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dsjax import config as jax_config
from dsjax.model.ctc import ctc_loss as jax_ctc_loss
from dsjax_torch import config
from dsjax_torch.labels import DEFAULT_LABELS
from dsjax_torch.model.ctc import ctc_loss
from dsjax_torch.model.convert import from_dsjax_variables
from tests.synthetic_manifest import write_manifest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_ctc_matches_dsjax(reduction):
    rng = np.random.default_rng(0)
    B, T, C, L = 6, 20, 29, 7
    logits = rng.standard_normal((B, T, C)).astype(np.float32) * 2
    input_lengths = np.array([20, 15, 3, 20, 1, 9], np.int32)
    target_lengths = np.array([7, 4, 5, 0, 0, 3], np.int32)  # row 2 infeasible
    targets = rng.integers(1, C, (B, L)).astype(np.int32)
    targets[0, 1] = targets[0, 0]                            # a repeat needs a blank
    weights = rng.uniform(0.5, 2.0, B).astype(np.float32)

    def jax_ctc(x):
        return jax_ctc_loss(jax.nn.log_softmax(x, axis=-1), jnp.asarray(input_lengths),
                            jnp.asarray(targets), jnp.asarray(target_lengths),
                            reduction=reduction, zero_infinity=True)

    def jax_total(x):
        out = jax_ctc(x)
        return jnp.sum(out * weights) if reduction == "none" else out

    want = jax_ctc(jnp.asarray(logits))
    want_grad = jax.grad(jax_total)(jnp.asarray(logits))

    x = torch.from_numpy(logits).requires_grad_(True)
    got = ctc_loss(torch.log_softmax(x, -1), torch.from_numpy(input_lengths),
                   torch.from_numpy(targets), torch.from_numpy(target_lengths),
                   reduction=reduction, zero_infinity=True)
    total = (got * torch.from_numpy(weights)).sum() if reduction == "none" else got
    total.backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if reduction == "none":
        assert got[2] == 0 and float(want[2]) == 0      # infeasible: zero loss
        assert float(got[3].detach()) > 0                         # empty target: -sum log p_blank
        assert torch.all(x.grad[2] == 0)                 # and zero gradient
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), atol=1e-5, rtol=0)


@pytest.mark.parametrize("epoch", [0, 2])
@pytest.mark.parametrize("clip", [400.0, 0.05], ids=["clip_inactive", "clip_active"])
@pytest.mark.parametrize("optim", ["adam", "sgd"])
def test_optimizer_matches_optax(optim, clip, epoch):
    import optax

    from dsjax.train import state as jax_state
    from dsjax_torch.train import state

    argv = [f"optim={optim}", f"trainer.gradient_clip_val={clip}", "optim.learning_rate=0.01",
            "optim.weight_decay=0.01"]
    jcfg = jax_config.compose(jax_config.TrainConfig, argv)
    cfg = config.compose(config.TrainConfig, argv)
    rng = np.random.default_rng(1)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]

    tx = jax_state.make_optimizer(jcfg.optim, jcfg.trainer)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    for g in grads:
        opt_state = jax_state.set_lr(opt_state, jax_state.epoch_lr(jcfg.optim, jnp.int32(epoch)))
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state,
                                       jparams)
        jparams = optax.apply_updates(jparams, updates)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = state.make_optimizer(tparams.values(), cfg.optim)
    norms = []
    for g in grads:
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        norms.append(float(state.clip_by_global_norm([p.grad for p in tparams.values()],
                                                     cfg.trainer.gradient_clip_val)))
        state.set_lr(opt, state.epoch_lr(cfg.optim, epoch))
        opt.step()
    assert (max(norms) >= clip) == (clip < 1.0)          # the clip did or did not act
    for k, p in tparams.items():
        want = np.asarray(jparams[k])
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(), err_msg=k)


def batch_arrays(batch):
    return [batch.inputs, batch.input_lengths, batch.targets, batch.target_lengths,
            batch.valid_mask]


def test_train_step_matches_dsjax_trainer(tmp_path):
    from dsjax.train.loop import Trainer as JaxTrainer
    from dsjax.workflows import _pipelines as jax_pipelines
    from dsjax_torch import workflows
    from dsjax_torch.train.loop import Trainer

    # every batch pads to 128 frames, so dsjax compiles each step function once
    train = write_manifest(str(tmp_path), "train", [1.0, 1.12, 0.7, 1.1, 0.9, 1.05], seed=0)
    argv = [f"data.train_path={train}", f"data.val_path={train}", "data.batch_size=3",
            "data.device_features=false", "data.num_workers=1", "model.hidden_size=64",
            "model.hidden_layers=2", "trainer.precision=32", "seed=7"]
    jcfg = jax_config.compose(jax_config.TrainConfig, argv + ["trainer.mesh_data=1"])
    cfg = config.compose(config.TrainConfig, argv + ["trainer.device=cpu"])
    labels = list(DEFAULT_LABELS)
    jtrain, _ = jax_pipelines(jcfg, labels, dp=1)
    ptrain, _ = workflows._pipelines(cfg, labels)
    jbatches, pbatches = list(jtrain), list(ptrain)
    assert len(jbatches) == len(pbatches) == 2
    for jb, pb in zip(jbatches, pbatches):
        for a, b in zip(batch_arrays(jb), batch_arrays(pb)):
            np.testing.assert_array_equal(a, b)

    from dsjax.parallel.mesh import make_mesh

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
    for i in range(3):
        jstate, jloss = jtrainer.train_step(jstate, jbatches[i % 2])
        state, loss = trainer.train_step(state, pbatches[i % 2])
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4, err_msg=f"step {i}")
    assert state.step == int(jstate.step) == 3


def test_accumulated_step_equals_summed_grad_steps(tmp_path):
    """train_step_accum over micro-batches (n_accum real batches) equals
    apply_grads on the sum of their grad_step gradients, as dsjax's
    Trainer defines them (train/loop.py:210-248); n_accum=1 sums ragged
    sub-batches without scaling."""
    from dsjax_torch import workflows
    from dsjax_torch.train.loop import Trainer

    train = write_manifest(str(tmp_path), "train", [0.6, 0.8, 0.7, 0.5], seed=3)
    cfg = config.compose(config.TrainConfig, [
        f"data.train_path={train}", f"data.val_path={train}", "data.batch_size=2",
        "data.device_features=false", "model.hidden_size=16", "model.hidden_layers=1",
        "trainer.precision=32", "trainer.device=cpu", "trainer.gradient_clip_val=0.5"])
    batches = list(workflows._pipelines(cfg, list(DEFAULT_LABELS))[0])
    trainer = Trainer(cfg, list(DEFAULT_LABELS))
    for n_accum in (2, 1):
        a, b = trainer.init_state(seed=1), trainer.init_state(seed=1)
        a, _ = trainer.train_step_accum(a, batches, n_accum=n_accum)
        summed = None
        for batch in batches:
            grads, _ = trainer.grad_step(b, batch)
            summed = grads if summed is None else {k: summed[k] + g for k, g in grads.items()}
        b = trainer.apply_grads(b, summed, n_accum)
        assert a.step == b.step == 1
        for (k, p), q in zip(a.model.state_dict().items(), b.model.state_dict().values()):
            torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7, msg=k)


def test_train_cli_trains_saves_resumes_and_serves(tmp_path):
    """The CLI trains 2 epochs on the CPU and writes best and last; a
    relaunch auto-resumes from last; the saved model, loaded as the server
    loads it, gives the trainer's eval posteriors."""
    from dsjax_torch import workflows
    from dsjax_torch.inference import load_model
    from dsjax_torch.train.checkpoint import CheckpointHandler
    from dsjax_torch.train.loop import Trainer

    train = write_manifest(str(tmp_path), "train", [1.0, 0.8, 1.2, 0.6], seed=1)
    val = write_manifest(str(tmp_path), "val", [0.9, 1.1], seed=2)
    ckpt = str(tmp_path / "ckpt")
    argv = [f"data.train_path={train}", f"data.val_path={val}", "data.batch_size=2",
            "data.device_features=false", "data.num_workers=1", "model.hidden_size=16",
            "model.hidden_layers=1", "trainer.precision=32", "trainer.device=cpu",
            f"checkpoint.dirpath={ckpt}", "trainer.log_every_n_steps=1",
            f"trainer.log_dir={tmp_path / 'logs'}"]
    state = workflows.train(config.compose(config.TrainConfig, argv + ["trainer.max_epochs=2"]))
    assert state.step == 4 and state.epoch == 1
    handler = CheckpointHandler(ckpt)
    assert handler.latest_step() == 4 and handler.best_step() in (2, 4)
    assert os.path.isfile(handler.path(best=True))
    assert sorted(os.listdir(os.path.join(ckpt, "last"))) == ["step_4.pt"]
    assert os.path.getsize(tmp_path / "logs" / "metrics.jsonl") > 0

    cfg = config.compose(config.TrainConfig, argv)
    trainer = Trainer(cfg, list(DEFAULT_LABELS))
    _, val_pipe = workflows._pipelines(cfg, list(DEFAULT_LABELS))
    batch = next(iter(val_pipe))
    want, want_lens = trainer.eval_step(state, batch)
    bundle = load_model(handler.path(), device="cpu")
    got, got_lens, _ = bundle.forward(batch.inputs, batch.input_lengths)
    assert torch.equal(got_lens, want_lens)
    torch.testing.assert_close(got, want, atol=0, rtol=0)

    out = subprocess.run(
        [sys.executable, "-m", "dsjax_torch.train", *argv, "trainer.max_epochs=3",
         "load_auto_checkpoint=true"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "auto-resumed from step 4" in out.stdout
    assert "epoch 2: loss" in out.stdout and "epoch 1: loss" not in out.stdout
    assert handler.latest_step() == 6


def test_device_feature_step_matches_host_feature_step_and_dsjax(tmp_path):
    """data.device_features=true: the loader ships int16 raw audio and the
    step computes the spectrogram first. Its loss and gradients equal the
    host-feature step's on the same utterances to rtol 1e-4 (the int16
    upload quantizes the signal, and the STFT runs batched: the features
    differ by about 1e-5), and its loss equals dsjax's device-feature step
    on the same raw batch to rtol 1e-5."""
    from dsjax.train.loop import Trainer as JaxTrainer
    from dsjax.parallel.mesh import make_mesh
    from dsjax_torch import workflows
    from dsjax_torch.train.loop import Trainer

    train = write_manifest(str(tmp_path), "train", [1.0, 1.12, 0.7], seed=4)
    argv = [f"data.train_path={train}", f"data.val_path={train}", "data.batch_size=3",
            "data.num_workers=1", "model.hidden_size=32", "model.hidden_layers=2",
            "trainer.precision=32", "seed=7"]
    labels = list(DEFAULT_LABELS)
    results = {}
    for feats in ("true", "false"):
        cfg = config.compose(config.TrainConfig, argv + [f"data.device_features={feats}",
                                                         "trainer.device=cpu"])
        trainer = Trainer(cfg, labels)
        batch = next(iter(workflows._pipelines(cfg, labels)[0]))
        assert (batch.inputs is None) == (feats == "true")
        state = trainer.init_state(seed=0)
        results[feats] = trainer.grad_step(state, batch) + (batch, state)
    grads, loss, raw_batch, state = results["true"]
    host_grads, host_loss = results["false"][:2]
    assert raw_batch.audio.dtype == np.int16
    np.testing.assert_allclose(float(loss), float(host_loss), rtol=1e-4)
    for name, g in grads.items():
        scale = float(host_grads[name].abs().max())
        np.testing.assert_allclose(g.numpy(), host_grads[name].numpy(), atol=1e-4 * scale,
                                   rtol=0, err_msg=name)

    jcfg = jax_config.compose(jax_config.TrainConfig, argv + ["data.device_features=true",
                                                             "trainer.mesh_data=1"])
    jtrainer = JaxTrainer(jcfg, labels, mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    jstate = jtrainer.init_state()
    weights = from_dsjax_variables(jax.tree_util.tree_map(np.asarray, jstate.variables()))
    cfg = config.compose(config.TrainConfig, argv + ["trainer.device=cpu"])
    trainer = Trainer(cfg, labels)
    state = trainer.init_state()
    state.model.load_state_dict(weights)
    _, _, jloss = jtrainer.grad_step(jstate, raw_batch)
    _, loss = trainer.grad_step(state, raw_batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("model", [["model.rnn_type=gru"],
                                   ["model=unidirectional", "model.rnn_type=gru",
                                    "model.lookahead_context=4"]],
                         ids=["bigru", "unigru_lookahead"])
def test_gru_training_saves_what_the_server_loads_and_refuses_other_models(tmp_path, model):
    """``workflows.train`` with model.rnn_type=gru (bidirectional, or
    model=unidirectional with Lookahead) trains on the CPU and writes a
    checkpoint that load_model rebuilds as the same model with the trainer's
    posteriors; restoring it into a trainer of another rnn_type or direction
    raises."""
    from dsjax_torch import workflows
    from dsjax_torch.inference import load_model
    from dsjax_torch.train.checkpoint import CheckpointHandler, restore_from_path
    from dsjax_torch.train.loop import Trainer

    train = write_manifest(str(tmp_path), "train", [1.0, 0.8, 1.2, 0.6], seed=11)
    ckpt = str(tmp_path / "ckpt")
    base = [f"data.train_path={train}", f"data.val_path={train}", "data.batch_size=2",
            "data.num_workers=1", "model.hidden_size=16", "model.hidden_layers=2",
            "trainer.precision=32", "trainer.device=cpu", "trainer.log_dir=''",
            "trainer.max_epochs=1"]
    cfg = config.compose(config.TrainConfig, base + model + [f"checkpoint.dirpath={ckpt}"])
    state = workflows.train(cfg)
    assert state.step == 2
    trainer = Trainer(cfg, list(DEFAULT_LABELS))
    batch = next(iter(workflows._pipelines(cfg, list(DEFAULT_LABELS))[1]))
    want, want_lens = trainer.eval_step(state, batch)
    path = CheckpointHandler(ckpt).path()
    bundle = load_model(path, device="cpu")
    assert bundle.model.model_cfg == cfg.model
    got, got_lens, carry = bundle.forward(batch.audio, batch.input_lengths)
    assert torch.equal(got_lens, want_lens) and len(carry[0]) == 1
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    for other in (["model.rnn_type=lstm"], ["model=unidirectional", "model.rnn_type=gru"]
                  if "model=unidirectional" not in model else ["model.rnn_type=gru"]):
        other_cfg = config.compose(config.TrainConfig, base + other)
        with pytest.raises(ValueError, match="does not match"):
            restore_from_path(path, Trainer(other_cfg, list(DEFAULT_LABELS)).init_state())


def annotated_steps(trace_path):
    """The names of the train_step spans (record_function) of a Chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(e["name"] for e in events
                  if e.get("cat") == "user_annotation" and e["name"].startswith("train_step"))


@pytest.mark.parametrize("profile, start, num, want", [
    ("true", 1, 1, ["train_step 1", "train_step 2"]),
    ("false", 1, 1, None),
    ("true", 1, 10, ["train_step 1", "train_step 2"]),    # the window outlasts the run
], ids=["window", "off", "past_the_end"])
def test_fit_profile_writes_a_trace_of_the_window(tmp_path, profile, start, num, want):
    """trainer.profile traces the steps whose pre-step counts run from
    profile_start_step to profile_start_step + profile_num_steps, as
    dsjax's fit does, into one Chrome trace under profile_dir with a span a
    step; a window the run ends inside is closed when fit returns."""
    from dsjax_torch import workflows
    from dsjax_torch.train.loop import Trainer

    train = write_manifest(str(tmp_path), "train", [0.6, 0.5, 0.7, 0.4, 0.5, 0.6], seed=6)
    profiles = tmp_path / "profiles"
    cfg = config.compose(config.TrainConfig, [
        f"data.train_path={train}", f"data.val_path={train}", "data.batch_size=2",
        "data.num_workers=1", "model.hidden_size=16", "model.hidden_layers=1",
        "trainer.precision=32", "trainer.device=cpu", "trainer.max_epochs=1",
        f"trainer.profile={profile}", f"trainer.profile_start_step={start}",
        f"trainer.profile_num_steps={num}", f"trainer.profile_dir={profiles}"])
    trainer = Trainer(cfg, list(DEFAULT_LABELS))
    state = trainer.fit(*workflows._pipelines(cfg, list(DEFAULT_LABELS)), log_fn=lambda _: None)
    assert state.step == 3
    if want is None:
        assert not profiles.exists()
        return
    traces = os.listdir(profiles)
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    assert annotated_steps(profiles / traces[0]) == want


@pytest.mark.parametrize("scale", [1.0, 1e3])
def test_clip_scales_each_gradient_as_its_own_div_and_mul(scale):
    """The clip divides and multiplies the gradients as one list each: the
    result is the per-tensor ``div_`` and ``mul_``'s bit for bit, under the
    limit (both factors 1) and over it."""
    from dsjax_torch.train.state import clip_by_global_norm

    g = torch.Generator().manual_seed(3)
    grads = [scale * torch.randn(s, generator=g) for s in [(7, 5), (13,), (2, 3, 4)]]
    want = [t.clone() for t in grads]
    norm = clip_by_global_norm(grads, 400.0)
    clipped = bool(norm >= 400.0)
    assert clipped == (scale > 1)
    div = norm if clipped else torch.ones_like(norm)
    mul = torch.full_like(norm, 400.0) if clipped else torch.ones_like(norm)
    for w, t in zip(want, grads):
        assert torch.equal(w.div_(div).mul_(mul), t)
