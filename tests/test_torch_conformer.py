"""The port's Conformer-CTC (``model=conformer``, ``data.spect=logmel``)
against the plain reference, ``tests/conformer_reference.py``, on the CPU.

A small model of the Large row's shape (d=64, 2 heads, 2 blocks, kernel 7)
with seeded weights (LayerNorms, BatchNorms and the biases u and v moved
off their initial values, so each does work) over B=3 utterances of
ragged lengths. The front end, the evaluation posteriors, the training loss
and every gradient, one AdamW step through ``Trainer.train_step``, padding,
the checkpoint, two DDP ranks, the refusals and the command line.

Run as a script, this file is one rank of the two-rank DDP test.
"""

from __future__ import annotations

import argparse
import http.client
import io
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from dsjax_torch import config  # noqa: E402
from dsjax_torch.audio.features import (features_torch, logmel_np,  # noqa: E402
                                        pad_audio_for_device, stft_params)
from dsjax_torch.data.dataset import collate_audio  # noqa: E402
from dsjax_torch.labels import DEFAULT_LABELS  # noqa: E402
from dsjax_torch.model.conformer import Conformer  # noqa: E402
from tests import conformer_reference as ref  # noqa: E402

SR = 16000
N_SAMPLES = (8000, 5920, 9760)                 # 51, 38 and 62 frames
SMALL = ["model=conformer", "model.d_model=64", "model.n_heads=2", "model.n_layers=2",
         "model.conv_kernel_size=7", "model.dropout=0", "data.spect=logmel"]
ARCH = dict(d_model=64, n_heads=2, n_layers=2)
FRONT_END = dict(sample_rate=SR, window_size=0.025, window_stride=0.01, n_fft=512,
                 features=80, preemph=0.97)
# float32 against float64 through a log: a feature's error is about 1e-6 of
# the frame's largest mel power over the band's own (whose log it takes),
# normalised by the band's spread; the seeded signals read up to 1.3e-5
FEATURE_TOL = 1e-4
# float32 end to end: the posteriors read 5e-8; bf16 compute reads 1e-3
PROBS_TOL = 1e-5
# each gradient leaf's relative error, float32 against float32 in another
# order of operations: about 5e-6 (the loss sums 3 rows of 13-16 frames);
# bf16 reads 1e-2
GRAD_RTOL = 1e-4
# leaves whose gradient is zero but for round-off (a key bias, which the
# softmax cancels; the depthwise bias before BatchNorm) are held absolutely,
# against the median leaf's gradient norm
GRAD_ATOL = 1e-5


def utterances(seed: int = 0, n_samples=N_SAMPLES):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(n_samples):
        t = np.arange(n) / SR
        y = (0.2 * np.sin(2 * np.pi * (150 + 70 * i) * t)
             + 0.1 * np.sin(2 * np.pi * (900 + 300 * i) * t)
             + 0.05 * rng.standard_normal(n))
        out.append(y.astype(np.float32))
    return out


def small_cfg(extra=()) -> config.TrainConfig:
    return config.compose(config.TrainConfig, SMALL + ["trainer.device=cpu",
                                                       "trainer.precision=32",
                                                       "data.bucket_frames=1",
                                                       "data.bucket_labels=1", *extra])


def seeded_model(cfg, seed: int = 1, dtype=torch.float32) -> Conformer:
    g = torch.Generator().manual_seed(seed)
    model = Conformer(len(DEFAULT_LABELS), cfg.data.spect, cfg.model, dtype=dtype, generator=g)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name or "pos_bias" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
        for layer in model.encoder.layers:
            bn = layer.conv.batch_norm
            bn.running_mean.normal_(0.0, 0.1, generator=g)
            bn.running_var.uniform_(1.0, 1.2, generator=g)
    return model


def reference_features(ys):
    audio = torch.zeros(len(ys), max(len(y) for y in ys))
    for i, y in enumerate(ys):
        audio[i, :len(y)] = torch.from_numpy(y)
    return ref.logmel(audio, [len(y) for y in ys], FRONT_END)


def device_batch(ys, spect, transcripts=None):
    """The training loader's device-feature batch of ``ys`` (sorted longest
    first, as ``collate_audio`` sorts)."""
    transcripts = transcripts or [[1 + (i % 27) for i in range(5 + r)] for r in range(len(ys))]
    items = [pad_audio_for_device(y, spect) + (t,) for y, t in zip(ys, transcripts)]
    return collate_audio(items, stft_params(spect)[1], 1, 1)


def order_of(ys):
    return sorted(range(len(ys)), key=lambda i: -len(ys[i]))


def targets(n: int = 3):
    g = torch.Generator().manual_seed(7)
    lengths = torch.tensor([10, 8, 9][:n])
    return torch.randint(1, 29, (n, 10), generator=g), lengths


def reference_leaves(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


# ---------------------------------------------------------------------------
# the front end
# ---------------------------------------------------------------------------

def test_logmel_device_host_and_reference_agree():
    ys = utterances()
    spect = config.LogMelConfig()
    batch = device_batch(ys, spect)
    dev = features_torch(torch.from_numpy(batch.audio), torch.from_numpy(batch.input_lengths),
                         spect).numpy()
    want, frames = reference_features(ys)
    for row, i in enumerate(order_of(ys)):
        n = int(batch.input_lengths[row])
        assert n == int(frames[i]) == 1 + len(ys[i]) // 160
        host = logmel_np(ys[i], spect)
        assert host.shape == (80, n)
        np.testing.assert_allclose(host, want[i, :, :n].numpy(), atol=FEATURE_TOL, rtol=0)
        np.testing.assert_allclose(dev[row, :, :n], host, atol=FEATURE_TOL, rtol=0)
        assert not dev[row, :, n:].any()


def test_logmel_device_batch_is_each_row_alone():
    """A row's device features do not depend on its batch's padding: the
    host applies the pre-emphasis over its own samples."""
    ys = utterances(3)
    spect = config.LogMelConfig()
    batch = device_batch(ys, spect)
    feats = features_torch(torch.from_numpy(batch.audio), torch.from_numpy(batch.input_lengths),
                           spect)
    for row, i in enumerate(order_of(ys)):
        alone = device_batch([ys[i]], spect)
        one = features_torch(torch.from_numpy(alone.audio),
                             torch.from_numpy(alone.input_lengths), spect)
        n = int(batch.input_lengths[row])
        torch.testing.assert_close(feats[row, :, :n], one[0], atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

def test_eval_posteriors_match_the_reference():
    cfg = small_cfg()
    model = seeded_model(cfg).eval()
    feats, frames = reference_features(utterances())
    with torch.no_grad():
        probs, out_len, carry = model(feats, frames)
        want, want_len = ref.forward(reference_leaves(model), ARCH, feats, frames, train=False)
    assert carry == [] and out_len.tolist() == want_len.tolist() == [13, 10, 16]
    assert (probs - want).abs().max() <= PROBS_TOL


def test_bf16_compute_breaks_the_posterior_tolerance():
    """The f32 tolerances would see the port computing in bfloat16."""
    cfg = small_cfg()
    feats, frames = reference_features(utterances())
    model = seeded_model(cfg, dtype=torch.bfloat16).eval()
    with torch.no_grad():
        probs = model(feats, frames)[0]
        want = ref.forward(reference_leaves(model), ARCH, feats, frames, train=False)[0]
    assert (probs - want).abs().max() > 10 * PROBS_TOL


def loss_and_grads(model, feats, frames):
    from dsjax_torch.model.ctc import ctc_loss

    tg, tl = targets()
    out, out_len, _ = model(feats, frames)
    loss = ctc_loss(torch.log_softmax(out.float(), -1), out_len, tg, tl, reduction="none",
                    zero_infinity=True).sum()
    loss.backward()
    return loss.detach(), {n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                           for n, p in model.named_parameters()}


def reference_loss_and_grads(leaves, feats, frames):
    tg, tl = targets()
    w = {k: v.clone().requires_grad_(not k.endswith(("running_mean", "running_var")))
         for k, v in leaves.items()}
    logits, out_len = ref.forward(w, ARCH, feats, frames, train=True)
    loss = ref.ctc_loss_sum(logits, out_len, tg, tl)
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in w.items() if v.requires_grad}


def assert_grads_close(got, want):
    scale = float(np.median([float(g.norm()) for g in want.values()]))
    assert set(got) == set(want)
    for name, g in want.items():
        gap = float((got[name] - g).norm())
        if float(g.norm()) >= 1e-3 * scale:
            assert gap <= GRAD_RTOL * float(g.norm()), name
        else:
            assert gap <= GRAD_ATOL * scale, name


def test_training_loss_and_every_gradient_match_the_reference():
    cfg = small_cfg()
    model = seeded_model(cfg).train()
    leaves = reference_leaves(model)
    feats, frames = reference_features(utterances())
    loss, grads = loss_and_grads(model, feats, frames)
    want_loss, want = reference_loss_and_grads(leaves, feats, frames)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert_grads_close(grads, want)


def test_bf16_compute_keeps_float32_parameters_and_gradients():
    """bfloat16 compute casts each weight where it is used: the parameters
    stay float32, every one gets a float32 gradient, and the loss is the
    float32 loss to bfloat16's precision."""
    cfg = small_cfg()
    feats, frames = reference_features(utterances())
    model = seeded_model(cfg).train()
    want, _ = loss_and_grads(model, feats, frames)
    model = seeded_model(cfg, dtype=torch.bfloat16).train()
    loss, grads = loss_and_grads(model, feats, frames)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert set(grads) == {n for n, _ in model.named_parameters()}
    for name, g in grads.items():
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), name
    # bf16 keeps 8 bits of mantissa (2^-8 = 0.4%) through 2 blocks; the loss
    # reads about 0.03% from float32's, never the 1e-5 the float32 path holds
    assert abs(float(loss) - float(want)) <= 2e-2 * abs(float(want))


def test_planted_faults_break_the_gradient_tolerance(monkeypatch):
    """The gradient check sees a Conformer without its positional term."""
    from dsjax_torch.model import conformer

    cfg = small_cfg()
    model = seeded_model(cfg).train()
    leaves = reference_leaves(model)
    feats, frames = reference_features(utterances())
    monkeypatch.setattr(conformer, "rel_shift", lambda x: torch.zeros_like(x[..., :x.shape[2]]))
    _, grads = loss_and_grads(model, feats, frames)
    _, want = reference_loss_and_grads(leaves, feats, frames)
    with pytest.raises(AssertionError):
        assert_grads_close(grads, want)


def test_one_adamw_step_through_the_trainer_matches_the_reference():
    from dsjax_torch.train.loop import Trainer

    ys = utterances()
    cfg = small_cfg(["optim=adam", "optim.learning_rate=1e-3", "trainer.gradient_clip_val=5"])
    trainer = Trainer(cfg, list(DEFAULT_LABELS))
    state = trainer.init_state()
    state.model.load_state_dict(seeded_model(cfg).state_dict())
    leaves = reference_leaves(state.model)
    tg, tl = targets()
    order = order_of(ys)
    batch = device_batch(ys, cfg.data.spect,
                         [tg[i, :tl[i]].tolist() for i in range(3)])
    state, loss = trainer.train_step(state, batch)
    loss = float(loss)

    feats, frames = reference_features([ys[i] for i in order])
    w = {k: v.clone().requires_grad_(not k.endswith(("running_mean", "running_var")))
         for k, v in leaves.items()}
    logits, out_len = ref.forward(w, ARCH, feats, frames, train=True)
    want_loss = ref.ctc_loss_sum(logits, out_len, torch.from_numpy(batch.targets).long(),
                                 torch.from_numpy(batch.target_lengths).long())
    want_loss.backward()
    want_loss = float(want_loss.detach())
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
    names = [k for k in w if w[k].requires_grad]
    norm = torch.sqrt(sum(torch.sum(w[k].grad.double() ** 2) for k in names))
    clip = min(1.0, 5.0 / float(norm))
    opt = cfg.optim
    b1, b2 = opt.betas
    new = dict(state.model.named_parameters())
    scale = float(np.median([float(w[k].grad.norm()) for k in names]))
    for k in names:
        g = w[k].grad * clip
        m, v = (1 - b1) * g, (1 - b2) * g * g
        step = opt.learning_rate * (m / (1 - b1)) / ((v / (1 - b2)).sqrt() + opt.eps)
        want = leaves[k] * (1 - opt.learning_rate * opt.weight_decay) - step
        moved = (new[k].detach() - leaves[k]).norm()
        if float(w[k].grad.norm()) >= 1e-3 * scale:
            # Adam's first step is lr * g / |g| elementwise: an element whose
            # gradient is near zero takes a step set by its rounding
            assert float((new[k].detach() - want).norm()) <= 1e-2 * float(moved), k
    assert state.step == 1


def test_valid_outputs_do_not_depend_on_padding():
    cfg = small_cfg()
    model = seeded_model(cfg).eval()
    feats, frames = reference_features(utterances())
    longer = torch.nn.functional.pad(feats, (0, 37))
    with torch.no_grad():
        a, la, _ = model(feats, frames)
        b, lb, _ = model(longer, frames)
    assert la.tolist() == lb.tolist()
    for r, n in enumerate(la.tolist()):
        torch.testing.assert_close(a[r, :n], b[r, :n], atol=1e-6, rtol=0)


@pytest.mark.parametrize("family", ["conformer", "ds2"])
def test_output_lengths_is_the_rule_forward_applies(family):
    """The trainer gives CTC the host batch's lengths through the model's
    ``output_lengths``, so that torch's CTC need not wait for the device's:
    they must be the lengths the model's forward returns."""
    from dsjax_torch.model.build import build_model

    if family == "conformer":
        cfg = small_cfg()
    else:
        cfg = config.compose(config.TrainConfig, ["model.hidden_size=16",
                                                  "model.hidden_layers=1"])
    model = build_model(len(DEFAULT_LABELS), cfg.data.spect, cfg.model).eval()
    # the log-mel bands, or the linear spectrogram's 320 / 2 + 1 bins
    n_features = cfg.data.spect.features if family == "conformer" else 161
    frames = torch.tensor([61, 60, 47, 20, 9, 1], dtype=torch.int32)
    with torch.no_grad():
        _, out_lengths, _ = model(torch.randn(len(frames), n_features, 61), frames)
    assert model.output_lengths(frames).tolist() == out_lengths.tolist()


def test_checkpoint_round_trip_rebuilds_the_model_from_the_file(tmp_path):
    from dsjax_torch.inference import load_model
    from dsjax_torch.model.convert import save_checkpoint

    cfg = small_cfg()
    model = seeded_model(cfg).eval()
    path = str(tmp_path / "conformer.pt")
    save_checkpoint(path, model.state_dict(), cfg.model, cfg.data.spect, DEFAULT_LABELS)
    bundle = load_model(path, device="cpu")
    got = bundle.model
    assert isinstance(got, Conformer) and got.model_cfg == cfg.model
    assert got.encoder.layers[0].self_attn.h == 2
    assert isinstance(bundle.spect_cfg, config.LogMelConfig) and bundle.spect_cfg == cfg.data.spect
    ys = utterances()
    batch = device_batch(ys, cfg.data.spect)
    feats = features_torch(torch.from_numpy(batch.audio), torch.from_numpy(batch.input_lengths),
                           cfg.data.spect)
    with torch.no_grad():
        want = model(feats, torch.from_numpy(batch.input_lengths))[0]
    probs, _, _ = bundle.forward(batch.audio, batch.input_lengths)
    torch.testing.assert_close(probs, want, atol=1e-6, rtol=0)


def test_dropout_acts_in_training_only():
    cfg = config.compose(config.TrainConfig, [s for s in SMALL if "dropout" not in s])
    assert cfg.model.dropout == 0.1          # NeMo's Large row
    model = seeded_model(cfg)
    feats, frames = reference_features(utterances())
    with torch.no_grad():
        model.train()
        a, b = model(feats, frames)[0], model(feats, frames)[0]
        model.eval()
        c, d = model(feats, frames)[0], model(feats, frames)[0]
    assert not torch.equal(a, b) and torch.equal(c, d)


def test_train_evaluate_and_transcribe_through_the_entry_points(tmp_path):
    from dsjax_torch import workflows
    from tests.synthetic_manifest import write_manifest

    manifest = write_manifest(str(tmp_path / "data"), "tiny", [0.6, 0.8, 0.7, 0.9], seed=3)
    ckpt = tmp_path / "ckpt"
    cfg = config.compose(config.TrainConfig, SMALL + [
        f"data.train_path={manifest}", f"data.val_path={manifest}", "data.batch_size=2",
        "data.num_workers=1", "trainer.max_epochs=1", "trainer.device=cpu",
        "trainer.precision=32", f"checkpoint.dirpath={ckpt}", "trainer.log_dir=''",
        "data.labels_path=" + os.path.join(ROOT, "labels.json")])
    workflows.train(cfg)
    (saved,) = list((ckpt / "last").glob("*.pt"))
    ev = config.compose(config.EvalConfig, [f"model.model_path={saved}", f"test_path={manifest}",
                                            "batch_size=2", "device=cpu", "num_workers=1"])
    wer, cer = workflows.evaluate(ev)
    assert np.isfinite(wer) and np.isfinite(cer)
    tr = config.compose(config.TranscribeConfig, [f"model.model_path={saved}", "device=cpu",
                                                  f"audio_path={tmp_path}/data/wav/tiny_0.wav"])
    out = workflows.transcribe(tr)
    assert isinstance(out["output"][0]["transcription"], str)


# ---------------------------------------------------------------------------
# refusals and the command line
# ---------------------------------------------------------------------------

def test_model_conformer_composes_from_the_command_line():
    cfg = config.compose(config.TrainConfig, ["model=conformer", "model.n_heads=4",
                                              "data.spect=logmel", "data.spect.features=64"])
    assert type(cfg.model).__name__ == "ConformerConfig"
    assert (cfg.model.d_model, cfg.model.n_heads, cfg.model.n_layers) == (512, 4, 18)
    assert (cfg.model.ff_expansion_factor, cfg.model.conv_kernel_size) == (4, 31)
    assert isinstance(cfg.data.spect, config.LogMelConfig)
    assert (cfg.data.spect.n_fft, cfg.data.spect.features, cfg.data.spect.window.value) == \
        (512, 64, "hann")
    back = config.from_dict(config.to_dict(cfg), config.TrainConfig)
    assert back.model == cfg.model and back.data.spect == cfg.data.spect
    # the defaults stay dsjax's
    assert type(config.TrainConfig().data.spect) is config.SpectConfig
    assert type(config.TrainConfig().model) is config.BiDirectionalConfig


def test_unbuilt_settings_and_mesh_model_are_refused():
    from dsjax_torch.train.loop import refuse_unported

    with pytest.raises(NotImplementedError, match="trainer.mesh_model=2"):
        refuse_unported(small_cfg(["trainer.mesh_model=2"]))
    cfg = small_cfg(["model.n_heads=3"])
    with pytest.raises(ValueError, match="model.n_heads=3"):
        Conformer(29, cfg.data.spect, cfg.model)


def test_stream_and_carries_are_refused(tmp_path):
    from dsjax_torch.audio.io import save_wav
    from dsjax_torch.model.convert import save_checkpoint
    from dsjax_torch.server import serve, shutdown

    cfg = small_cfg()
    model = seeded_model(cfg).eval()
    feats, frames = reference_features(utterances())
    with pytest.raises(ValueError, match="/stream"):
        model(feats, frames, [(torch.zeros(1),)])
    path = str(tmp_path / "conformer.pt")
    save_checkpoint(path, model.state_dict(), cfg.model, cfg.data.spect, DEFAULT_LABELS)
    scfg = config.compose(config.ServerConfig, [f"model.model_path={path}", "host=127.0.0.1",
                                                "port=0", "device=cpu", "warmup_seconds=0.5"])
    server, worker = serve(scfg)
    try:
        port = server.server_address[1]
        buf = io.BytesIO()
        save_wav(buf, utterances()[0], SR)
        for route, code in (("/stream?session=a&final=1", 400), ("/transcribe", 200)):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("POST", route, body=buf.getvalue(),
                         headers={"Content-Type": "audio/wav"})
            r = conn.getresponse()
            body = json.loads(r.read())
            assert r.status == code, body
            if code == 400:
                assert "model=conformer" in body["error"]
            else:
                assert isinstance(body["output"][0]["transcription"], str)
        with pytest.raises(ValueError, match="model=conformer"):
            worker.stream_chunk("b", utterances()[1], True)
    finally:
        shutdown(server, worker)


# ---------------------------------------------------------------------------
# two DDP ranks: the conv module's BatchNorm over the global batch
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ddp_rows(rank=None):
    """The union batch's utterances and transcripts; a rank's half."""
    ys = utterances(5, (8000, 5920, 9760, 7040))
    ts = [[1 + (3 * i + r) % 27 for i in range(6 + r)] for r in range(4)]
    if rank is None:
        return ys, ts
    return ys[2 * rank:2 * rank + 2], ts[2 * rank:2 * rank + 2]


def ddp_rank_main(rank: int, out: str) -> None:
    from dsjax_torch.parallel import distributed
    from dsjax_torch.train.loop import Trainer

    distributed.initialize("cpu")
    cfg = small_cfg()
    trainer = Trainer(cfg, list(DEFAULT_LABELS))
    state = trainer.init_state()
    state.model.load_state_dict(seeded_model(cfg).state_dict())
    ys, ts = ddp_rows(rank)
    grads, loss = trainer.grad_step(state, device_batch(ys, cfg.data.spect, ts))
    stats = {k: v for k, v in state.model.state_dict().items() if "running" in k}
    torch.save({"grads": grads, "loss": loss, "stats": stats}, out)
    distributed.destroy()


def test_two_ddp_ranks_equal_one_process_over_the_union_batch(tmp_path):
    from dsjax_torch.train.loop import Trainer

    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--out", str(tmp_path / f"rank{r}.pt")], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out.decode()[-3000:]
    cfg = small_cfg()
    trainer = Trainer(cfg, list(DEFAULT_LABELS))
    state = trainer.init_state()
    state.model.load_state_dict(seeded_model(cfg).state_dict())
    ys, ts = ddp_rows()
    want, want_loss = trainer.grad_step(state, device_batch(ys, cfg.data.spect, ts))
    want_stats = {k: v for k, v in state.model.state_dict().items() if "running" in k}
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for got in ranks:
        # DDP averages the ranks' gradients: the union batch's over 2
        assert_grads_close(got["grads"], {k: v / 2 for k, v in want.items()})
        assert abs(float(got["loss"]) - float(want_loss) / 2) <= 1e-4 * abs(float(want_loss))
        for k, v in want_stats.items():
            torch.testing.assert_close(got["stats"][k], v, atol=1e-6, rtol=1e-5)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    ddp_rank_main(args.rank, args.out)
