"""dsjax_torch's evaluation and transcription against dsjax's, on the CPU.

One reference-layout checkpoint of a small seeded model (H=64, 2 layers,
the head scaled up so posteriors are decisive, as tests/test_torch_server.py
does) is written by the port's ``save_checkpoint`` and loaded by both
packages (dsjax through its torch importer). On a synthetic manifest both
``workflows.evaluate`` print the same references and hypotheses in the same
order and return equal WER/CER, greedy and beam (W=8), with the STFT on the
device from int16 raw audio (the default) and on the host; ``transcribe``
gives the same result JSON, offsets and several beams included; the two
CLIs run end to end.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dsjax import config as jax_config
from dsjax.inference import load_model as jax_load_model
from dsjax.workflows import evaluate as jax_evaluate
from dsjax.workflows import transcribe as jax_transcribe
from dsjax_torch import config
from dsjax_torch.audio.features import FeatureExtractor, pad_audio_for_device
from dsjax_torch.audio.io import load_audio
from dsjax_torch.inference import load_model
from dsjax_torch.labels import DEFAULT_LABELS
from dsjax_torch.model import convert
from dsjax_torch.workflows import evaluate, transcribe
from tests.synthetic_manifest import write_manifest
from tests.test_torch_model import reference_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECONDS = [0.7, 1.3, 0.9, 2.1, 1.6, 0.5, 1.1, 1.8, 1.0, 0.6]
# the batched device STFT against the host's and the int16 upload: the
# posteriors of the two feature paths differ by float rounding only
FEATURE_PATH_ATOL = 1e-5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval"))
    state = reference_state(seed=21, hidden=64, layers=2, fc_scale=4.0)
    path = os.path.join(root, "model.ckpt")
    model_cfg, _ = convert.infer_architecture(state)
    convert.save_checkpoint(path, convert.from_reference_state_dict(state), model_cfg,
                            config.SpectConfig(), DEFAULT_LABELS)
    manifest = write_manifest(root, "test", SECONDS, seed=3)
    return path, manifest, root


def run(fn, cfg):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(cfg)
    return result, out.getvalue()


def pairs(stdout):
    """The Ref/Hyp lines evaluate prints, in order."""
    return [line for line in stdout.splitlines() if line.startswith(("Ref:", "Hyp:"))]


@pytest.mark.parametrize("decoder,device_features", [
    ("greedy", "true"), ("beam", "true"), ("beam", "false")])
def test_evaluate_matches_dsjax(corpus, decoder, device_features):
    path, manifest, _ = corpus
    argv = [f"model.model_path={path}", f"test_path={manifest}", "batch_size=4",
            "num_workers=1", f"lm.decoder_type={decoder}", "lm.beam_width=8",
            f"device_features={device_features}"]
    got, got_out = run(evaluate, config.compose(config.EvalConfig, argv + ["device=cpu"]))
    want, want_out = run(jax_evaluate, jax_config.compose(jax_config.EvalConfig, argv))
    assert len(pairs(got_out)) == 2 * len(SECONDS)
    assert pairs(got_out) == pairs(want_out)
    assert got == want
    summary = [line for line in got_out.splitlines() if line.startswith("Test Summary")]
    assert len(summary) == 1 and "utt/s eval" in summary[0]


def test_raw_audio_forward_matches_host_features_and_dsjax(corpus):
    """ModelBundle.forward on a (B, L_pad) int16 batch: the device STFT,
    then the model; against the host-feature forward of the same audio and
    against dsjax's raw-audio forward."""
    path, _, root = corpus
    bundle = load_model(path, device="cpu")
    ys = [load_audio(os.path.join(root, "wav", f"test_{i}.wav")) for i in (3, 0, 5)]
    items = [pad_audio_for_device(y, bundle.spect_cfg) for y in ys]
    n_valid = np.array([n for _, n in items], np.int32)
    audio = np.zeros((len(ys), len(items[0][0])), np.int16)
    for i, (yp, _) in enumerate(items):
        audio[i, : len(yp)] = np.clip(np.rint(yp * 32768.0), -32768, 32767)
    probs, out_lens, _ = bundle.forward(audio, n_valid)
    extractor = FeatureExtractor(bundle.spect_cfg)
    spects = [extractor(y) for y in ys]
    feats = np.zeros((len(ys), spects[0].shape[0], int(n_valid.max())), np.float32)
    for i, s in enumerate(spects):
        feats[i, :, : s.shape[1]] = s
    host, host_lens, _ = bundle.forward(feats, n_valid)
    assert torch.equal(out_lens, host_lens)
    for i, n in enumerate(out_lens.tolist()):
        torch.testing.assert_close(probs[i, :n], host[i, :n], atol=FEATURE_PATH_ATOL, rtol=0)
    want, want_lens, _ = jax_load_model(path).forward(audio, n_valid)
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(want_lens))
    for i, n in enumerate(out_lens.tolist()):
        np.testing.assert_allclose(probs[i, :n].numpy(), np.asarray(want)[i, :n],
                                   atol=FEATURE_PATH_ATOL, rtol=0)
    with pytest.raises(ValueError, match="carry"):
        bundle.forward(audio, n_valid, carry=((), ()))


@pytest.mark.parametrize("extra", [
    ["lm.decoder_type=greedy", "offsets=true"],
    ["lm.decoder_type=beam", "lm.beam_width=8", "lm.top_paths=3", "offsets=true"],
    ["lm.decoder_type=beam", "lm.beam_width=8", "chunk_size_seconds=0.5"],
], ids=["greedy", "beam-top3-offsets", "beam-chunked"])
def test_transcribe_matches_dsjax(corpus, extra):
    path, _, root = corpus
    argv = [f"model.model_path={path}", f"audio_path={os.path.join(root, 'wav', 'test_3.wav')}"]
    got, got_out = run(transcribe, config.compose(config.TranscribeConfig,
                                                  argv + extra + ["device=cpu"]))
    want, _ = run(jax_transcribe, jax_config.compose(jax_config.TranscribeConfig, argv + extra))
    assert got == want
    assert json.loads(got_out) == got
    assert got["output"][0]["transcription"]


def test_evaluate_and_transcribe_clis(corpus):
    path, manifest, root = corpus
    out = subprocess.run(
        [sys.executable, "-m", "dsjax_torch.evaluate", f"model.model_path={path}",
         f"test_path={manifest}", "batch_size=4", "num_workers=1", "device=cpu",
         "lm.decoder_type=beam", "lm.beam_width=4", "verbose=false"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("Test Summary") and "Average WER" in out.stdout
    out = subprocess.run(
        [sys.executable, "-m", "dsjax_torch.transcribe", f"model.model_path={path}",
         f"audio_path={os.path.join(root, 'wav', 'test_1.wav')}", "device=cpu",
         "lm.decoder_type=greedy"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout)
    assert result["_meta"]["decoder"]["type"] == "greedy" and len(result["output"]) == 1


@pytest.mark.parametrize("device_beam", ["true", "false"])
def test_evaluate_with_lm_matches_dsjax(corpus, device_beam, tmp_path):
    """evaluate with a word 2-gram over the corpus's vocabulary, fused into
    the device beam (lm.device_beam=true) or on the host beam: the same
    Ref/Hyp lines and WER/CER as dsjax's; transcribe with the LM too."""
    from tests.synthetic_manifest import WORDS
    from tests.synthetic_lm import write_arpa

    path, manifest, root = corpus
    rng = np.random.default_rng(8)
    uni = {(w,): (round(float(-rng.uniform(1, 2)), 4), -0.3) for w in WORDS}
    uni[("<unk>",)] = (-3.0, 0.0)
    bi = {(a, b): (round(float(-rng.uniform(0.2, 1)), 4), -0.1)
          for a, b in rng.choice(WORDS, size=(60, 2))}
    lm = write_arpa(tmp_path / "words.arpa", [uni, bi])
    lm_args = ["lm.decoder_type=beam", "lm.beam_width=8", f"lm.lm_path={lm}", "lm.alpha=1.5",
               "lm.beta=0.5", f"lm.device_beam={device_beam}", "lm.lm_workers=2"]
    argv = [f"model.model_path={path}", f"test_path={manifest}", "batch_size=4",
            "num_workers=1"] + lm_args
    got, got_out = run(evaluate, config.compose(config.EvalConfig, argv + ["device=cpu"]))
    want, want_out = run(jax_evaluate, jax_config.compose(jax_config.EvalConfig, argv))
    assert len(pairs(got_out)) == 2 * len(SECONDS)
    assert pairs(got_out) == pairs(want_out)
    assert got == want
    argv = [f"model.model_path={path}", f"audio_path={os.path.join(root, 'wav', 'test_3.wav')}",
            "lm.top_paths=2"] + lm_args
    got, _ = run(transcribe, config.compose(config.TranscribeConfig, argv + ["device=cpu"]))
    want, _ = run(jax_transcribe, jax_config.compose(jax_config.TranscribeConfig, argv))
    assert got == want
