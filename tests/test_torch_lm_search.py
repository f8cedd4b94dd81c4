"""dsjax_torch's LM tuner (``search_lm_params``, ``select_lm_params``) against
dsjax's scripts, on the CPU.

TPE-lite and the grid propose dsjax's points, in dsjax's order, for the
same seed and a stub objective. The ``Objective`` of a 2 x 2 grid on a tiny
seeded checkpoint (device=cpu) equals decoding the cached posteriors with
the decoders directly, on the device route (one packed LM shared by the
workers) and the host route, and the CLI writes the JSON that
``select_lm_params`` reads, which picks the least WER as dsjax's does.
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

import search_lm_params as jax_slp
from dsjax_torch import config
from dsjax_torch import search_lm_params as slp
from dsjax_torch import select_lm_params
from dsjax_torch.data.dataset import SpectrogramDataset, collate
from dsjax_torch.decode.beam import BeamCTCDecoder
from dsjax_torch.decode.beam_device import DeviceBeamDecoder
from dsjax_torch.decode.greedy import GreedyDecoder
from dsjax_torch.inference import load_model
from dsjax_torch.labels import DEFAULT_LABELS
from dsjax_torch.model import convert
from dsjax_torch.train.metrics import CharErrorRate, WordErrorRate, update_batch
from tests.synthetic_manifest import WORDS, write_manifest
from tests.synthetic_lm import write_arpa
from tests.test_torch_model import reference_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class StubObjective:
    """A deterministic (alpha, beta) -> (wer, cer) surface with its minimum
    at (1.2, 0.4)."""

    def evaluate_many(self, points):
        return [((a - 1.2) ** 2 + (b - 0.4) ** 2, abs(a - 1.2) + 0.5 * abs(b - 0.4))
                for a, b in points]


@pytest.mark.parametrize("n_trials,n_jobs,char", [(12, 1, True), (25, 3, False), (9, 4, True)])
def test_tpe_lite_proposes_dsjax_points(n_trials, n_jobs, char, capsys):
    kw = dict(n_trials=n_trials, n_jobs=n_jobs, is_character_based=char, seed=7,
              alpha_to=2.5, beta_from=-0.5)
    got = slp.tpe_lite(StubObjective(), slp.OptimizerConfig(**kw))
    want = jax_slp.tpe_lite(StubObjective(), jax_slp.OptimizerConfig(**kw))
    assert got == want and len(got) == n_trials
    got_grid = slp.grid_search(StubObjective(), slp.OptimizerConfig(grid_steps=3, **kw))
    assert got_grid == jax_slp.grid_search(StubObjective(),
                                           jax_slp.OptimizerConfig(grid_steps=3, **kw))
    capsys.readouterr()


def test_optimizer_config_fields_match_dsjax():
    """The port's OptimizerConfig is dsjax's plus ``device`` (default cuda)."""
    import dataclasses

    theirs = {f.name: f.default for f in dataclasses.fields(jax_slp.OptimizerConfig)}
    ours = {f.name: f.default for f in dataclasses.fields(slp.OptimizerConfig)}
    assert ours.pop("device") == "cuda"
    assert ours == theirs


@pytest.fixture(scope="module")
def tuner_files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tune"))
    state = reference_state(seed=21, hidden=32, layers=2, fc_scale=4.0)
    model = os.path.join(root, "model.pt")
    model_cfg, _ = convert.infer_architecture(state)
    convert.save_checkpoint(model, convert.from_reference_state_dict(state), model_cfg,
                            config.SpectConfig(), DEFAULT_LABELS)
    manifest = write_manifest(root, "val", [0.8, 1.2, 0.6, 1.5, 1.0], seed=5)
    rng = np.random.default_rng(3)
    uni = {(w,): (round(float(-rng.uniform(1, 2)), 4), -0.3) for w in WORDS}
    uni[("<unk>",)] = (-4.0, 0.0)
    bi = {(a, b): (round(float(-rng.uniform(0.2, 1)), 4), -0.1)
          for a, b in rng.choice(WORDS, size=(40, 2))}
    lm = write_arpa(os.path.join(root, "words.arpa"), [uni, bi])
    return model, manifest, lm


def direct_grid(model, manifest, make_decoder, points, device_beam):
    """The 2 x 2 grid decoded without the Objective: the forward of each
    batch, then a decoder per point."""
    bundle = load_model(model, 32, "cpu")
    ds = SpectrogramDataset(bundle.spect_cfg, manifest, bundle.labels, normalize=True)
    target = GreedyDecoder(bundle.labels)
    batches = []
    for start in range(0, len(ds), 2):
        batch = collate([ds[i] for i in range(start, min(start + 2, len(ds)))], bucket_frames=64)
        probs, lens, _ = bundle.forward(batch.inputs, batch.input_lengths)
        refs = target.convert_to_strings([batch.targets[b, :batch.target_lengths[b]]
                                          for b in range(batch.size)])
        batches.append((probs if device_beam else probs.numpy(), lens, [r[0] for r in refs]))
    out = []
    for a, b in points:
        dec = make_decoder(a, b)
        wer, cer = WordErrorRate(), CharErrorRate()
        for probs, lens, refs in batches:
            update_batch(wer, cer, [d[0] for d in dec.decode(probs, lens, n_best=1)[0]], refs)
        out.append((wer.compute(), cer.compute()))
    return out


@pytest.mark.parametrize("device_beam", [True, False])
def test_grid_objective_equals_direct_decoding(tuner_files, device_beam, capsys):
    model, manifest, lm = tuner_files
    cfg = slp.OptimizerConfig(model_path=model, test_path=manifest, lm_path=lm, beam_width=6,
                              cutoff_top_n=29, n_jobs=2, precision=32, batch_size=2,
                              grid=True, grid_steps=2, alpha_to=2.0, beta_to=1.0,
                              device_beam=device_beam, device="cpu")
    obj = slp.Objective(cfg)
    if device_beam:
        assert all(isinstance(d, DeviceBeamDecoder) for d in obj._pool_decoders)
        assert all(d._lm is obj.decoder._lm for d in obj._pool_decoders)
    else:
        assert all(isinstance(d, BeamCTCDecoder) and d.lm is not None
                   for d in obj._pool_decoders)
    trials = slp.grid_search(obj, cfg)
    points = [(0.0, 0.0), (0.0, 1.0), (2.0, 0.0), (2.0, 1.0)]
    assert [(a, b) for a, b, _, _ in trials] == points

    def make(a, b):
        kw = dict(beam_width=6, cutoff_top_n=29, alpha=a, beta=b)
        if device_beam:
            return DeviceBeamDecoder(DEFAULT_LABELS, lm_path=lm, **kw)
        return BeamCTCDecoder(DEFAULT_LABELS, lm_path=lm, num_processes=1, **kw)

    want = direct_grid(model, manifest, make, points, device_beam)
    assert [(w, c) for _, _, w, c in trials] == want
    assert all(np.isfinite(x) for t in trials for x in t)
    capsys.readouterr()


def test_cli_writes_json_and_select_picks_the_least_wer(tuner_files, tmp_path, capsys):
    model, manifest, lm = tuner_files
    out = str(tmp_path / "grid.json")
    slp.main([f"model_path={model}", f"test_path={manifest}", f"lm_path={lm}", "grid=true",
              "grid_steps=2", "device_beam=true", "device=cpu", "precision=32",
              "beam_width=4", "n_jobs=1", f"output_path={out}"])
    printed = capsys.readouterr().out
    trials = json.load(open(out))
    assert len(trials) == 4 and "Best Params" in printed
    # select against dsjax's script on a table with a clear minimum and a tie
    rows = [[0.0, 0.0, 0.5, 0.3], [1.0, 0.0, 0.25, 0.2], [0.0, 1.0, 0.25, 0.1],
            [1.0, 1.0, 0.75, 0.4]]
    table = str(tmp_path / "rows.json")
    json.dump(rows, open(table, "w"))
    assert select_lm_params.main(["--input-path", table]) == 0
    ours = capsys.readouterr().out
    theirs = subprocess.run([sys.executable, os.path.join(ROOT, "select_lm_params.py"),
                             "--input-path", table], capture_output=True, text=True,
                            timeout=120, cwd=ROOT)
    assert theirs.returncode == 0 and ours == theirs.stdout
    assert select_lm_params.select(rows) == rows[1]
    assert select_lm_params.main(["--input-path", out]) == 0
    assert "Alpha" in capsys.readouterr().out


def test_plot_without_matplotlib_raises_clearly(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rows = [[0.0, 0.0, 0.5, 0.3], [1.0, 0.0, 0.25, 0.2]]
    with pytest.raises(RuntimeError, match="needs matplotlib"):
        select_lm_params.plot(rows, str(tmp_path / "p.png"))
