"""Continuing a dsjax training run in the port (CPU, H=32, 2 layers, f32).

dsjax's Trainer trains N=2 steps on a synthetic corpus of 5 batches, saves
with dsjax's own CheckpointHandler mid-epoch (``last_only``, with the
sampler's ``start_index`` and the epoch) and resumes that save as dsjax
does (its handler's restore, the sampler at ``start_index``) for the K=3
steps left in the epoch. ``tools/dsjax_checkpoint_to_torch.py`` mirrors that
directory into the port's layout, and the port resumes it:

  * the converted Adam moments and count (SGD's trace), weights, running
    statistics, step, epoch and start_index equal dsjax's exactly under the
    layout map (``tests/dsjax_layout.py`` maps them back as well);
  * ``workflows.train`` with ``load_auto_checkpoint=true`` over the
    converted directory trains the K remaining steps on dsjax's batches
    (dsjax's sampler redraws the bins from ``start_index`` on) and gives
    dsjax's continued losses and parameters (tolerances below), for AdamW
    and SGD, and bit for bit the port's own continuation of the converted
    state in memory;
  * ``python -m dsjax_torch.train`` on it trains as many remaining steps as
    dsjax's ``workflows.train`` resuming its own directory;
  * the run's optimizer settings win over the file's, as in dsjax: a
    resume with another weight_decay (SGD: momentum) takes dsjax's next
    step; another optimizer kind raises; a dsjax directory handed to the
    port's trainer raises with the tool's name; a run of mesh_model=2
    converts to the same files;
  * the named overlays (copies of dsjax's, byte for byte) compose to
    dsjax's configs, and ``-h``/``--help`` of the four entry modules prints
    dsjax's listing and exits 0.

The parameters are compared by their change over the resumed steps against
dsjax's change, per tensor.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from dsjax import config as jax_config
from dsjax_torch import config
from dsjax_torch.labels import DEFAULT_LABELS
from dsjax_torch.model.convert import from_dsjax_params, from_dsjax_variables
from tests.dsjax_layout import to_dsjax_state, to_dsjax_trees
from tests.synthetic_manifest import write_manifest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "dsjax_checkpoint_to_torch.py")
N_SAVED, N_LEFT = 2, 3
# the first resumed step's loss is a forward from the converted state:
# test_train_step_matches_dsjax_trainer's loss tolerance (measured 3e-7)
FIRST_RTOL = 1e-4
# the later ones follow two f32 trajectories: at the SGD run's resumed state
# one element of the conv stack's second hardtanh input lies 2.4e-7 from the
# clip boundary, dsjax's f32 (and an f64 run) put it inside and the port's
# outside, which moves conv2's gradient by 1.2% of its largest and the next
# losses by up to 4.2e-4 (measured); elsewhere the port's f32 gradients are
# as close to f64 as dsjax's (1e-5)
LOSS_RTOL = 1e-3
# the parameters' change over the resumed steps against dsjax's: this x the
# largest change of each tensor (measured: SGD 1.7e-2 after the boundary
# flip above, AdamW 4.3e-3, its per-element normalisation magnifying
# near-zero gradients), plus the f32 rounding of the parameter itself in
# each step (test_optimizer_matches_optax's 1e-6 x the parameter's largest
# magnitude)
UPDATE_RTOL, PARAM_ATOL = 5e-2, 1e-6
SETTINGS = {"adam": "optim.weight_decay=0.1", "sgd": "optim.momentum=0.5"}


def tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location("dsjax_checkpoint_to_torch", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def argv_of(root, optim):
    # 10 utterances of 0.7-1.2 s: 5 batches of 2, each padded to 128 frames
    train = write_manifest(root, "train", [1.0, 1.12, 0.7, 1.1, 0.9, 1.05, 0.8, 1.2, 0.95, 0.75],
                           seed=0)
    return [f"data.train_path={train}", f"data.val_path={train}", "data.batch_size=2",
            "data.device_features=false", "data.num_workers=1", "model.hidden_size=32",
            "model.hidden_layers=2", "trainer.precision=32", "seed=7",
            f"optim={optim}"]


def jax_trainer(jcfg):
    from dsjax.parallel.mesh import make_mesh
    from dsjax.train.loop import Trainer

    return Trainer(jcfg, list(DEFAULT_LABELS), mesh=make_mesh(1, 1, devices=jax.devices()[:1]))


def jax_batches(jcfg, start_index=0):
    """Epoch 0's batches from dsjax's pipeline; a resume at start_index
    draws the bins from start_index on in an order of their own
    (dsjax/data/sampler.py:44-50, the reference's DSRandomSampler)."""
    from dsjax.workflows import _pipelines

    train, _ = _pipelines(jcfg, list(DEFAULT_LABELS), dp=1)
    train.sampler.set_epoch(0)
    train.sampler.start_index = start_index
    return list(train)


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


class DsjaxRun:
    """dsjax's run: N_SAVED steps, a mid-epoch save, then dsjax's resume of
    it (its handler's restore and the sampler at start_index) for the
    N_LEFT steps left in the epoch."""

    def __init__(self, root, optim):
        from dsjax.train.checkpoint import CheckpointHandler

        self.root, self.optim = root, optim
        self.argv = argv_of(root, optim)
        self.jcfg = jax_config.compose(jax_config.TrainConfig,
                                       self.argv + ["trainer.mesh_data=1"])
        batches = jax_batches(self.jcfg)
        assert len(batches) == N_SAVED + N_LEFT
        trainer = jax_trainer(self.jcfg)
        state = trainer.init_state()
        for b in batches[:N_SAVED]:
            state, loss = trainer.train_step(state, b)
        self.saved = np_tree(state)   # the steps donate the state's buffers
        self.dir = os.path.join(root, "dsjax_ckpt")
        handler = CheckpointHandler(self.dir, cfg=self.jcfg, labels=list(DEFAULT_LABELS))
        handler.save(state, {"loss": float(loss)}, extra={"start_index": N_SAVED, "epoch": 0},
                     last_only=True)
        state = handler.restore(trainer.init_state())
        assert handler.restore_extra() == {"start_index": N_SAVED, "epoch": 0}
        handler.close()
        self.batches = jax_batches(self.jcfg, start_index=N_SAVED)
        assert len(self.batches) == N_LEFT
        self.losses, self.states = [], [self.saved]
        for b in self.batches:
            state, loss = trainer.train_step(state, b)
            self.losses.append(float(loss))
            self.states.append(np_tree(state))
        self.port_dir = os.path.join(root, "port_ckpt")
        assert tool().convert(self.dir, self.port_dir) == "last"


_RUNS = {}


def dsjax_run(optim, tmp_path_factory):
    if optim not in _RUNS:
        _RUNS[optim] = DsjaxRun(str(tmp_path_factory.mktemp(f"resume_{optim}")), optim)
    return _RUNS[optim]


@pytest.fixture(scope="module", params=["adam", "sgd"])
def run(request, tmp_path_factory):
    return dsjax_run(request.param, tmp_path_factory)


def port_cfg(run, *extra):
    return config.compose(config.TrainConfig, run.argv + ["trainer.device=cpu", *extra])


def port_trainer(cfg):
    from dsjax_torch.train.loop import Trainer

    return Trainer(cfg, list(DEFAULT_LABELS))


def port_batches(cfg):
    """The port's batches of the resumed epoch: dsjax's, in dsjax's order."""
    from dsjax_torch import workflows

    train, _ = workflows._pipelines(cfg, list(DEFAULT_LABELS))
    train.sampler.set_epoch(0)
    train.sampler.start_index = N_SAVED
    return list(train)


def params_of(state):
    return {k: v.detach().clone() for k, v in state.model.named_parameters()}


def assert_updates_close(before, after, jax_before, jax_after, what):
    """Each parameter's change against dsjax's, at UPDATE_RTOL x the largest
    magnitude of dsjax's change of that tensor plus PARAM_ATOL x the
    parameter's; returns the largest error as a share of that tolerance."""
    want0, want1 = from_dsjax_params(jax_before), from_dsjax_params(jax_after)
    worst = 0.0
    for name in want0:
        np.testing.assert_array_equal(before[name].numpy(), want0[name].numpy(), err_msg=name)
        want = (want1[name] - want0[name]).numpy()
        got = (after[name] - before[name]).numpy()
        atol = (UPDATE_RTOL * float(np.abs(want).max())
                + PARAM_ATOL * float(np.abs(want1[name].numpy()).max()))
        worst = max(worst, float(np.abs(got - want).max()) / atol)
        np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=f"{what}: {name}")
    return worst


def test_converted_state_equals_dsjax_exactly(run):
    """Weights, running stats, moments and counts, step, epoch and the
    sampler position, bit for bit, and back through the inverse map."""
    from dsjax_torch.train.checkpoint import CheckpointHandler, restore_file

    handler = CheckpointHandler(run.port_dir)
    path = handler.path()
    assert os.path.basename(path) == f"step_{N_SAVED}.pt"
    assert handler.restore_extra() == {"start_index": N_SAVED, "epoch": 0}
    state, extra = restore_file(path, port_trainer(port_cfg(run)).init_state())
    assert (state.step, state.epoch, extra) == (N_SAVED, 0, {"start_index": N_SAVED, "epoch": 0})
    want = from_dsjax_variables(run.saved.variables())
    for name, t in state.model.state_dict().items():
        assert torch.equal(t, want[name]), name
    named = dict(state.model.named_parameters())
    inner = run.saved.opt_state[1].inner_state
    if run.optim == "sgd":
        trace = from_dsjax_params(inner[1][0].trace)
        for name, p in named.items():
            assert torch.equal(state.optimizer.state[p]["momentum_buffer"], trace[name]), name
    else:
        adam = inner[0]
        mu, nu = from_dsjax_params(adam.mu), from_dsjax_params(adam.nu)
        for name, p in named.items():
            s = state.optimizer.state[p]
            assert s["step"].dtype == torch.float32 and s["step"].device.type == "cpu"
            assert float(s["step"]) == int(adam.count) == N_SAVED
            assert torch.equal(s["exp_avg"], mu[name]) and torch.equal(s["exp_avg_sq"], nu[name])
    back = to_dsjax_state(state)
    want_moments = ({"trace": inner[1][0].trace} if run.optim == "sgd" else
                    {"count": N_SAVED, "mu": inner[0].mu, "nu": inner[0].nu})
    for got, want in ((back["params"], run.saved.params),
                      (back["batch_stats"], run.saved.batch_stats),
                      (back["moments"], want_moments)):
        assert (jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want))
        jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    assert (back["step"], back["epoch"]) == (N_SAVED, 0)


def test_resumed_run_gives_dsjax_losses_and_parameters(run, tmp_path):
    """workflows.train with load_auto_checkpoint over the converted
    directory trains the epoch's remaining steps on dsjax's batches: dsjax's
    losses and parameters, and bit for bit the port's own continuation of
    the state in memory (the file round trip adds nothing)."""
    from dsjax_torch import workflows
    from dsjax_torch.train.checkpoint import from_dsjax_state

    ckpt = str(tmp_path / "ckpt")
    shutil.copytree(run.port_dir, ckpt)
    cfg = port_cfg(run, f"checkpoint.dirpath={ckpt}", "load_auto_checkpoint=true",
                   "trainer.max_epochs=1", "trainer.log_every_n_steps=1",
                   f"trainer.log_dir={tmp_path / 'logs'}")
    state = workflows.train(cfg)
    assert (state.step, state.epoch) == (N_SAVED + N_LEFT, 0)
    records = [json.loads(line) for line in open(tmp_path / "logs" / "metrics.jsonl")]
    losses = [r["loss"] for r in records if "loss" in r]
    np.testing.assert_allclose(losses[:1], run.losses[:1], rtol=FIRST_RTOL)
    np.testing.assert_allclose(losses, run.losses, rtol=LOSS_RTOL)

    s = run.saved
    inner = s.opt_state[1].inner_state
    moments = ({"trace": inner[1][0].trace} if run.optim == "sgd" else
               {"count": int(inner[0].count), "mu": inner[0].mu, "nu": inner[0].nu})
    mem = from_dsjax_state(str(tmp_path / "mem.pt"), cfg, list(DEFAULT_LABELS), s.params,
                           s.batch_stats, moments, int(s.step), int(s.epoch))
    trainer = port_trainer(cfg)
    before = params_of(mem)
    mem_losses = []
    for batch in port_batches(cfg):
        mem, loss = trainer.train_step(mem, batch)
        mem_losses.append(float(loss))
    assert mem_losses == losses
    after = params_of(state)
    for name, p in params_of(mem).items():
        assert torch.equal(after[name], p), name
    worst = assert_updates_close(before, after, run.states[0].params, run.states[-1].params,
                                 "after the resumed steps")
    print(f"{run.optim}: losses {losses} against dsjax's {run.losses}; largest parameter "
          f"error {worst!r} of its tolerance")


def test_cli_trains_the_steps_dsjax_resumes(tmp_path, tmp_path_factory):
    """python -m dsjax_torch.train load_auto_checkpoint=true on the converted
    directory ends at the step dsjax's workflows.train ends at, resuming its
    own directory."""
    from dsjax.train.checkpoint import CheckpointHandler
    from dsjax.workflows import train as jax_train

    run = dsjax_run("adam", tmp_path_factory)
    tail = ["load_auto_checkpoint=true", "trainer.max_epochs=1", "trainer.log_dir=''",
            "trainer.limit_val_batches=1", "trainer.log_every_n_steps=1"]
    jax_dir = str(tmp_path / "dsjax")
    shutil.copytree(run.dir, jax_dir)
    jax_train(jax_config.compose(jax_config.TrainConfig,
                                 run.argv + [f"checkpoint.dirpath={jax_dir}", *tail]))
    handler = CheckpointHandler(jax_dir)
    jax_last = handler.last.latest_step()
    handler.close()
    assert jax_last == N_SAVED + N_LEFT

    port_dir = str(tmp_path / "port")
    shutil.copytree(run.port_dir, port_dir)
    done = subprocess.run([sys.executable, "-m", "dsjax_torch.train", *run.argv,
                           "trainer.device=cpu", f"checkpoint.dirpath={port_dir}", *tail],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    assert f"auto-resumed from step {N_SAVED}" in done.stdout
    steps = sorted(int(n[5:-3]) for n in os.listdir(os.path.join(port_dir, "last")))
    assert steps == [jax_last]
    logged = [ln.split()[:3] for ln in done.stdout.splitlines() if ln.startswith("epoch 0 step")]
    assert logged == [["epoch", "0", "step"]] * N_LEFT, done.stdout


def test_run_settings_win_over_the_file(run):
    """A resume with another weight decay (AdamW) or momentum (SGD) takes
    dsjax's next step under the new value, which differs from the step
    under the file's."""
    from dsjax.train.checkpoint import restore_from_path as jax_restore_from_path
    from dsjax_torch.train.checkpoint import restore_from_path

    setting = SETTINGS[run.optim]
    key, value = setting.split("=")
    jcfg = jax_config.compose(jax_config.TrainConfig,
                              run.argv + ["trainer.mesh_data=1", setting])
    jtrainer = jax_trainer(jcfg)
    jstate, _ = jax_restore_from_path(run.dir, jtrainer.init_state())
    jstate, jloss = jtrainer.train_step(jstate, run.batches[0])
    want = np_tree(jstate.params)

    cfg = port_cfg(run, setting)
    trainer = port_trainer(cfg)
    state, _ = restore_from_path(run.port_dir, trainer.init_state())
    group = state.optimizer.param_groups[0]
    assert group[key.split(".")[1]] == float(value)
    before = params_of(state)
    state, loss = trainer.train_step(state, port_batches(cfg)[0])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=FIRST_RTOL)
    assert_updates_close(before, params_of(state), run.saved.params, want, setting)
    with pytest.raises(AssertionError):
        assert_updates_close(before, params_of(state), run.saved.params,
                             run.states[1].params, "the file's settings")


def test_another_optimizer_kind_raises(run, tmp_path):
    """dsjax cannot restore one optimizer's state into another's; neither
    does the port, nor does the conversion write it."""
    from dsjax_torch.train.checkpoint import from_dsjax_state, restore_from_path

    other = {"adam": "sgd", "sgd": "adam"}[run.optim]
    cfg = port_cfg(run, f"optim={other}")
    with pytest.raises(ValueError, match="optim"):
        restore_from_path(run.port_dir, port_trainer(cfg).init_state())
    s = run.saved
    inner = s.opt_state[1].inner_state
    moments = ({"trace": inner[1][0].trace} if run.optim == "sgd" else
               {"count": int(inner[0].count), "mu": inner[0].mu, "nu": inner[0].nu})
    with pytest.raises(ValueError, match="moments"):
        from_dsjax_state(str(tmp_path / "x.pt"), cfg, list(DEFAULT_LABELS), s.params,
                         s.batch_stats, moments, 2, 0)


def test_dsjax_directory_is_refused_with_the_tool(run, tmp_path):
    """Handed to the port's trainer (explicit path, or its dirpath with
    auto-resume), dsjax's own directory raises and names the tool; its
    meta.json stays as dsjax wrote it."""
    from dsjax_torch import workflows
    from dsjax_torch.train.checkpoint import CheckpointHandler, restore_from_path

    meta = open(os.path.join(run.dir, "meta.json")).read()
    state = port_trainer(port_cfg(run)).init_state()
    for path in (run.dir, os.path.join(run.dir, "last")):
        with pytest.raises(IsADirectoryError, match="dsjax_checkpoint_to_torch.py"):
            restore_from_path(path, state)
    with pytest.raises(IsADirectoryError, match="dsjax_checkpoint_to_torch.py"):
        CheckpointHandler(run.dir)
    with pytest.raises(IsADirectoryError, match="dsjax_checkpoint_to_torch.py"):
        workflows.train(port_cfg(run, f"checkpoint.dirpath={run.dir}",
                                 "load_auto_checkpoint=true", "trainer.log_dir=''"))
    assert open(os.path.join(run.dir, "meta.json")).read() == meta


def test_tool_converts_a_tensor_parallel_run(run, tmp_path):
    """A run with trainer.mesh_model > 1 has whole weights: the tool converts
    it into the same files as the run's own (mesh_model=1) directory, with
    mesh_model=2 in the port's meta.json, which the port's trainer
    continues under torchrun (tests/test_torch_tensor_parallel.py)."""
    from dsjax_torch.model.convert import load_checkpoint

    ckpt = str(tmp_path / "tp")
    shutil.copytree(run.dir, ckpt)
    meta = json.load(open(os.path.join(ckpt, "meta.json")))
    meta["config"]["trainer"]["mesh_model"] = 2
    json.dump(meta, open(os.path.join(ckpt, "meta.json"), "w"))
    out = str(tmp_path / "out")
    assert tool().convert(ckpt, out) == "last"
    port_meta = json.load(open(os.path.join(out, "meta.json")))
    assert config.from_dict(port_meta["config"], config.TrainConfig).trainer.mesh_model == 2
    name = f"step_{N_SAVED}.pt"
    got, want = (load_checkpoint(os.path.join(d, "last", name)) for d in (out, run.port_dir))
    assert sorted(got) == sorted(want)
    for key in ("step", "epoch", "metrics", "extra"):
        assert got[key] == want[key], key
    for k, t in want["state_dict"].items():
        assert torch.equal(got["state_dict"][k], t), k
    for i, entry in want["optimizer"]["state"].items():
        for k, t in entry.items():
            assert torch.equal(got["optimizer"]["state"][i][k], t), (i, k)


VARIANTS = {"bilstm": [], "bigru": ["model.rnn_type=gru"], "birnn": ["model.rnn_type=rnn"],
            "gru_lookahead": ["model=unidirectional", "model.rnn_type=gru",
                              "model.lookahead_context=3"]}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_layout_map_round_trips_dsjax_trees(variant):
    """from_dsjax_params and tests/dsjax_layout.py are inverses on dsjax's
    own trees of every model, exactly; a leaf too many or too few raises."""
    argv = VARIANTS[variant] + ["model.hidden_size=16", "model.hidden_layers=2",
                                "trainer.precision=32"]
    jstate = jax_trainer(jax_config.compose(jax_config.TrainConfig, argv)).init_state()
    params, stats = np_tree(jstate.params), np_tree(jstate.batch_stats)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(a.dtype),
                                    params)
    port = from_dsjax_variables({"params": params, "batch_stats": stats})
    model = port_trainer(port_cfg_of(argv)).init_state().model
    assert sorted(port) == sorted(model.state_dict())
    assert sorted(from_dsjax_params(params)) == sorted(n for n, _ in model.named_parameters())
    back_params, back_stats = to_dsjax_trees(port)
    for got, want in ((back_params, params), (back_stats, stats)):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    extra = dict(params, fc={**params["fc"], "bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="fc/bias"):
        from_dsjax_params(extra)
    missing = {k: v for k, v in params.items() if k != "fc_bn"}
    with pytest.raises(ValueError, match="fc_bn/scale"):
        from_dsjax_params(missing)


def port_cfg_of(argv):
    return config.compose(config.TrainConfig, argv + ["trainer.device=cpu"])


def test_meta_json_records_dsjax_tagged_config(tmp_path):
    """The port's handler writes meta.json's config with dsjax's to_dict
    (each group tagged with its _type_), which both packages' from_dict
    read back into the same config."""
    from dsjax_torch.train.checkpoint import CheckpointHandler

    argv = ["optim=sgd", "optim.momentum=0.5", "model=unidirectional",
            "data.spect.window=hann", "trainer.max_epochs=3"]
    cfg = config.compose(config.TrainConfig, argv + ["trainer.device=cpu"])
    CheckpointHandler(str(tmp_path), cfg=cfg, labels=list(DEFAULT_LABELS))
    meta = json.load(open(tmp_path / "meta.json"))
    want = jax_config.to_dict(jax_config.compose(jax_config.TrainConfig, argv))
    got = json.loads(json.dumps(meta["config"]))
    assert got["trainer"].pop("device") == "cpu"
    assert got == want and got["optim"]["_type_"] == "SGDConfig"
    assert config.from_dict(meta["config"], config.TrainConfig) == cfg
    assert jax_config.from_dict(meta["config"], jax_config.TrainConfig) == \
        jax_config.compose(jax_config.TrainConfig, argv)


OVERLAYS = ("an4", "commonvoice", "librispeech", "tedlium")


@pytest.mark.parametrize("name", OVERLAYS)
def test_named_overlay_is_dsjax_copy_and_composes_as_dsjax(name, tmp_path, monkeypatch):
    """+configs=NAME finds the port's copy (byte for byte dsjax's) from any
    directory and composes to dsjax's config."""
    with open(os.path.join(ROOT, "dsjax_torch", "configs", f"{name}.yaml"), "rb") as f:
        port_bytes = f.read()
    with open(os.path.join(ROOT, "dsjax", "configs", f"{name}.yaml"), "rb") as f:
        assert port_bytes == f.read()
    monkeypatch.chdir(tmp_path)
    assert config.find_overlay(name) == os.path.join(ROOT, "dsjax_torch", "configs",
                                                     f"{name}.yaml")
    argv = [f"+configs={name}", "trainer.max_epochs=3"]
    got = config.to_dict(config.compose(config.TrainConfig, argv))
    assert got["trainer"].pop("device") == "cuda"
    assert got == jax_config.to_dict(jax_config.compose(jax_config.TrainConfig, argv))


def test_missing_overlay_names_both_directories(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError) as err:
        config.compose(config.TrainConfig, ["+configs=nope"])
    assert os.path.join(ROOT, "dsjax_torch", "configs") in str(err.value)
    assert "'configs'" in str(err.value)
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "nope.yaml").write_text("data:\n  batch_size: 3\n")
    assert config.compose(config.TrainConfig, ["+configs=nope"]).data.batch_size == 3


ENTRY_MODULES = {"dsjax_torch.train": "TrainConfig", "dsjax_torch.evaluate": "EvalConfig",
                 "dsjax_torch.server": "ServerConfig",
                 "dsjax_torch.transcribe": "TranscribeConfig"}


@pytest.mark.parametrize("module", sorted(ENTRY_MODULES))
def test_help_lists_dsjax_options(module):
    """-h/--help prints the module's docstring and dsjax's print_help listing
    of its schema (without the port's device fields and dsjax's unread
    EvalConfig.save_output), and exits 0."""
    schema = ENTRY_MODULES[module]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_config.print_help(getattr(jax_config, schema))
    want = [ln for ln in out.getvalue().splitlines() if "save_output" not in ln]
    for flag in ("--help", "-h"):
        done = subprocess.run([sys.executable, "-m", module, "model.model_path=x.pt", flag],
                              cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert done.returncode == 0, done.stderr[-3000:]
        lines = done.stdout.splitlines()
        header = lines.index(want[0])
        assert "python -m " + module.replace(".__main__", "") in "\n".join(lines[:header])
        got = [ln for ln in lines[header:]
               if not ln.lstrip().startswith(("device = ", "trainer.device = "))]
        assert got == want
