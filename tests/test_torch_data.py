"""dsjax_torch's training-side copies against dsjax's (CPU): the data pipeline
(the same batches in the same order for a seed, with and without
ragged_split), samplers, manifest tools, WER/CER and target strings, the
training config and its command lines, the metrics logger's records; and
the port's own checkpoint handler and its refusals of what the slice does
not carry.
"""

import dataclasses
import json
import os
import typing

import numpy as np
import pytest
import torch

from dsjax import config as jax_config
from dsjax.data import sampler as jax_sampler
from dsjax.train import logging as jax_logging
from dsjax.train import metrics as jax_metrics
from dsjax_torch import config
from dsjax_torch.data import sampler
from dsjax_torch.labels import DEFAULT_LABELS
from dsjax_torch.train import logging as port_logging
from dsjax_torch.train import metrics
from tests.synthetic_manifest import write_manifest

TRAIN_CONFIGS = ["AugmentationConfig", "DataConfig", "OptimConfig", "SGDConfig", "AdamConfig",
                 "CheckpointConfig", "TrainConfig"]


def plain(cfg):
    return json.loads(json.dumps(dataclasses.asdict(cfg), default=lambda e: e.value))


@pytest.mark.parametrize("name", TRAIN_CONFIGS + ["TrainerConfig"])
def test_train_config_copy_matches_dsjax(name):
    """Field for field and default for default; the trainer adds `device`."""
    port_cls, jax_cls = getattr(config, name), getattr(jax_config, name)
    port_fields = [f.name for f in dataclasses.fields(port_cls)]
    jax_fields = [f.name for f in dataclasses.fields(jax_cls)]
    port, want = plain(port_cls()), plain(jax_cls())
    if name == "TrainerConfig":
        assert port_fields == jax_fields + ["device"] and port.pop("device") == "cuda"
    elif name == "TrainConfig":
        assert port["trainer"].pop("device") == "cuda"
    if name != "TrainerConfig":
        assert port_fields == jax_fields
    names = lambda cls: {k: getattr(t, "__name__", str(t)).replace("typing.", "")
                         for k, t in typing.get_type_hints(cls).items() if k != "device"}
    assert names(port_cls) == names(jax_cls)
    assert port == want


@pytest.mark.parametrize("argv", [
    ["optim=sgd", "optim.momentum=0.5", "trainer.max_epochs=3", "data.batch_size=8"],
    ["model=unidirectional", "model.lookahead_context=5", "optim.learning_rate=1e-3",
     "trainer.precision=32"],
    ["checkpoint.dirpath=/tmp/x", "checkpoint.save_top_k=3", "seed=5",
     "load_auto_checkpoint=true", "data.spect.window=hann", "data.augmentation.noise_prob=0.1"],
    ["+optim=adam", "optim.eps=1e-6", "trainer.limit_train_batches=0.5", "data.ragged_split=2"],
])
def test_train_compose_matches_dsjax(argv):
    """Including the group swaps optim=sgd and model=unidirectional."""
    port = config.compose(config.TrainConfig, argv)
    want = jax_config.compose(jax_config.TrainConfig, argv)
    assert type(port.optim).__name__ == type(want.optim).__name__
    assert type(port.model).__name__ == type(want.model).__name__
    got = plain(port)
    assert got["trainer"].pop("device") == "cuda"
    assert got == plain(want)


def test_train_overlay_matches_dsjax(tmp_path):
    overlay = tmp_path / "run.yaml"
    overlay.write_text("optim: sgd\ndata:\n  batch_size: 16\ntrainer:\n  max_epochs: 2\n"
                       "checkpoint:\n  monitor: cer\n")
    betas = tmp_path / "betas.yaml"
    betas.write_text("optim:\n  betas: [0.8, 0.9]\n")
    for files in ([overlay], [betas]):
        argv = [f"configs={f}" for f in files]
        got = plain(config.compose(config.TrainConfig, argv))
        got["trainer"].pop("device")
        assert got == plain(jax_config.compose(jax_config.TrainConfig, argv))
    assert config.compose(config.TrainConfig, [f"configs={betas}"]).optim.betas == (0.8, 0.9)


def batch_arrays(batch):
    return [batch.inputs, batch.input_lengths, batch.targets, batch.target_lengths,
            batch.valid_mask, batch.input_percentages]


@pytest.mark.parametrize("ragged_split", [1, 2])
def test_pipeline_gives_dsjax_batches_in_dsjax_order(tmp_path, ragged_split):
    from dsjax.workflows import _pipelines as jax_pipelines
    from dsjax_torch import workflows

    seconds = [0.5 + 0.1 * i for i in range(9)]
    train = write_manifest(str(tmp_path), "train", seconds, seed=3)
    argv = [f"data.train_path={train}", f"data.val_path={train}", "data.batch_size=4",
            "data.device_features=false", "data.bucket_frames=32", "data.bucket_labels=8",
            f"data.ragged_split={ragged_split}", "seed=11"]
    jcfg = jax_config.compose(jax_config.TrainConfig, argv)
    cfg = config.compose(config.TrainConfig, argv)
    jtrain, jval = jax_pipelines(jcfg, list(DEFAULT_LABELS), dp=1)
    ptrain, pval = workflows._pipelines(cfg, list(DEFAULT_LABELS))
    for epoch in (0, 1):
        jtrain.sampler.set_epoch(epoch)
        ptrain.sampler.set_epoch(epoch)
        for jp, pp in ((jtrain, ptrain), (jval, pval)):
            got, want = list(pp), list(jp)
            assert len(got) == len(want) == 3
            for g, w in zip(got, want):
                g, w = (g, w) if isinstance(w, list) else ([g], [w])
                assert len(g) == len(w)
                for gb, wb in zip(g, w):
                    for a, b in zip(batch_arrays(gb), batch_arrays(wb)):
                        np.testing.assert_array_equal(a, b)


def test_samplers_match_dsjax():
    for cls in ("BucketBatchSampler", "OrderedBatchSampler"):
        port, ref = getattr(sampler, cls)(23, 4, seed=3), getattr(jax_sampler, cls)(23, 4, seed=3)
        for s in (port, ref):
            s.set_epoch(2)
            s.start_index = 2
        assert list(port) == list(ref) and len(port) == len(ref) == 4
        assert port.state_dict() == ref.state_dict()


def test_error_rates_match_dsjax():
    pairs = [("HELLO WORLD", "HELLO WORD"), ("", "A B"), ("THE CAT SAT", "THE CAT SAT"),
             ("A B C D", "D C B A"), ("DEEP  SPEECH", "DEEPSPEECH")]
    port = (metrics.WordErrorRate(), metrics.CharErrorRate())
    ref = (jax_metrics.WordErrorRate(), jax_metrics.CharErrorRate())
    metrics.update_batch(*port, [p[0] for p in pairs], [p[1] for p in pairs])
    jax_metrics.update_batch(*ref, [p[0] for p in pairs], [p[1] for p in pairs])
    for p, r in zip(port, ref):
        assert p.state() == r.state() and p.compute() == r.compute()
    for a, b in pairs:
        assert metrics._py_distance(a, b) == metrics._distance(a, b) == jax_metrics._distance(a, b)


def test_target_strings_match_dsjax():
    from dsjax.decode.greedy import GreedyDecoder as JaxGreedyDecoder
    from dsjax_torch.decode.greedy import GreedyDecoder

    seqs = [np.array([8, 5, 12, 12, 15, 28, 0, 23]), np.array([], np.int32), np.array([1, 28, 2])]
    for alphabet in (DEFAULT_LABELS, ["_", "A", "B"]):
        seqs_a = [s % len(alphabet) for s in seqs]
        assert GreedyDecoder(alphabet).convert_to_strings(seqs_a) == \
            JaxGreedyDecoder(alphabet).convert_to_strings(seqs_a)


def test_manifest_tools_match_dsjax(tmp_path):
    from dsjax.data import manifest as jax_manifest
    from dsjax_torch.data import manifest

    data = tmp_path / "data"
    write_manifest(str(data), "a", [0.6, 0.3, 0.9], seed=7)
    made = [mod.create_manifest(str(data), f"{name}.json", str(tmp_path / name),
                                min_duration=0.4, max_duration=1.0)
            for mod, name in ((manifest, "port"), (jax_manifest, "ref"))]
    assert json.load(open(made[0])) == json.load(open(made[1]))
    assert len(json.load(open(made[0]))["samples"]) == 2
    assert manifest.parse_input(made[0]) == jax_manifest.parse_input(made[1])
    assert manifest.parse_input(str(data)) == jax_manifest.parse_input(str(data))
    os.unlink(data / "txt" / "a_0.txt")
    assert manifest.verify_manifest(made[0]) == jax_manifest.verify_manifest(made[1]) != []
    merged = [mod.merge_manifests([made[0]], "m", str(tmp_path / name))
              for mod, name in ((manifest, "port_m"), (jax_manifest, "ref_m"))]
    got, want = (json.load(open(m)) for m in merged)
    assert got["samples"] == want["samples"]


def test_metrics_logger_records_match_dsjax(tmp_path, monkeypatch):
    assert port_logging._scalar_event(7, "loss", 1.5, 123.25) == \
        jax_logging._scalar_event(7, "loss", 1.5, 123.25)
    assert port_logging._masked_crc(b"abc") == jax_logging._masked_crc(b"abc")
    monkeypatch.setattr(port_logging.time, "time", lambda: 1000.0)
    monkeypatch.setattr(jax_logging.time, "time", lambda: 1000.0)
    paths = []
    for mod, sub in ((port_logging, "port"), (jax_logging, "ref")):
        logger = mod.MetricsLogger(str(tmp_path / sub))
        logger.log(3, loss=2.5, wer=40.0)
        logger.log(4, cer=12.0)
        logger.close()
        paths.append(tmp_path / sub)
    for name in ("metrics.jsonl",):
        assert (paths[0] / name).read_bytes() == (paths[1] / name).read_bytes()
    events = [sorted(p.glob("events.out.tfevents.*")) for p in paths]
    assert events[0][0].read_bytes() == events[1][0].read_bytes()
    timer = port_logging.StepTimer(window=2)
    timer.start()
    for _ in range(3):
        timer.tick(4)
    assert len(timer.times) == 2 and timer.utterances_per_sec > 0


def test_checkpoint_handler_keeps_best_k_and_last(tmp_path):
    from dsjax_torch.inference import load_model
    from dsjax_torch.train.checkpoint import CheckpointHandler, restore_from_path
    from dsjax_torch.train.loop import Trainer

    cfg = config.compose(config.TrainConfig, ["model.hidden_size=16", "model.hidden_layers=1",
                                              "trainer.device=cpu", "trainer.precision=32",
                                              "data.device_features=false"])
    trainer = Trainer(cfg, list(DEFAULT_LABELS))
    state = trainer.init_state()
    handler = CheckpointHandler(str(tmp_path), save_top_k=2, cfg=cfg, labels=list(DEFAULT_LABELS))
    for step, wer in ((1, 50.0), (2, 30.0), (3, 40.0), (4, 60.0)):
        state.step = step
        handler.save(state, {"wer": wer}, extra={"start_index": step})
    handler.save(dataclasses.replace(state, step=5), {"loss": 1.0}, extra={"start_index": 9},
                 last_only=True)
    assert sorted(os.listdir(tmp_path / "best")) == ["index.json", "step_2.pt", "step_3.pt"]
    assert os.listdir(tmp_path / "last") == ["step_5.pt"]
    assert handler.best_step() == 2 and handler.latest_step() == 5
    assert handler.restore_extra() == {"start_index": 9}
    assert json.load(open(tmp_path / "meta.json"))["labels"] == list(DEFAULT_LABELS)

    fresh = trainer.init_state(seed=1)
    restored, extra = restore_from_path(str(tmp_path), fresh)
    assert (restored.step, extra) == (5, {"start_index": 9})
    for (k, a), b in zip(state.model.state_dict().items(), restored.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    bundle = load_model(handler.path(best=True), device="cpu")
    assert bundle.model.model_cfg.hidden_size == 16

    other = config.compose(config.TrainConfig, ["model.hidden_size=24", "model.hidden_layers=1",
                                                "trainer.device=cpu",
                                                "data.device_features=false"])
    with pytest.raises(ValueError, match="does not match"):
        restore_from_path(str(tmp_path), Trainer(other, list(DEFAULT_LABELS)).init_state())


@pytest.mark.parametrize("override, exc", [
    ("trainer.devices=2", NotImplementedError),
    ("trainer.mesh_data=2", ValueError),
    ("trainer.platform=cpu", ValueError),
    ("trainer.matmul_precision=float32", ValueError),
    ("trainer.donate_state=false", ValueError),
    ("trainer.deterministic=true", ValueError),
])
def test_unported_settings_raise(override, exc):
    from dsjax_torch.train.loop import Trainer

    base = ["trainer.device=cpu", "data.device_features=false", "model.hidden_size=16",
            "model.hidden_layers=1"]
    cfg = config.compose(config.TrainConfig, base + [override])
    with pytest.raises(exc):
        Trainer(cfg, list(DEFAULT_LABELS)).init_state()


@pytest.mark.parametrize("overrides", [
    ["data.augmentation.spec_augment=true"],
    ["data.augmentation.speed_volume_perturb=true"],
    ["data.augmentation.noise_dir={noise}", "data.augmentation.noise_prob=1.0"],
    ["trainer.profile=true"],
    ["data.device_features=true", "data.augmentation.spec_augment=true",
     "data.augmentation.spec_augment_device=true"],
], ids=["spec_augment", "speed_volume_perturb", "noise_dir", "profile", "spec_augment_device"])
def test_ported_settings_build(tmp_path, overrides):
    """The settings the port once refused build a Trainer on the CPU and
    take a training step (trainer.profile writes its trace, the rest none)."""
    from dsjax_torch import workflows
    from dsjax_torch.audio.io import save_wav
    from dsjax_torch.train.loop import Trainer

    noise = tmp_path / "noise"
    noise.mkdir()
    save_wav(str(noise / "n.wav"), np.random.default_rng(0).standard_normal(4000) * 0.2, 16000)
    train = write_manifest(str(tmp_path), "train", [0.6, 0.5], seed=2)
    profiles = tmp_path / "profiles"
    base = [f"data.train_path={train}", f"data.val_path={train}", "data.batch_size=2",
            "data.num_workers=1", "trainer.device=cpu", "data.device_features=false",
            "model.hidden_size=16", "model.hidden_layers=1", "trainer.precision=32",
            "trainer.max_epochs=1", "trainer.profile_start_step=0",
            "trainer.profile_num_steps=0", f"trainer.profile_dir={profiles}"]
    cfg = config.compose(config.TrainConfig,
                         base + [o.format(noise=noise) for o in overrides])
    trainer = Trainer(cfg, list(DEFAULT_LABELS))
    state = trainer.fit(*workflows._pipelines(cfg, list(DEFAULT_LABELS)), log_fn=lambda _: None)
    assert state.step == 1
    traces = os.listdir(profiles) if profiles.exists() else []
    assert len(traces) == (overrides == ["trainer.profile=true"])


def test_cuda_trainer_without_a_card_raises(monkeypatch):
    from dsjax_torch.train.loop import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config.compose(config.TrainConfig, ["data.device_features=false"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, list(DEFAULT_LABELS))
