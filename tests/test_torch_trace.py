"""The port's spans (``dsjax_torch.trace``) on the CPU.

  * Off (no profiler recording): ``span`` enters no ``record_function``
    and records nothing.
  * On: the span lands in the profiler's Chrome trace as a
    ``user_annotation`` event inside its parent, and the recorder keeps
    calls, total and self seconds and the parent by name; the recorder's
    counts survive many threads.
  * The spans of the paths the benchmark's cells run: the device beam
    decoder's parts, a ``DevicePrefetcher`` thread's parent, ``fit``'s
    phases inside ``train_step <n>``, and at most 12 spans a training step
    or an evaluation batch.
"""

import contextlib
import io
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dsjax_torch import config, trace
from dsjax_torch.labels import DEFAULT_LABELS
from tests.synthetic_manifest import write_manifest

CPU = [ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def fresh_recorder():
    trace.reset()
    yield
    trace.reset()


def annotations(prof, tmp_path):
    """The ``user_annotation`` events of a finished profile, by name."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            out.setdefault(e["name"], []).append(e)
    return out


def inside(child, parent) -> bool:
    return (child["tid"] == parent["tid"] and child["ts"] >= parent["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


def test_off_enters_no_annotation_and_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with trace.span("a.outer"):
        with trace.span("a.inner"):
            pass
    assert trace.summary() == {}


def test_on_nests_in_the_trace_and_keeps_self_time(tmp_path):
    with profile(activities=CPU) as prof:
        with trace.span("a.outer"):
            with trace.span("a.inner"):
                torch.ones(64).sum()
            with trace.span("a.inner"):
                pass
    got = trace.summary()
    assert set(got) == {"a.outer", "a.inner"}
    outer, inner = got["a.outer"], got["a.inner"]
    assert (outer["calls"], inner["calls"]) == (1, 2)
    assert outer["parents"] == {None: 1} and inner["parents"] == {"a.outer": 2}
    assert inner["self_s"] == inner["total_s"]
    assert outer["self_s"] == pytest.approx(outer["total_s"] - inner["total_s"], abs=1e-9)
    assert 0 <= outer["self_s"] <= outer["total_s"]
    events = annotations(prof, tmp_path)
    assert len(events["a.inner"]) == 2
    assert all(inside(e, events["a.outer"][0]) for e in events["a.inner"])
    trace.reset()
    assert trace.summary() == {}


def test_recorder_counts_every_call_from_many_threads():
    """More threads than cores, switching as often as the interpreter
    allows: a lost update would leave fewer calls or seconds."""
    recorder = trace.Recorder()
    n_threads, n_calls = 4 * (os.cpu_count() or 1) + 2, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [recorder.add("x.y", "x", 1.0, 0.5) for _ in range(n_calls)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    row = recorder.summary()["x.y"]
    total = n_threads * n_calls
    assert (row["calls"], row["total_s"], row["self_s"]) == (total, total, total / 2)
    assert row["parents"] == {"x": total}


def test_beam_decode_exports_its_parts(tmp_path):
    from dsjax_torch.decode.beam_device import DeviceBeamDecoder

    rng = np.random.default_rng(0)
    probs = torch.softmax(torch.from_numpy(rng.standard_normal((3, 20, 29)).astype(np.float32)),
                          dim=-1)
    sizes = torch.tensor([20, 14, 7], dtype=torch.int32)
    decoder = DeviceBeamDecoder(DEFAULT_LABELS, beam_width=4)
    want = decoder.decode(probs, sizes, n_best=1)
    with profile(activities=CPU) as prof:
        got = decoder.decode(probs, sizes, n_best=1)
    assert got[0] == want[0]
    events = annotations(prof, tmp_path)
    (outer,) = events["beam.decode"]
    for name in ("beam.search", "beam.fetch", "beam.strings"):
        (e,) = events[name]
        assert inside(e, outer), name
    summary = trace.summary()
    for name in ("beam.decode", "beam.search", "beam.fetch", "beam.strings"):
        row = summary[name]
        assert row["calls"] == 1 and 0 <= row["self_s"] <= row["total_s"], name
    assert summary["beam.fetch"]["parents"] == {"beam.decode": 1}
    assert summary["beam.decode"]["parents"] == {None: 1}


def test_prefetcher_thread_spans_keep_that_threads_parent():
    """``data.stage`` runs on the prefetcher's thread, under the span its
    put_fn opened there; ``data.wait`` runs on the consumer's, under the
    consumer's span."""
    from dsjax_torch.data.loader import DevicePrefetcher, stage

    def put(item):
        with trace.span("test.put"):
            return stage((np.full((2, 3), item, np.int16),), torch.device("cpu"))

    seen = []
    with profile(activities=CPU):
        with trace.span("test.consumer"):
            prefetcher = DevicePrefetcher(range(4), put)
            for item, staged in prefetcher:
                seen.append((item, int(staged.tensors[0][0, 0])))
            prefetcher._thread.join(timeout=60)
    assert not prefetcher._thread.is_alive()
    assert seen == [(i, i) for i in range(4)]
    summary = trace.summary()
    assert summary["data.stage"]["parents"] == {"test.put": 4}
    assert summary["test.put"]["parents"] == {None: 4}
    # four items and the end-of-stream marker
    assert summary["data.wait"]["parents"] == {"test.consumer": 5}


def train_cfg(tmp_path, *extra):
    train = write_manifest(str(tmp_path), "train", [0.6, 0.5, 0.7, 0.4, 0.5, 0.6], seed=6)
    return config.compose(config.TrainConfig, [
        f"data.train_path={train}", f"data.val_path={train}", "data.batch_size=2",
        "data.num_workers=1", "model.hidden_size=16", "model.hidden_layers=1",
        "trainer.precision=32", "trainer.device=cpu", "trainer.max_epochs=1", *extra])


def test_fit_profile_holds_the_phases_of_each_step(tmp_path):
    from dsjax_torch import workflows
    from dsjax_torch.train.loop import Trainer

    profiles = tmp_path / "profiles"
    cfg = train_cfg(tmp_path, "trainer.profile=true", "trainer.profile_start_step=1",
                    "trainer.profile_num_steps=1", f"trainer.profile_dir={profiles}")
    trainer = Trainer(cfg, list(DEFAULT_LABELS))
    trainer.fit(*workflows._pipelines(cfg, list(DEFAULT_LABELS)), log_fn=lambda _: None)
    (name,) = os.listdir(profiles)
    events = {}
    for e in json.loads((profiles / name).read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            events.setdefault(e["name"], []).append(e)
    (step1,) = events["train_step 1"]
    (step,) = [e for e in events["train.step"] if inside(e, step1)]
    for phase in ("train.forward", "train.loss", "train.backward", "train.update"):
        assert [e for e in events[phase] if inside(e, step)], phase


def test_a_training_step_enters_at_most_12_spans(tmp_path):
    from dsjax_torch.data.dataset import collate
    from dsjax_torch.train.loop import Trainer

    trainer = Trainer(train_cfg(tmp_path), list(DEFAULT_LABELS))
    state = trainer.init_state()
    rng = np.random.default_rng(1)
    batch = collate([(rng.standard_normal((161, 40)).astype(np.float32), [1, 2, 3])
                     for _ in range(2)], 16, 16)
    with profile(activities=CPU):
        trainer.train_step(state, batch, staged=trainer.put_batch(batch))
    summary = trace.summary()
    assert set(summary) == {"train.put_batch", "data.stage", "train.step", "train.forward",
                            "train.loss", "train.backward", "train.update"}
    assert all(row["calls"] == 1 for row in summary.values())
    assert summary["train.forward"]["parents"] == {"train.step": 1}
    assert summary["data.stage"]["parents"] == {"train.put_batch": 1}


def test_an_evaluation_batch_enters_at_most_12_spans(tmp_path):
    from dsjax_torch.config import BiDirectionalConfig, SpectConfig
    from dsjax_torch.model.convert import save_checkpoint
    from dsjax_torch.model.ds2 import DeepSpeech2
    from dsjax_torch.workflows import evaluate

    arch = BiDirectionalConfig(hidden_size=32, hidden_layers=1)
    model = DeepSpeech2(len(DEFAULT_LABELS), SpectConfig(), arch,
                        generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "model.pt")
    save_checkpoint(path, model.state_dict(), arch, SpectConfig(), DEFAULT_LABELS)
    manifest = write_manifest(str(tmp_path), "test", [0.7, 1.1, 0.5, 0.9, 0.6], seed=3)
    cfg = config.compose(config.EvalConfig, [
        f"model.model_path={path}", f"test_path={manifest}", "batch_size=2", "num_workers=1",
        "lm.decoder_type=beam", "lm.beam_width=4", "device=cpu"])
    with profile(activities=CPU), contextlib.redirect_stdout(io.StringIO()):
        evaluate(cfg)
    summary = trace.summary()
    batches = 3
    per_batch = ("data.stage", "infer.forward", "beam.decode", "beam.search", "beam.fetch",
                 "beam.strings", "greedy.strings", "eval.score")
    assert {k: summary[k]["calls"] for k in per_batch} == dict.fromkeys(per_batch, batches)
    assert summary["data.wait"]["calls"] == batches + 1
    assert set(summary) == set(per_batch) | {"data.wait"}
    assert sum(row["calls"] for row in summary.values()) <= 12 * batches
