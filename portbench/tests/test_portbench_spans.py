"""The span readers (``portbench/spans.py`` and the metrics that read the
program's spans), driven on the CPU at a small size through each cell's
own driver and ``run.per_layer``, with the profiled span after the window
taken by a CPU profiler in place of ``harness.trace_span``'s card trace:

  * each reader gives the recorded spans' ms per batch or step, read back
    from ``dsjax_torch.trace.summary()``;
  * each gives None where the spans' calls disagree with the span's
    batches or steps, and where the program records no spans (a port
    without ``dsjax_torch.trace``).
"""

import json
import sys
import time

import pytest
from torch.profiler import ProfilerActivity, profile

from portbench import harness, run
from portbench.tests.small import cells, driver, small_cell

UNEXPLAINED_S = 0.006       # the CPU stand-in's idle under no host event

READS = {
    "eval.decode_wait_ms": ("batches", ("beam.fetch",)),
    "eval.decode_host_ms": ("batches", ("beam.strings",)),
    "eval.score_ms": ("batches", ("eval.score",)),
    "eval.prefetch_wait_ms": ("batches", ("data.wait",)),
    "train.host_ms": ("steps", ("train.put_batch", "train.step")),
    "ddp.host_ms": ("steps", ("train.put_batch", "train.step")),
}
PREFIX = {"train": "train.", "ddp_train": "ddp.", "eval": "eval."}
NEW = (*READS, "eval.untraced_idle_ms")


def cpu_trace_span(fn, device):
    """``harness.trace_span``'s reduction where the card trace cannot be
    had: the host's seconds under a CPU profiler, no device time, and one
    fixed idle gap under no host event."""
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.perf_counter()
        fn()
        seconds = time.perf_counter() - t0
    return {"seconds": seconds, "busy_s": 0.0, "ops": {},
            "gaps": {"no host event": UNEXPLAINED_S}}


@pytest.fixture(scope="module", params=cells())
def traced(request):
    """(workload, the driver's Outcome, the span aggregates) of a small
    traced run of each cell."""
    from dsjax_torch import trace

    mp = pytest.MonkeyPatch()
    mp.setattr(harness, "trace_span", cpu_trace_span)
    trace.reset()
    try:
        cell = small_cell(request.param)
        cell.trace = True
        outcome = driver(cell).run(cell)
        yield request.param, outcome, trace.summary()
    finally:
        mp.undo()
        trace.reset()


def bench():
    return json.loads((run.ROOT / "BENCHMARK.json").read_text())


def readings(workload, layer):
    """Every per-layer metric of the cell that ``run.per_layer`` reports."""
    b = bench()
    moves = {m["moves"] for m in b["per_layer"]}
    return run.per_layer(b, workload, dict.fromkeys(moves), layer, run.ROOT)


def mine(workload):
    return [m["name"] for m in bench()["per_layer"]
            if m["name"] in NEW and workload in m["workloads"]]


def test_new_metrics_are_listed_for_the_cells_that_run_their_spans():
    listed = {m["name"]: m["workloads"] for m in bench()["per_layer"] if m["name"] in NEW}
    assert set(listed) == set(NEW)
    for name, workloads in listed.items():
        for w in workloads:
            kind = small_cell(w).traffic["driver"]
            assert name.startswith(PREFIX[kind]), (name, w)


def test_readers_give_the_spans_ms_per_unit(traced):
    workload, outcome, summary = traced
    got = readings(workload, outcome.layer)
    assert mine(workload)
    span = outcome.layer["span"]
    for name in mine(workload):
        if name == "eval.untraced_idle_ms":
            want = 1e3 * UNEXPLAINED_S / span["batches"]
        else:
            unit, spans = READS[name]
            want = 1e3 * sum(summary[s]["total_s"] for s in spans) / span[unit]
        assert got[name]["value"] == pytest.approx(want, rel=1e-12), name
        assert got[name]["value"] > 0 and got[name]["unit"] == "ms", name


def test_readers_refuse_a_call_count_that_disagrees(traced):
    workload, outcome, _ = traced
    layer = dict(outcome.layer)
    unit = "batches" if "batches" in layer["span"] else "steps"
    # two more than ran: data.wait's n + 1 calls (the end-of-stream marker's
    # wait among them) fall short too
    layer["span"] = dict(layer["span"], **{unit: layer["span"][unit] + 2})
    got = readings(workload, layer)
    for name in mine(workload):
        assert name not in got, name


def test_readers_read_nothing_from_a_port_without_spans(traced, monkeypatch):
    import dsjax_torch

    workload, outcome, _ = traced
    # as in a checkout whose port has no dsjax_torch.trace: its import raises
    monkeypatch.delattr(dsjax_torch, "trace")
    monkeypatch.setitem(sys.modules, "dsjax_torch.trace", None)
    got = readings(workload, outcome.layer)
    for name in mine(workload):
        assert name not in got, name
    assert got    # the accepted metrics still read
