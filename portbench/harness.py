"""What every driver shares: the cell it runs, what it hands back, the
program's launch counters, and the reduction of a profiler trace.

A driver (``drivers/<kind>.py``) exposes ``run(cell) -> Outcome``. It
builds the program's object from the cell's files and the seed, warms up
every shape the window uses, measures for ``cell.seconds``, and after the
window (and, with ``cell.trace``, a traced span of the same work) frees the
program's state and holds its outputs against the reference.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import kernels

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")
MIN_GAP_US = 20.0          # shorter idle gaps are summed under one name


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict               # configs/<config>.json
    traffic: Dict              # traffic/<cell>.json
    seed: int
    seconds: float
    trace: bool
    chips: int
    device: torch.device
    started: float            # time.perf_counter() at the process's start


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: Dict[str, float]         # the cell's end-to-end metrics but setup_s
    setup_s: float
    memory_peak_bytes: int
    numbers: Dict[str, float]            # what the comparison read
    layer: Dict                          # what the per-layer readers read
    breakdown: Optional[Dict] = None
    notes: Dict = dataclasses.field(default_factory=dict)   # printed to standard error


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_memory(device: torch.device) -> int:
    """The allocator's peak on the card since the process started (0 off
    a card)."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def counters() -> Dict[str, int]:
    """The program's kernel launch counters (one per call of a C entry
    point), each kernel's as its file names it (``kernels/<K>.py``)."""
    return kernels.counters()


def delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after}


def kernel_group(name: str) -> str:
    """A kernel's group: the kernel whose file matches its name
    (``kernels.kernel_of``), else ``tools/torch_profile_train.py``'s
    groups."""
    kernel = kernels.kernel_of(name)
    if kernel is not None:
        return kernel
    low = name.lower()
    if "nccl" in low:
        return "nccl"
    if "ctc" in low:
        return "ctc"
    if "multi_tensor_apply" in low or "adam" in low:
        return "optimizer"
    if "conv" in low or "fprop" in low or "dgrad" in low or "wgrad" in low:
        return "convolution"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet", "splitk")):
        return "matrix product"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def trace_span(fn: Callable[[], None], device: torch.device) -> Dict:
    """Run ``fn`` under ``torch.profiler`` and reduce its trace: the span's
    host-clock seconds, the device's busy seconds (the union of its kernel
    and copy intervals inside the span), each device operation's count and
    seconds, each kernel group's exposed seconds (``_exposed``), and the
    idle gaps by the innermost host event open at each gap's middle. The
    trace file is written to the temporary directory and deleted."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("portbench.span"):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(device)
            seconds = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == "portbench.span"]
    lo = float(spans[0]["ts"]) if spans else -float("inf")
    hi = lo + float(spans[0]["dur"]) if spans else float("inf")
    ops: Dict[str, List[float]] = {}
    intervals = []
    grouped = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        if s + d < lo or s > hi:
            continue
        row = ops.setdefault(e["name"], [0, 0.0])
        row[0] += 1
        row[1] += d * 1e-6
        intervals.append((max(s, lo), min(s + d, hi)))
        grouped.append((intervals[-1], kernel_group(e["name"])))
    busy = _union(intervals)
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
            and e.get("name") != "portbench.span"]
    h_start = np.array([float(e["ts"]) for e in host])
    h_end = h_start + np.array([float(e.get("dur", 0.0)) for e in host])
    gaps: Dict[str, float] = {}
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0 or not np.isfinite(g1 - g0):
            continue
        if g1 - g0 < MIN_GAP_US:
            name = f"gaps under {MIN_GAP_US:g} us"
        else:
            mid = 0.5 * (g0 + g1)
            open_ = np.nonzero((h_start <= mid) & (h_end >= mid))[0]
            name = (host[open_[np.argmin(h_end[open_] - h_start[open_])]]["name"]
                    if len(open_) else "no host event")
        gaps[name] = gaps.get(name, 0.0) + (g1 - g0) * 1e-6
    return {"seconds": seconds, "busy_s": sum(e - s for s, e in busy) * 1e-6,
            "ops": ops, "gaps": gaps, "exposed": _exposed(grouped)}


def _exposed(grouped: List[Tuple[Tuple[float, float], str]]) -> Dict[str, float]:
    """Each kernel group's seconds with its operations, and no other
    group's, running on the device (a sweep over the intervals' edges)."""
    edges = sorted((t, step, g) for (s, e), g in grouped for t, step in ((s, 1), (e, -1)))
    active: Dict[str, int] = {}
    out: Dict[str, float] = {}
    prev = None
    for t, step, g in edges:
        if prev is not None and len(active) == 1:
            (only,) = active
            out[only] = out.get(only, 0.0) + (t - prev) * 1e-6
        active[g] = active.get(g, 0) + step
        if not active[g]:
            del active[g]
        prev = t
    return out


def breakdown(span: Dict) -> Dict:
    """The ten device operations that took most time and the ten host
    events under which the device idled longest, [name, seconds] each."""
    ops = sorted(((n[:200], v[1]) for n, v in span["ops"].items()), key=lambda r: -r[1])
    gaps = sorted(((n[:200], s) for n, s in span["gaps"].items()), key=lambda r: -r[1])
    return {"device_ops": [list(r) for r in ops[:10]], "idle_gaps": [list(r) for r in gaps[:10]]}
