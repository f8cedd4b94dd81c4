"""Each device operation of a profiled span given to the port's span that
launched it (``dsjax_torch.trace``), forward and backward.

The profiler's Chrome trace ties a kernel, memcpy or memset to the host's
runtime call that issued it by ``args.correlation``. A call made inside a
port span (a ``user_annotation`` of that name on the same thread, the
innermost of the spans asked for) belongs to that span: the forward. A call
made inside an ``autograd::engine::evaluate_function: <Node>`` event belongs
to the forward operation that made the node: the event's ``Sequence
number`` is the one the forward operation (a ``cpu_op`` outside any
``evaluate_function``) carries, and that operation's innermost port span is
the call's. Everything else (the optimizer, the loss, the gradient
accumulation nodes, which carry no sequence number) is given to no span.

``trace_span`` is ``harness.trace_span`` keeping the trace's events, which
that function reads and deletes.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple
from unittest import mock

from portbench import harness, spans

DEVICE_CATS = harness.DEVICE_CATS
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
BACKWARD = "autograd::engine::evaluate_function"


def trace_span(fn, device) -> Tuple[Dict, List[Dict]]:
    """(``harness.trace_span(fn, device)``, the trace's events)."""
    loaded: List[Dict] = []

    class _Recording:
        """``harness``'s json module, keeping what it loads."""

        def __getattr__(self, name):
            return getattr(json, name)

        @staticmethod
        def load(f, **kwargs):
            out = json.load(f, **kwargs)
            loaded.append(out)
            return out

    with mock.patch.object(harness, "json", _Recording()):
        span = harness.trace_span(fn, device)
    return span, (loaded[0].get("traceEvents", []) if loaded else [])


def _enclosing(events: Iterable[Dict], names: Sequence[str]):
    """Walk each thread's host events in order of start, yielding (event,
    the innermost open event named in ``names`` or None, the innermost open
    backward event or None)."""
    by_thread: Dict[Tuple, List[Dict]] = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in HOST_CATS:
            by_thread[(e.get("pid"), e.get("tid"))].append(e)
    wanted = set(names)
    for thread in by_thread.values():
        thread.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
        stack: List[Tuple[float, Dict]] = []
        for e in thread:
            ts = float(e["ts"])
            while stack and stack[-1][0] <= ts:
                stack.pop()
            span = next((o for _, o in reversed(stack) if o["name"] in wanted), None)
            back = next((o for _, o in reversed(stack) if o["name"].startswith(BACKWARD)),
                        None)
            yield e, span, back
            stack.append((ts + float(e.get("dur", 0.0)), e))


def attribute(events: List[Dict], names: Sequence[str]) -> Dict[Optional[str], float]:
    """Device seconds by the span (one of ``names``) that launched each
    operation; None holds those of no span."""
    walked = list(_enclosing(events, names))
    by_sequence: Dict[int, Optional[str]] = {}
    for e, span, back in walked:
        seq = e.get("args", {}).get("Sequence number")
        if (e.get("cat") == "cpu_op" and seq is not None and back is None
                and not e["name"].startswith(BACKWARD)):
            by_sequence.setdefault(int(seq), span["name"] if span else None)
    by_correlation: Dict[int, Optional[str]] = {}
    for e, span, back in walked:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") not in ("cuda_runtime", "cuda_driver") or corr is None:
            continue
        if span is not None:
            by_correlation[int(corr)] = span["name"]
        elif back is not None:
            seq = back.get("args", {}).get("Sequence number")
            by_correlation[int(corr)] = by_sequence.get(int(seq)) if seq is not None else None
    out: Dict[Optional[str], float] = defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        corr = e.get("args", {}).get("correlation")
        name = by_correlation.get(int(corr)) if corr is not None else None
        out[name] += float(e.get("dur", 0.0)) * 1e-6
    return dict(out)


def span_ms(layer: Dict, name: str) -> Optional[float]:
    """Device ms a step of the operations given to span ``name``, read from
    ``layer["attribution"]`` (``seconds`` by span, ``per_step`` the span's
    calls a step); None unless the span ran as often as the profiled span's
    steps say (``spans.ran_once_each``)."""
    att, n = layer.get("attribution"), spans.units(layer, "steps")
    if not att or n is None or name not in att["per_step"]:
        return None
    if not spans.ran_once_each([name], n * att["per_step"][name], spans.recorded()):
        return None
    return 1e3 * att["seconds"].get(name, 0.0) / n
