"""What the span readers (``metrics/eval.decode_wait_ms.py`` and the
others that read the program's spans) share: the aggregates of the port's
spans (``dsjax_torch.trace.summary()``), read in the process that ran the
cell, after the driver returned. Only the profiled span after the window
runs under a profiler, so the aggregates hold that span's calls alone.

A reader returns None where the program has no spans (a port without
``dsjax_torch.trace``), where a span has no calls, or where its calls
disagree with the span's ``batches`` or ``steps`` (the launch counters'
check in ``readers.roofline``, for the spans' call counts).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence


def recorded() -> Optional[Dict[str, Dict]]:
    """The program's span aggregates, or None when it records none."""
    try:
        from dsjax_torch import trace
    except ImportError:
        return None
    return trace.summary()


def units(layer: Dict, unit: str) -> Optional[int]:
    """The profiled span's count of ``unit`` ("batches" or "steps")."""
    span = layer.get("span")
    if not span or not span.get(unit):
        return None
    return int(span[unit])


def ran_once_each(names: Sequence[str], n: int, summary: Optional[Dict],
                  at_least: bool = False) -> bool:
    """Whether each named span ran n times (at least n with ``at_least``)."""
    if not summary:
        return False
    for name in names:
        calls = summary.get(name, {}).get("calls", 0)
        if calls == 0 or (calls < n if at_least else calls != n):
            return False
    return True


def ms_per(layer: Dict, names: Sequence[str], unit: str,
           at_least: bool = False) -> Optional[float]:
    """The named spans' total host ms per ``unit`` of the profiled span."""
    n, summary = units(layer, unit), recorded()
    if n is None or not ran_once_each(names, n, summary, at_least):
        return None
    return 1e3 * sum(summary[name]["total_s"] for name in names) / n
