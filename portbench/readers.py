"""What the per-layer readers (``metrics/<metric>.py``) share. Each reads
the dict a driver gathered (``harness.Outcome.layer``):

  window    the measured window: ``seconds``, ``flops`` (the model's
            FLOPs of the work it completed), ``dtype``, and per driver
            ``steps`` or ``batches`` and ``decode_s``;
  span      with ``--trace 1``, the profiled span after the window
            (``harness.trace_span``) and its ``steps`` or ``batches``;
  calls     each scan or beam kernel's calls in the span, as the
            arguments of ``counts.bound``;
  counters  the program's launch counters over the span.

A reader returns None when it finds nothing to read, and the metric is
left out of the line.
"""

from __future__ import annotations

from typing import Dict, Optional

from portbench import counts, harness


def mfu(layer: Dict) -> Optional[float]:
    """The window's model FLOPs over its seconds at the peak of its type, %."""
    w = layer["window"]
    return 100.0 * w["flops"] / (w["seconds"] * counts.PEAK_FLOPS[w["dtype"]])


def idle_share(layer: Dict) -> Optional[float]:
    """The profiled span's time with nothing running on the card, %."""
    span = layer.get("span")
    if not span or span["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - span["busy_s"] / span["seconds"])


def group_seconds(layer: Dict, groups) -> float:
    span = layer["span"]
    return sum(v[1] for name, v in span["ops"].items() if harness.kernel_group(name) in groups)


def roofline(layer: Dict, kernel: str) -> Optional[float]:
    """The kernel's least time over the span's calls (``counts.bound``)
    over its device time in the trace, %. None when the span has no call
    of it, when the program's counter disagrees with the calls the driver
    expected, or when the trace shows none of its time."""
    span, calls = layer.get("span"), layer.get("calls", {}).get(kernel)
    if not span or not calls or layer["counters"].get(kernel) != len(calls):
        return None
    seconds = group_seconds(layer, (kernel,))
    if seconds <= 0:
        return None
    return 100.0 * sum(counts.bound(kernel, *call)[0] for call in calls) / seconds
