"""Spans at the port's layer boundaries, on the profiler's clock.

``with span("beam.fetch"): ...`` marks one call of a layer. A span is on
only while a torch profiler records in this process (``trainer.profile``'s
``train.logging.profile_steps``, or any ``torch.profiler.profile``); off,
it costs one check of the profiler's enabled flag. On, it enters
``torch.profiler.record_function(name)``, so the span lands in the same
Chrome trace as the kernels it launched, and it adds to an in-memory
aggregate per name: calls, total seconds, self seconds (total less the
time its child spans on the same thread cover) and the calls by parent
span. Parents are kept per thread, so a span entered on a
``DevicePrefetcher`` thread has that thread's parent, not the consumer's.
``summary()`` reads the aggregates, ``reset()`` clears them; they grow
with the number of names, not of calls.

Names read ``<layer>.<what>``: ``data.stage``, ``data.wait``,
``train.put_batch``, ``train.step``, ``train.forward``, ``train.loss``,
``train.backward``, ``train.update``, ``infer.forward``, ``beam.decode``
(``beam.search``, ``beam.fetch``, ``beam.strings``), ``greedy.strings``,
``eval.score``, ``ddp.agree``, ``ddp.reduce``, and the Conformer's
modules (``model/conformer.py``), one span a module call:
``conformer.subsample``, ``conformer.ffn`` (either half-step FFN),
``conformer.attention`` (the positional projection, the scores, the
rel-shift, the softmax, the product with v and the output projection) and
``conformer.conv``; ``Trainer.fit`` adds
``train_step <n>`` around each step of its profile window. A span marks a
call at a layer boundary, never an iteration of a loop over time steps,
launches or utterances.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler


class Recorder:
    """Per-name aggregates of the spans that ran while a profiler recorded;
    safe to update from several threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: Dict[str, list] = {}    # name -> [calls, total_s, self_s, {parent: calls}]
        self._local = threading.local()

    def stack(self) -> List["_Span"]:
        """This thread's open spans, innermost last."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def add(self, name: str, parent: Optional[str], total_s: float, self_s: float) -> None:
        with self._lock:
            row = self._rows.get(name)
            if row is None:
                row = self._rows[name] = [0, 0.0, 0.0, {}]
            row[0] += 1
            row[1] += total_s
            row[2] += self_s
            row[3][parent] = row[3].get(parent, 0) + 1

    def summary(self) -> Dict[str, Dict]:
        """{name: {"calls", "total_s", "self_s", "parents": {parent name or
        None: calls}}}."""
        with self._lock:
            return {name: {"calls": calls, "total_s": total, "self_s": own,
                           "parents": dict(parents)}
                    for name, (calls, total, own, parents) in self._rows.items()}

    def reset(self) -> None:
        with self._lock:
            self._rows.clear()


RECORDER = Recorder()


class _Span:
    __slots__ = ("name", "_annotation", "_stack", "_t0", "_children_s")

    def __init__(self, name: str):
        self.name = name
        self._children_s = 0.0

    def __enter__(self) -> "_Span":
        self._annotation = torch.profiler.record_function(self.name)
        self._annotation.__enter__()
        self._stack = RECORDER.stack()
        self._stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        total = time.perf_counter() - self._t0
        stack = self._stack
        stack.pop()
        parent = stack[-1] if stack else None
        if parent is not None:
            parent._children_s += total
        RECORDER.add(self.name, parent.name if parent is not None else None, total,
                     total - self._children_s)
        self._annotation.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager marking one call of a layer: a profiler annotation
    and an entry in ``RECORDER`` while a torch profiler records, else
    nothing."""
    if _profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def summary() -> Dict[str, Dict]:
    """The recorded spans' aggregates by name (``Recorder.summary``)."""
    return RECORDER.summary()


def reset() -> None:
    RECORDER.reset()
