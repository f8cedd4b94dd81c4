"""WER / CER metrics with sum states: a copy of dsjax/train/metrics.py.

Reference semantics (deepspeech_pytorch/validation.py:13-132): WER is the
word-level Levenshtein distance over reference token count; CER is the
char-level distance (spaces stripped) over reference char count; both are
accumulated as integer sum-states (torchmetrics dist_reduce_fx="sum"
equivalent), so they add up exactly over batches.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence, Tuple

from dsjax_torch.trace import span


def _py_distance(a: str, b: str) -> int:
    """Pure-python fallback (O(nm) DP, two-row)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


@functools.lru_cache(maxsize=None)
def _distance_fn() -> Callable[[str, str], int]:
    """The fastest edit distance available: python-Levenshtein, else the
    port's native one (``dsjax_torch.audio.native.levenshtein``, a copy of
    dsjax's ds_levenshtein), else the pure-python DP. All three give the
    same integers."""
    try:
        import Levenshtein

        return Levenshtein.distance
    except ImportError:
        pass
    try:
        from dsjax_torch.audio.native import levenshtein

        levenshtein([1], [2])
        return lambda a, b: levenshtein([ord(c) for c in a], [ord(c) for c in b])
    except (OSError, RuntimeError):  # the host library fails to build or load
        return _py_distance


def _distance(a: str, b: str) -> int:
    return _distance_fn()(a, b)


def wer_distance(s1: str, s2: str) -> int:
    """Word-level edit distance via the word->char packing trick
    (reference: validation.py:116-132)."""
    vocab = set(s1.split() + s2.split())
    word2char = {w: chr(i) for i, w in enumerate(vocab)}
    w1 = "".join(word2char[w] for w in s1.split())
    w2 = "".join(word2char[w] for w in s2.split())
    return _distance(w1, w2)


def cer_distance(s1: str, s2: str) -> int:
    return _distance(s1.replace(" ", ""), s2.replace(" ", ""))


class ErrorRateState:
    """Accumulates (edit_distance_sum, denom_sum); rate = 100 * dist/denom."""

    def __init__(self):
        self.distance = 0
        self.denom = 0

    def compute(self) -> float:
        if self.denom == 0:
            return 0.0
        return float(self.distance) / self.denom * 100.0

    def state(self) -> Tuple[int, int]:
        return self.distance, self.denom


class WordErrorRate(ErrorRateState):
    def update(self, transcript: str, reference: str) -> None:
        self.distance += wer_distance(transcript, reference)
        self.denom += len(reference.split())


class CharErrorRate(ErrorRateState):
    def update(self, transcript: str, reference: str) -> None:
        self.distance += cer_distance(transcript, reference)
        self.denom += len(reference.replace(" ", ""))


def update_batch(wer: WordErrorRate, cer: CharErrorRate,
                 transcripts: Sequence[str], references: Sequence[str]) -> None:
    """Add a batch's pairs to both rates, in an ``eval.score`` span
    (``dsjax_torch.trace``)."""
    with span("eval.score"):
        for t, r in zip(transcripts, references):
            wer.update(t, r)
            cer.update(t, r)
