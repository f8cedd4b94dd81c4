"""The one traffic generator: utterances from a mix file and a seed.

A mix (``traffic/<cell>.json``) names its driver and gives the parameters
read here:

  ``utterances``  {"count": N, "frames": F} (every utterance F frames);
                  {"count": N, "seconds": [lo, hi]} (durations at the N
                  mid-quantiles of the uniform density on [lo, hi]), with
                  ``"mean_seconds": m`` at those of the density of greatest
                  entropy on [lo, hi] with mean m, exp(-k s) normalised
                  (the least assumed shape given a range and a mean); or
                  {"durations": [s, ...]} (a corpus's own list); the same
                  set for every seed. ``"sort": "duration"`` orders them
                  shortest first, as the port's manifests are;
  ``targets``     {"chars": [lo, hi]} (lengths spread evenly over the
                  range, dealt to the utterances in an order drawn from
                  the seed) or {"chars_per_second": r};
  ``audio``       {"tones": [[f_lo, f_hi, amplitude], ...], "noise": a,
                  "segment_seconds": s}: each utterance sums one sine per
                  entry, its frequency drawn from [f_lo, f_hi] anew every
                  s seconds (phase continuous), and Gaussian noise of std
                  a, in full-scale units, stored as int16.

The seed changes the samples, the tones and the transcripts, never the
sizes, so every seed asks for the same work.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np

from portbench import counts

N_CLASSES = 29          # blank, apostrophe, A-Z, space


class Utterance(NamedTuple):
    samples: np.ndarray      # (n,) int16
    transcript: np.ndarray   # (l,) int32 label ids in 1..28


def sample_counts(spec: Dict) -> np.ndarray:
    """Each utterance's length in samples, in the mix's order."""
    u = spec["utterances"]
    if "frames" in u:
        # F frames of a centred STFT: (F - 1) * hop samples
        counts_ = np.full(int(u["count"]), (int(u["frames"]) - 1) * counts.HOP, np.int64)
    else:
        if "durations" in u:
            seconds = np.asarray(u["durations"], np.float64)
        else:
            lo, hi = u["seconds"]
            q = (np.arange(int(u["count"])) + 0.5) / int(u["count"])
            k = entropy_rate(lo, hi, u.get("mean_seconds", 0.5 * (lo + hi)))
            seconds = lo + (hi - lo) * (q if k == 0 else
                                        -np.log1p(-q * -np.expm1(-k)) / k)
        counts_ = np.rint(seconds * counts.SAMPLE_RATE).astype(np.int64)
    if u.get("sort") == "duration":
        counts_ = np.sort(counts_, kind="stable")
    return counts_


def entropy_rate(lo: float, hi: float, mean: float) -> float:
    """k of the density exp(-k x) on x in [0, 1] whose mean, mapped onto
    [lo, hi], is ``mean`` (0: uniform); by bisection."""
    target = (mean - lo) / (hi - lo)
    if not 0.0 < target < 1.0:
        raise ValueError(f"mean {mean} outside ({lo}, {hi})")

    def mean_of(k: float) -> float:
        return 0.5 if abs(k) < 1e-9 else 1.0 / k - 1.0 / np.expm1(k)

    a, b = -200.0, 200.0              # mean_of falls as k rises
    for _ in range(200):
        m = 0.5 * (a + b)
        a, b = (m, b) if mean_of(m) > target else (a, m)
    k = 0.5 * (a + b)
    return 0.0 if abs(target - 0.5) < 1e-12 else k


def _target_lengths(spec: Dict, n_samples: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    t = spec["targets"]
    if "chars" in t:
        lo, hi = t["chars"]
        lengths = np.rint(lo + (hi - lo) * np.arange(len(n_samples)) / max(1, len(n_samples) - 1))
        return rng.permutation(lengths.astype(np.int64))
    seconds = n_samples / counts.SAMPLE_RATE
    return np.maximum(1, np.rint(seconds * float(t["chars_per_second"]))).astype(np.int64)


def generate(spec: Dict, seed: int) -> List[Utterance]:
    """The mix's utterances for ``seed``."""
    rng = np.random.default_rng(int(seed))
    n_samples = sample_counts(spec)
    lengths = _target_lengths(spec, n_samples, rng)
    audio = spec["audio"]
    out = []
    for n, n_chars in zip(n_samples, lengths):
        seg = np.arange(n) // int(audio["segment_seconds"] * counts.SAMPLE_RATE)
        y = np.float32(audio["noise"]) * rng.standard_normal(n, dtype=np.float32)
        for f_lo, f_hi, amp in audio["tones"]:
            freq = rng.uniform(f_lo, f_hi, seg[-1] + 1).astype(np.float32)[seg]
            phase = np.cumsum(freq * np.float32(2 * np.pi / counts.SAMPLE_RATE))
            y += np.float32(amp) * np.sin(phase)
        samples = np.clip(np.rint(y * 32768.0), -32768, 32767).astype(np.int16)
        out.append(Utterance(samples, rng.integers(1, N_CLASSES, n_chars).astype(np.int32)))
    return out
