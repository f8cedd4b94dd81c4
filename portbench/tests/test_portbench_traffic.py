"""Each traffic mix repeats exactly for a seed, differs across seeds, and
asks every seed for the same sizes."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import traffic

ROOT = Path(__file__).resolve().parents[2]
MIXES = sorted(p.stem for p in (ROOT / "portbench" / "traffic").glob("*.json"))


@pytest.mark.parametrize("mix", MIXES)
def test_mix_repeats_for_a_seed_and_differs_across_seeds(mix):
    spec = json.loads((ROOT / "portbench" / "traffic" / f"{mix}.json").read_text())
    a, b, c = (traffic.generate(spec, s) for s in (2 ** 31 + 7, 2 ** 31 + 7, 12345))
    assert len(a) == len(b) == len(c) == spec["utterances"]["count"]
    for x, y in zip(a, b):
        assert np.array_equal(x.samples, y.samples)
        assert np.array_equal(x.transcript, y.transcript)
    assert [len(x.samples) for x in a] == [len(z.samples) for z in c]
    assert sorted(len(x.transcript) for x in a) == sorted(len(z.transcript) for z in c)
    assert not np.array_equal(a[0].samples, c[0].samples)
    assert any(not np.array_equal(x.transcript, z.transcript) for x, z in zip(a, c))
    for u in a:
        assert u.samples.dtype == np.int16
        assert u.transcript.min() >= 1 and u.transcript.max() < traffic.N_CLASSES


def test_sorted_corpus_runs_shortest_first():
    spec = {"utterances": {"count": 40, "seconds": [1, 15], "sort": "duration"}}
    n = traffic.sample_counts(spec)
    assert list(n) == sorted(n) and n[0] == round(1.175 * 16000) and n[-1] == round(14.825 * 16000)


@pytest.mark.parametrize("mean", [7.42, 8.0, 4.0, 12.0])
def test_durations_meet_the_mean_inside_the_range(mean):
    spec = {"utterances": {"count": 400, "seconds": [1, 15], "mean_seconds": mean}}
    seconds = traffic.sample_counts(spec) / 16000
    assert abs(seconds.mean() - mean) < 1e-3 * mean
    assert seconds.min() >= 1 and seconds.max() <= 15
    # below the middle of the range the density falls, above it rises
    assert (np.median(seconds) < mean) == (mean < 8.0) or mean == 8.0


def test_listed_durations_are_taken_as_they_stand():
    spec = {"utterances": {"durations": [2.5, 1.0, 7.25], "sort": "duration"}}
    assert list(traffic.sample_counts(spec)) == [16000, 40000, 116000]
