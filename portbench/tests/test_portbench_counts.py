"""The FLOP and byte counts against the figures they were written to
match: bench.py's flagship count and PERF.md's table of kernel bounds."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import counts, weights

ROOT = Path(__file__).resolve().parents[2]


def config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def test_train_flops_of_both_configurations():
    assert counts.train_flops(config("ds2-bilstm-1024x5"), 1024) == 298_421_354_496
    # 5 GRU-1024 layers one way, a Lookahead of 20 taps
    assert counts.train_flops(config("ds2-unigru-1024x5-la20"), 1024) == 132_893_147_136


def test_parameters_of_the_flagship():
    spec = weights.leaves(config("ds2-bilstm-1024x5"))
    trained = [s for name, s, _, _ in spec if not name.endswith(("running_mean", "running_var"))]
    assert sum(int(np.prod(s)) for s in trained) == config("ds2-bilstm-1024x5")["parameters"]


def _train_valid(kernel):
    """The valid steps of chip_smoke.py's training-shape lengths (T=512,
    B=64): phase_train_kernels' for the LSTM, phase_gru_train_kernels'
    for the GRU."""
    if kernel in ("K2", "K3"):
        rng = np.random.default_rng(1)
        lengths = rng.integers(1, 513, 64)
        lengths[:3] = (512, 1, 511)
    else:
        rng = np.random.default_rng(21)
        lengths = rng.integers(1, 513, 64)
        lengths[:4] = (512, 1, 511, 0)
    return int(lengths.sum())


SERVE_K1 = 501 + 1 + 250 + 501 + 37 + 400 + 499 + 128      # chip_smoke.py's K1 lengths
SERVE_K4 = SERVE_K1 - 128                                    # and K4's (one row empty)


@pytest.mark.parametrize("kernel, args, ms, by", [
    ("K1", (2, 501, 8, 1024, "float32", SERVE_K1), 0.580, "operations"),
    ("K2", (2, 512, 64, 1024, "float32", None), 4.017, "operations"),
    ("K2", (2, 512, 64, 1024, "bfloat16", None), 0.406, "bytes"),
    ("K3", (2, 512, 64, 1024, "float32", None), 4.017, "operations"),
    ("K3", (2, 512, 64, 1024, "bfloat16", None), 0.406, "bytes"),
    ("K4", (2, 501, 8, 1024, "float32", SERVE_K4), 0.411, "operations"),
    ("K4r", (2, 512, 64, 1024, "bfloat16", None), 0.324, "bytes"),
    ("K4r", (2, 512, 64, 1024, "float32", None), 3.346, "operations"),
    ("K5", (2, 512, 64, 1024, "bfloat16", None), 0.365, "bytes"),
    ("K5", (2, 512, 64, 1024, "float32", None), 3.346, "operations"),
])
def test_scan_bounds_match_the_kernel_table(kernel, args, ms, by):
    args = args[:5] + ((_train_valid(kernel),) if args[5] is None else (args[5],))
    seconds, what = counts.bound(kernel, *args)
    assert round(seconds * 1e3, 3) == ms
    assert what == by


def test_k7_bound_is_its_bytes():
    seconds, what = counts.bound("K7", 16, 500, 128, 29, 16 * 500)
    assert what == "bytes"
    assert round(seconds * 1e3, 3) == 0.005


def test_the_training_cell_bounds_by_operations():
    # every step valid: the bf16 product outweighs the bytes
    seconds, what = counts.bound("K2", 2, 512, 64, 1024, "bfloat16", 512 * 64)
    assert what == "operations"
    assert seconds == pytest.approx(2 * 4 * 1024 ** 2 * 512 * 64 * 2 / 989e12)


@pytest.mark.parametrize("rnn_type,training,kernels", [
    ("lstm", True, ["K2", "K3"]), ("lstm", False, ["K1"]), ("gru", True, ["K4r", "K5"]),
    ("gru", False, ["K4"]), ("rnn", True, []), ("rnn", False, [])])
def test_scan_calls_follow_the_recurrent_type(rnn_type, training, kernels):
    arch = dict(config("ds2-bilstm-1024x5"), rnn_type=rnn_type)
    calls = counts.scan_calls(arch, training, 512, 64, "bfloat16", 512 * 64)
    assert sorted(calls) == kernels
    for k, c in calls.items():
        assert c == [(2, 512, 64, 1024, "bfloat16", 512 * 64)] * 5
        assert counts.bound(k, *c[0])[0] > 0
