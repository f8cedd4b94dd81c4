"""A cell, a configuration, a traffic mix, a driver and a per-layer metric
defined only in new files (and entries of BENCHMARK.json) load by name,
with no edit to a file the benchmark already has."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_new_cell_in_new_files_loads(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    (pb / "configs" / "ds2-bigru-1024x5.json").write_text(json.dumps(
        {"rnn_type": "gru", "hidden_size": 1024, "hidden_layers": 5, "bidirectional": True,
         "num_classes": 29}))
    (pb / "traffic" / "serve-bigru-b8.json").write_text(json.dumps(
        {"driver": "serve", "utterances": {"count": 8, "seconds": [1, 2]}, "limits": {}}))
    (pb / "drivers" / "serve.py").write_text("def run(cell):\n    return cell.traffic\n")
    (pb / "metrics" / "serve.queue_ms.py").write_text(
        "def read(layer):\n    return layer.get('queue_s', 0.0) * 1e3\n")
    bench["configs"].append({"name": "ds2-bigru-1024x5", "source": "https://example.org",
                             "file": "portbench/configs/ds2-bigru-1024x5.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "serve-bigru-b8", "config": "ds2-bigru-1024x5",
                               "traffic": "serve-bigru-b8", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "transcribe_p95_ms", "unit": "ms", "better": "lower",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["serve-bigru-b8"]})
    bench["per_layer"].append({"name": "serve.queue_ms", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "server",
                               "moves": "transcribe_p95_ms", "workloads": ["serve-bigru-b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = f"""
import sys
sys.path.insert(0, {str(tmp_path)!r})
from pathlib import Path
from portbench import run
root = Path({str(tmp_path)!r})
bench, w, config, traffic, driver = run.resolve(root, "serve-bigru-b8")
module = run.load_module(driver, "d")
assert module.run(type("C", (), {{"traffic": traffic}})) == traffic
metrics = run.per_layer(bench, w["name"], {{"transcribe_p95_ms": {{}}}}, {{"queue_s": 0.004}}, root)
assert metrics == {{"serve.queue_ms": {{"value": 4.0, "unit": "ms"}}}}, metrics
assert config["rnn_type"] == "gru"
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.stdout.strip() == "ok", out.stderr
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data


K9 = '''"""A stub scan kernel: the vanilla RNN's training forward."""

from portbench.counts import least_time

COUNTER = ("dsjax_torch.ops.k9_stub", "LAUNCHES")
LAUNCHED_BY = (("rnn", True),)


def matches(name):
    return "rnn_scan_kernel" in name


def bound(n_dir, n_t, n_b, n_h, dtype, valid):
    return least_time(2.0 * n_h * n_h * valid * n_dir, 4.0 * n_dir * n_t * n_b * n_h, dtype)
'''

RNN = '''"""A stub cell: torch.nn.RNN's tanh recurrence, carrying h."""

import torch

MODULE = torch.nn.RNN
GATES = 1
CARRIES = 1


def update(x_t, hp, carries):
    return (torch.tanh(x_t + hp),)
'''


def test_new_kernel_and_recurrent_cell_in_new_files_load(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    (tmp_path / "portbench" / "kernels" / "K9.py").write_text(K9)
    (tmp_path / "portbench" / "reference" / "cells" / "rnn.py").write_text(RNN)
    code = f"""
import sys, types
sys.path.insert(0, {str(tmp_path)!r})
sys.path.append({str(ROOT)!r})
import torch
import portbench
assert portbench.__file__.startswith({str(tmp_path)!r})
from portbench import counts, harness, readers, weights
from portbench.reference import ds2

stub = types.ModuleType("dsjax_torch.ops.k9_stub")
stub.LAUNCHES = 5
sys.modules["dsjax_torch.ops.k9_stub"] = stub
assert harness.counters()["K9"] == 5
assert harness.kernel_group("void rnn_scan_kernel<float>(Args)") == "K9"
arch = {{"rnn_type": "rnn", "hidden_size": 16, "hidden_layers": 2, "bidirectional": True,
        "num_classes": 29}}
calls = counts.scan_calls(arch, True, 12, 3, "float32", 30)
assert calls == {{"K9": [(2, 12, 3, 16, "float32", 30)] * 2}}, calls
assert counts.scan_calls(arch, False, 12, 3, "float32", 30) == {{}}
layer = {{"span": {{"ops": {{"void rnn_scan_kernel<float>(Args)": [2, 1e-3]}}}},
         "calls": calls, "counters": {{"K9": 2}}}}
want = 100.0 * 2 * counts.bound("K9", *calls["K9"][0])[0] / 1e-3
assert readers.roofline(layer, "K9") == want > 0
# the reference's forward over torch.nn.RNN, and its step loop (the
# rounding left out) giving the same
w = weights.make(arch, 3, "cpu")
assert w["rnns.0.rnn.weight_hh_l0"].shape == (16, 16)
feats, lengths = torch.randn(3, 161, 24), torch.tensor([24, 17, 9])
packed, _ = ds2.forward(w, arch, feats, lengths, train=True)
looped, _ = ds2.forward(w, arch, feats, lengths, train=True, quant=lambda x: x)
assert torch.allclose(packed, looped, atol=1e-4), (packed - looped).abs().max()
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.stdout.strip() == "ok", out.stderr
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data
