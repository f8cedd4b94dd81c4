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
