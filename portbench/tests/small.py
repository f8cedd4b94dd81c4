"""Cells cut to a size a CPU test holds: the cell's own files with the
model narrowed to 2 layers of 64 and a few short utterances. The limits
stay the cell's. A cell of several ranks runs here as one process, or as
gloo ranks on the CPU (``tests/test_portbench_ranks.py``)."""

import json
import time
from pathlib import Path

import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


def small_cell(workload: str, seed: int = 5, **traffic) -> harness.Cell:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = {c["name"]: c for c in bench["workloads"]}[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    config.update(hidden_size=64, hidden_layers=2,
                  port=[p.replace("1024", "64").replace("hidden_layers=5", "hidden_layers=2")
                        for p in config["port"]])
    tr = json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    if tr["driver"] in ("train", "ddp_train"):
        # four global batches at every world size up to the cell's chips
        tr.update(utterances={"count": 16 * w["chips"], "frames": 128}, batch=4,
                  targets={"chars": [10, 20]})
    else:
        tr.update(utterances={"count": 8, "seconds": [0.5, 1.5], "sort": "duration"},
                  checked_batches=2,
                  port=[p for p in tr["port"] if not p.startswith(("batch_size", "lm.beam"))]
                  + ["batch_size=4", "lm.beam_width=4"])
    tr.update(traffic)
    return harness.Cell(workload, config, tr, seed, 0.3, False, 1, torch.device("cpu"),
                        time.perf_counter())


def cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]]


def driver(cell: harness.Cell):
    import importlib

    return importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
