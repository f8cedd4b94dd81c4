"""Read the numbers that a cell's limits are set from, on the card, in one
process: the program's on many seeds, the control's and each fault's on
a few.

    python3 portbench/readings.py --workload NAME --seeds 1,2,... \
        [--control-seeds 7,8,9] [--fault-seeds 7,8,9] [--out FILE]

Each program seed runs the cell's driver with a short window; a training
control seed runs the reference twice (float32, and in float8) and
compares the two as the program is compared; an evaluation control seed
runs the driver on the program's bfloat16 path, then with the reference's
bfloat16 beam search in the decoder's place. Each fault (``faults.py``)
runs the driver with the fault planted. One JSON line per
reading goes to standard output and, with ``--out``, to FILE. The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path[0] == str(ROOT / "portbench"):
    sys.path[0] = str(ROOT)


def cell_for(workload: str, seed: int, seconds: float, traffic_override=None):
    import torch

    from portbench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    w = {c["name"]: c for c in bench["workloads"]}[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    tr = harness.load_json(ROOT / "portbench" / "traffic" / f"{w['traffic']}.json")
    tr.update(traffic_override or {})
    return harness.Cell(w["name"], harness.load_json(ROOT / conf["file"]), tr, seed, seconds,
                        False, w["chips"], torch.device("cuda", 0), time.perf_counter())


def driver_for(cell):
    import importlib

    return importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")


def train_control(cell):
    """The float8 reference against the float32 reference, at the cell's
    size, as ``check.train_numbers`` compares the program."""
    from portbench import check, traffic, weights
    from portbench.drivers import train
    from portbench.reference import ds2, train as ref_train

    tr, dev = cell.traffic, cell.device
    batch, n = int(tr["batch"]), int(tr["checked_steps"])
    utts = traffic.generate(tr, cell.seed)
    optim = train.optim_settings(train.port_config(cell, batch))
    w0 = weights.make(cell.config, cell.seed, dev, tr.get("head_scale", 1.0))
    batches = train.ref_batches(utts, batch, n, dev)
    exact = ref_train.train_steps(w0, cell.config, batches, optim)
    low = ref_train.train_steps(w0, cell.config, batches, optim, quant=ds2.fp8_quant)
    return check.train_numbers(low, exact), check.worst_leaves(low, exact)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--beam-control-seconds", type=float, default=45.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    from portbench import faults

    seeds = lambda s: [int(x) for x in s.split(",") if x]   # noqa: E731
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, numbers, notes=None):
        line = json.dumps({"workload": args.workload, "kind": kind, "seed": seed,
                           "numbers": numbers, "notes": notes or {}})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in seeds(args.seeds):
        cell = cell_for(args.workload, seed, args.seconds)
        o = driver_for(cell).run(cell)
        emit("program", seed, o.numbers, dict(o.notes, setup_s=o.setup_s, **o.end_to_end))
    is_train = cell_for(args.workload, 0, 0).traffic["driver"] == "train"
    for seed in seeds(args.control_seeds):
        if is_train:
            numbers, notes = train_control(cell_for(args.workload, seed, args.seconds))
        else:
            base = cell_for(args.workload, seed, args.seconds).traffic["port"]
            cell = cell_for(args.workload, seed, args.seconds,
                            {"port": [p for p in base if not p.startswith("model.precision")]
                             + ["model.precision=16"]})
            o = driver_for(cell).run(cell)
            emit("control:forward", seed, o.numbers, o.notes)
            # the reference's Python beam is slow: a window long enough to
            # decode every batch once
            cell = cell_for(args.workload, seed, args.beam_control_seconds)
            width = int(next(p for p in cell.traffic["port"] if p.startswith("lm.beam_width"))
                        .split("=")[1])
            with faults.beam_control(cell.config["labels"], width):
                o = driver_for(cell).run(cell)
            numbers, notes = o.numbers, o.notes
        emit("control" if is_train else "control:beam", seed, numbers, notes)
    for seed in seeds(args.fault_seeds):
        cell = cell_for(args.workload, seed, args.seconds)
        names = faults.TRAIN_FAULTS if is_train else faults.EVAL_FAULTS
        for name in names:
            ctx = (faults.train_fault(name) if is_train
                   else faults.eval_fault(name, cell.config["labels"]))
            with ctx:
                o = driver_for(cell).run(cell)
            emit(f"fault:{name}", seed, o.numbers, o.notes)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
