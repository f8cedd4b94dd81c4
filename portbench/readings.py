"""Read the numbers that a cell's limits are set from, on the card, in one
process: the program's on many seeds, the control's and each fault's on
a few.

    python3 portbench/readings.py --workload NAME --seeds 1,2,... \
        [--control-seeds 7,8,9] [--fault-seeds 7,8,9] [--faults a,b] [--out FILE]

Each program seed runs the cell's driver with a short window; a training
control seed runs the reference twice (float32, and in float8) and
compares the two as the program is compared; an evaluation control seed
runs the driver on the program's bfloat16 path, then with the reference's
bfloat16 beam search in the decoder's place. Each fault (``faults.py``)
runs the driver with the fault planted. One JSON line per
reading goes to standard output and, with ``--out``, to FILE. The
benchmark's own runs do not run this.

For a cell of several ranks (``ranks`` in its mix), the program and fault
seeds run as ``chips`` ranks of this script (``ranks.py``), rank 0 writing
the lines; the control, which runs the reference alone, runs in this
process on ``cuda:0`` first, and only the control where no program or
fault seed is given.
"""

from __future__ import annotations

import argparse
import json
import os
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
                        False, w["chips"],
                        torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))),
                        time.perf_counter())


def driver_for(cell):
    import importlib

    return importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")


def train_control(cell):
    """The float8 reference against the float32 reference, at the cell's
    size (for a cell of several ranks, its global batch, the loss over the
    world), as ``check.train_numbers`` compares the program. The float8
    step loop keeps only each recurrent layer's input for its backward."""
    from portbench import check, traffic, weights
    from portbench.drivers import train
    from portbench.reference import ds2, train as ref_train

    tr, dev = cell.traffic, cell.device
    world = cell.chips if tr.get("ranks") else 1
    rows, n = int(tr["batch"]) * world, int(tr["checked_steps"])
    utts = traffic.generate(tr, cell.seed)
    optim = train.optim_settings(train.port_config(cell, rows))
    w0 = weights.make(cell.config, cell.seed, dev, tr.get("head_scale", 1.0))
    batches = train.ref_batches(utts, rows, n, dev)
    cost = {}
    t0 = time.perf_counter()
    exact = ref_train.train_steps(w0, cell.config, batches, optim, divisor=world)
    cost.update(reference_s=time.perf_counter() - t0, reference_peak_bytes=peak(dev))
    t0 = time.perf_counter()
    low = ref_train.train_steps(w0, cell.config, batches, optim, quant=ds2.fp8_quant,
                                divisor=world, checkpoint=True)
    cost.update(control_s=time.perf_counter() - t0, control_peak_bytes=peak(dev))
    return check.train_numbers(low, exact), dict(check.worst_leaves(low, exact), **cost)


def peak(device) -> int:
    """The card's allocation peak since the last call, which resets it."""
    import torch

    if device.type != "cuda":
        return 0
    out = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    return out


def launch_ranks(args, world: int) -> int:
    """Run the program and fault seeds as ``world`` ranks of this script and
    pass rank 0's lines on."""
    from dsjax_torch.ops import _build
    from portbench import ranks

    _build.build()
    ended = ranks.launch([sys.executable, str(Path(__file__).resolve()), *sys.argv[1:]], world,
                         args.timeout)
    sys.stdout.write(ended.stdout[0])
    for r, err in enumerate(ended.stderr):
        print(f"rank {r}, exit {ended.returncodes[r]}:\n{err[-4000:]}", file=sys.stderr)
    if not ended.ok:
        print(f"readings.py: {ended.reason}", file=sys.stderr)
        return 5
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default="", help="the faults to plant (default: every one "
                    "the cell can have)")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--beam-control-seconds", type=float, default=45.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--timeout", type=float, default=3000.0,
                    help="seconds for the ranks of a cell of several ranks")
    args = ap.parse_args()
    from portbench import faults, ranks

    seeds = lambda s: [int(x) for x in s.split(",") if x]   # noqa: E731
    first = cell_for(args.workload, 0, 0)
    is_train = first.traffic["driver"] in ("train", "ddp_train")
    several = bool(first.traffic.get("ranks"))
    rank = ranks.rank()
    out = open(args.out, "a") if args.out and not rank else None

    def emit(kind, seed, numbers, notes=None):
        if rank:
            return
        line = json.dumps({"workload": args.workload, "kind": kind, "seed": seed,
                           "numbers": numbers, "notes": notes or {}})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    if several and rank is None:
        for seed in seeds(args.control_seeds):
            numbers, notes = train_control(cell_for(args.workload, seed, args.seconds))
            emit("control", seed, numbers, notes)
        if out:
            out.close()
        return launch_ranks(args, first.chips) if args.seeds or args.fault_seeds else 0
    if several:
        from dsjax_torch.parallel import distributed

        distributed.initialize(first.device.type)
    for seed in seeds(args.seeds):
        cell = cell_for(args.workload, seed, args.seconds)
        o = driver_for(cell).run(cell)
        if o is not None:
            emit("program", seed, o.numbers, dict(o.notes, setup_s=o.setup_s, **o.end_to_end))
    for seed in seeds("" if several else args.control_seeds):
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
        names = (faults.DDP_FAULTS if several else faults.TRAIN_FAULTS) if is_train \
            else faults.EVAL_FAULTS
        for name in [n for n in args.faults.split(",") if n] or names:
            ctx = (faults.train_fault(name) if is_train
                   else faults.eval_fault(name, cell.config["labels"]))
            with ctx:
                o = driver_for(cell).run(cell)
            if o is not None:
                emit(f"fault:{name}", seed, o.numbers, o.notes)
    if out:
        out.close()
    if several:
        distributed.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
