"""Read the numbers that the Conformer cell's limits are set from, on the
card, in one process: the program's on many seeds, the float8 control's and
each planted fault's on a few (``readings.py``'s way, for the
``train_conformer`` driver).

    python3 portbench/conformer_readings.py --workload train-conformer-l-b64-t1600 \
        --seeds 1,2,... [--control-seeds 7,8] [--fault-seeds 7,8] [--faults a,b] [--out FILE]

The control runs the reference twice (float32, and with every product's
operands and every kept tensor rounded through float8,
``reference.ds2.fp8_quant``) and compares the two as the program is
compared. The faults (``FAULTS``) patch the port's Conformer under the
timed path:

  positional      the attention's positional term left out (rel_shift gives 0);
  running_stats   the conv module's BatchNorm on its running statistics in
                  training;
  whole_residual  each FFN's half-step residual taken whole.

One JSON line per reading goes to standard output and, with ``--out``, to
FILE. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
if sys.path[0] == str(ROOT / "portbench"):
    sys.path[0] = str(ROOT)

FAULTS = ("positional", "running_stats", "whole_residual")


@contextlib.contextmanager
def conformer_fault(name: str):
    import torch

    from dsjax_torch.model import conformer

    block = conformer.ConformerBlock
    if name == "positional":
        def no_offsets(x):
            return torch.zeros_like(x[..., :x.shape[2]])

        with mock.patch.object(conformer, "rel_shift", no_offsets):
            yield
    elif name == "running_stats":
        original = block.conv_module

        def conv_module(self, x, step_mask):
            bn = self.conv.batch_norm
            bn.train(False)
            try:
                return original(self, x, step_mask)
            finally:
                bn.train(self.training)

        with mock.patch.object(block, "conv_module", conv_module):
            yield
    elif name == "whole_residual":
        original = block.ffn

        def ffn(self, *args):
            return 2.0 * original(self, *args)

        with mock.patch.object(block, "ffn", ffn):
            yield
    else:
        raise KeyError(name)


def control(cell):
    """The float8 reference against the float32 reference at the cell's
    size, as ``check.train_numbers`` compares the program."""
    from portbench import check, conformer_weights, traffic
    from portbench.drivers import train
    from portbench.readings import peak
    from portbench.reference import conformer as ref_conformer
    from portbench.reference.ds2 import fp8_quant

    tr, dev = cell.traffic, cell.device
    rows, n = int(tr["batch"]), int(tr["checked_steps"])
    utts = traffic.generate(tr, cell.seed)
    optim = train.optim_settings(train.port_config(cell, rows))
    w0 = conformer_weights.make(cell.config, cell.seed, dev)
    batches = train.ref_batches(utts, rows, n, dev)
    cost = {}
    t0 = time.perf_counter()
    exact = ref_conformer.train_steps(w0, cell.config, batches, optim)
    cost.update(reference_s=time.perf_counter() - t0, reference_peak_bytes=peak(dev))
    t0 = time.perf_counter()
    low = ref_conformer.train_steps(w0, cell.config, batches, optim, quant=fp8_quant)
    cost.update(control_s=time.perf_counter() - t0, control_peak_bytes=peak(dev))
    return check.train_numbers(low, exact), dict(check.worst_leaves(low, exact), **cost)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default="", help="the faults to plant (default: all)")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    from portbench.drivers import train_conformer
    from portbench.readings import cell_for

    seeds = lambda s: [int(x) for x in s.split(",") if x]   # noqa: E731
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, numbers, notes=None):
        line = json.dumps({"workload": args.workload, "kind": kind, "seed": seed,
                           "numbers": numbers, "notes": notes or {}}, default=str)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in seeds(args.seeds):
        cell = cell_for(args.workload, seed, args.seconds)
        o = train_conformer.run(cell)
        emit("program", seed, o.numbers, dict(o.notes, setup_s=o.setup_s, **o.end_to_end,
                                               memory_peak_bytes=o.memory_peak_bytes))
    for seed in seeds(args.control_seeds):
        numbers, notes = control(cell_for(args.workload, seed, args.seconds))
        emit("control", seed, numbers, notes)
    for seed in seeds(args.fault_seeds):
        for name in [n for n in args.faults.split(",") if n] or FAULTS:
            cell = cell_for(args.workload, seed, args.seconds)
            with conformer_fault(name):
                o = train_conformer.run(cell)
            emit(f"fault:{name}", seed, o.numbers, o.notes)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
