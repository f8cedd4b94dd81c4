"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the port (``dsjax_torch``). The cell's entry in ``BENCHMARK.json`` names
its configuration (``portbench/configs/<config>.json``); its traffic mix
(``portbench/traffic/<cell>.json``) names the driver
(``portbench/drivers/<driver>.py``) that builds the program, warms it up,
measures for ``--seconds`` and compares what the window produced with the
plain reference. With ``--trace 0`` the line's metrics are the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, each read by
``portbench/metrics/<metric>.py`` from what the driver gathered.

A cell whose traffic mix asks for ``ranks`` runs as one process a card:
this process builds the port's kernel library once, starts ``chips``
processes of itself in torchrun's environment (``ranks.py``), each on
``cuda:<rank>``, and waits for them. Rank 0 prints the line and the checks,
which this process passes on; a rank that fails, or ranks that pass the
mix's ``ranks.timeout_s``, end every rank, and then no line is printed and
the exit code is not 0. The set-up time counts from this process's start.

The last line of standard output is one JSON object; the numbers compared
and their limits close standard error. Without the CUDA cards the cell
asks for, or with JAX or the JAX package loaded once the window has closed,
it prints no result and exits with a code other than 0. Build and kernel
caches stay inside the checkout (``build/``: the port's library, Triton's
and PyTorch's runtime-compiled kernels).
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dsjax")
STARTED_ENV = "PORTBENCH_STARTED"     # the launching process's start, for its ranks
TAIL = 4000                           # characters of another rank's standard error


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's, flax's
    or the JAX package's (``dsjax_torch`` is not ``dsjax``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def per_layer(bench: dict, workload: str, end_to_end: dict, layer: dict, root: Path) -> dict:
    """Each per-layer metric of this cell that its reader finds something
    to read for."""
    out = {}
    for m in bench["per_layer"]:
        if workload not in m.get("workloads", [workload]) or m["moves"] not in end_to_end:
            continue
        reader = load_module(root / "portbench" / "metrics" / f"{m['name']}.py",
                             f"portbench_metric_{m['name'].replace('.', '_')}")
        value = reader.read(layer)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def resolve(root: Path, workload: str):
    """(BENCHMARK.json, the cell's entry, its configuration, its traffic mix,
    its driver's path), each found by name."""
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(root / "portbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return bench, w, config, traffic, root / "portbench" / "drivers" / f"{traffic['driver']}.py"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    try:
        bench, w, config, traffic, driver_path = resolve(ROOT, args.workload)
    except KeyError as e:
        print(f"run.py: {e}", file=sys.stderr)
        return 2
    # kernel caches inside the checkout, at fixed paths, made before any rank
    # would race another to make them
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH", str(ROOT / "build" / "torch_kernels"))
    os.makedirs(os.environ["PYTORCH_KERNEL_CACHE_PATH"], exist_ok=True)
    sys.path.insert(0, str(ROOT))
    if sys.path[1:2] == [str(ROOT / "portbench")]:
        del sys.path[1]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"run.py: {w['name']} needs {w['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    from portbench import harness, ranks

    rank = ranks.rank()
    if traffic.get("ranks") and rank is None:
        return launch_ranks(w["chips"], traffic["ranks"]["timeout_s"],
                            sys.argv[1:] if argv is None else argv)
    cell = harness.Cell(name=w["name"], config=config, traffic=traffic, seed=args.seed,
                        seconds=args.seconds, trace=bool(args.trace), chips=w["chips"],
                        device=torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))),
                        started=float(os.environ.get(STARTED_ENV, STARTED)))
    driver = load_module(driver_path, f"portbench_driver_{traffic['driver']}")
    outcome = driver.run(cell)
    if rank:
        return refuse_forbidden()
    return report(bench, w, cell, outcome, torch)


def launch_ranks(world: int, timeout_s: float, argv) -> int:
    """Build the port's library, run this command as ``world`` ranks, and
    pass on rank 0's output: its standard output whole, the other ranks'
    standard error's ends before rank 0's, which ends with the checks."""
    from dsjax_torch.ops import _build
    from portbench import ranks

    _build.build()      # once, so that no two ranks build
    ended = ranks.launch([sys.executable, str(Path(__file__).resolve()), *argv], world,
                         timeout_s, env=dict(os.environ, **{STARTED_ENV: repr(STARTED)}))
    for r in range(1, world):
        if ended.stderr[r].strip():
            print(f"rank {r}, exit {ended.returncodes[r]}, the end of its standard error:\n"
                  f"{ended.stderr[r][-TAIL:]}", file=sys.stderr)
    if not ended.ok:
        print(f"rank 0, exit {ended.returncodes[0]}:\n{ended.stderr[0][-TAIL:]}",
              file=sys.stderr)
        print(f"run.py: {ended.reason}; every rank was ended, no result", file=sys.stderr)
        return 5
    code = refuse_forbidden()
    if code:
        return code
    sys.stderr.write(ended.stderr[0])
    sys.stdout.write(ended.stdout[0])
    return 0


def refuse_forbidden() -> int:
    """4, naming them, when JAX or the JAX package is loaded; else 0."""
    found = forbidden_modules()
    if found:
        print(f"run.py: JAX or the JAX package is loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    return 0


def report(bench: dict, w: dict, cell, outcome, torch) -> int:
    from portbench import check

    code = refuse_forbidden()
    if code:
        return code
    mine = {m["name"]: m for m in bench["end_to_end"]
            if w["name"] in m.get("workloads", [w["name"]])}
    end_to_end = dict(outcome.end_to_end, setup_s=outcome.setup_s)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(cell.device),
              "count": cell.chips, "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    line = {"correct": None, "attempted": outcome.attempted, "failed": outcome.failed}
    if cell.trace:
        metrics = per_layer(bench, w["name"], mine, outcome.layer, ROOT)
        span = outcome.layer["span"]
        device.update(busy_s=span["busy_s"], window_s=span["seconds"])
    else:
        metrics = {k: {"value": float(end_to_end[k]), "unit": m["unit"]}
                   for k, m in mine.items()}
    correct, checks = check.judge(outcome.numbers, cell.traffic["limits"])
    line.update(correct=correct and outcome.failed == 0, metrics=metrics, device=device)
    if outcome.breakdown is not None:
        line["breakdown"] = outcome.breakdown
    line["checks"] = checks
    notes = dict(outcome.notes, setup_s=outcome.setup_s,
                 run_s=time.perf_counter() - STARTED,
                 **{f"{k} (not compared)": v for k, v in outcome.numbers.items()
                    if k not in checks})
    for k, v in notes.items():
        print(f"note {k}: {v}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
