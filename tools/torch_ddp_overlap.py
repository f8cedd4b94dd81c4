#!/usr/bin/env python3
"""Data-parallel training steps of the port over several ranks, one card
each (NCCL), with DDP's gradient all-reduces overlapping the backward.

    python tools/torch_ddp_overlap.py [--world 4] [--steps 8] [--warmup 3]
        [--hidden 1024] [--layers 5] [--rows 64] [--frames 1024]
        [--delay-rank R --delay-step S --delay-s SECONDS]
        [--device cuda|cpu] [--root DIR] [--out FILE]

Starts ``--world`` ranks of itself (torchrun's environment, a free port on
localhost), each a ``Trainer`` over the model in bf16 (f32 on the CPU) on
``--rows`` rows of random (161, ``--frames``) features of its own, and
times ``train_step`` on each rank: warm-up steps, then ``--steps`` timed
ones, a step ending when its loss reaches the host. Each K3 call of the
backward (``lstm.lstm_scan_bwd``) is timed between CUDA events on its
stream, which includes any wait for SMs that NCCL's kernels hold. With
``--delay-rank``, that rank sleeps ``--delay-s`` seconds between its
forward and its backward at step ``--delay-step`` (counting warm-up steps),
so the other ranks' first gradient all-reduce waits on the card while their
backward goes on: K3 then shares the card with an NCCL kernel that spins
for that long. ``--root`` is the checkout whose ``dsjax_torch`` runs (this
one by default), so two trees can be compared with one script.

Prints one line per rank and a summary (the median step ms over ranks and
steps, the K3 calls' ms, the launch counters), writes them as JSON to
``--out``, and exits 1 if any rank failed. Needs ``--world`` cards for
``cuda``; ``--device cpu`` runs the same over gloo at small sizes. Imports
nothing of jax.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", type=int, default=4)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--hidden", type=int, default=1024)
    p.add_argument("--layers", type=int, default=5)
    p.add_argument("--rows", type=int, default=64)
    p.add_argument("--frames", type=int, default=1024)
    p.add_argument("--delay-rank", type=int, default=-1)
    p.add_argument("--delay-step", type=int, default=-1)
    p.add_argument("--delay-s", type=float, default=0.0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--root", default=ROOT, help="the checkout whose dsjax_torch runs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--timeout", type=float, default=900.0, help="seconds for the ranks")
    p.add_argument("--out", default=None)
    return p.parse_args(argv)


def rank_main(args) -> dict:
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    from dsjax_torch.config import TrainConfig, compose
    from dsjax_torch.data.dataset import Batch
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.ops import lstm
    from dsjax_torch.parallel import distributed
    from dsjax_torch.train import loop

    rank = int(os.environ["RANK"])
    cuda = args.device == "cuda"
    distributed.initialize(args.device)
    try:
        cfg = compose(TrainConfig, [
            f"model.hidden_size={args.hidden}", f"model.hidden_layers={args.layers}",
            f"trainer.precision={16 if cuda else 32}", f"data.batch_size={args.rows}",
            "data.device_features=false", f"trainer.device={args.device}", "seed=7"])
        trainer = loop.Trainer(cfg, list(DEFAULT_LABELS))
        state = trainer.init_state()
        rng = np.random.default_rng(args.seed + rank)
        b, t = args.rows, args.frames
        lengths = np.full((b,), t, np.int32)
        lengths[1::2] = t * 3 // 4
        inputs = rng.standard_normal((b, 161, t)).astype(np.float32)
        for i in range(b):
            inputs[i, :, lengths[i]:] = 0.0
        targets = rng.integers(1, len(DEFAULT_LABELS), size=(b, 24)).astype(np.int32)
        batch = Batch(inputs, lengths, targets, np.full((b,), 24, np.int32),
                      lengths.astype(np.float32) / t, valid=np.ones((b,), bool))

        step = [0]
        k3_events = []
        ctc_loss, scan_bwd = loop.ctc_loss, lstm.lstm_scan_bwd

        def delayed_ctc(*a, **k):
            out = ctc_loss(*a, **k)
            if rank == args.delay_rank and step[0] == args.delay_step:
                if cuda:
                    torch.cuda.synchronize()
                time.sleep(args.delay_s)
            return out

        def timed_bwd(*a, **k):
            if not cuda:
                return scan_bwd(*a, **k)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = scan_bwd(*a, **k)
            end.record()
            k3_events.append((step[0], start, end))
            return out

        loop.ctc_loss, lstm.lstm_scan_bwd = delayed_ctc, timed_bwd
        step_ms, counts = [], {}
        for i in range(args.warmup + args.steps):
            step[0] = i
            lstm.BWD_LAUNCHES = 0
            resident = hasattr(lstm, "BWD_RESIDENT_LAUNCHES")
            if resident:
                lstm.BWD_RESIDENT_LAUNCHES = 0
            t0 = time.perf_counter()
            state, loss = trainer.train_step(state, batch)
            loss = float(loss)
            if cuda:
                torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            counts[i] = [lstm.BWD_LAUNCHES,
                         lstm.BWD_RESIDENT_LAUNCHES if resident else None]
            if not np.isfinite(loss):
                raise RuntimeError(f"step {i}: loss {loss}")
        k3_ms = {}
        for i, start, end in k3_events:
            k3_ms.setdefault(i, []).append(start.elapsed_time(end))
        return {"rank": rank, "device": torch.cuda.get_device_name() if cuda else "cpu",
                "step_ms": step_ms, "k3_ms": k3_ms, "k3_launches": counts,
                "warmup": args.warmup}
    finally:
        distributed.destroy()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(args) -> int:
    if args.device == "cuda":
        sys.path.insert(0, os.path.abspath(args.root))
        from dsjax_torch.ops import _build

        t0 = time.perf_counter()
        _build.build()
        print(f"build of {args.root}: {time.perf_counter() - t0!r} s", flush=True)
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                        "MASTER_PORT")}
    procs = []
    for r in range(args.world):
        local = r if args.device == "cuda" else 0
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *sys.argv[1:]],
            env=dict(env, WORLD_SIZE=str(args.world), RANK=str(r), LOCAL_RANK=str(local),
                     LOCAL_WORLD_SIZE=str(args.world if args.device == "cuda" else 1),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], False
    try:
        for p in procs:
            logs.append(p.communicate(timeout=args.timeout)[0])
    except subprocess.TimeoutExpired:
        failed = True
    finally:
        for p in procs:
            p.kill()
    results = []
    for r, (p, log) in enumerate(zip(procs, logs + [""] * (len(procs) - len(logs)))):
        found = [line[len("RESULT "):] for line in log.splitlines() if line.startswith("RESULT ")]
        if p.returncode != 0 or not found:
            failed = True
            print(f"rank {r}: rc {p.returncode}\n{log[-3000:]}", flush=True)
            continue
        results.append(json.loads(found[-1]))
    summary = {"root": os.path.abspath(args.root), "world": args.world, "failed": failed,
               "delay": [args.delay_rank, args.delay_step, args.delay_s], "ranks": results}
    if results:
        w = args.warmup
        timed = [ms for res in results for ms in res["step_ms"][w:]]
        k3 = [ms for res in results for i, calls in res["k3_ms"].items() if int(i) >= w
              for ms in calls]
        summary.update(step_ms_median=statistics.median(timed),
                       k3_ms_median=statistics.median(k3) if k3 else None,
                       k3_ms_max=max(k3) if k3 else None)
        for res in results:
            print(f"rank {res['rank']} ({res['device']}): step ms {res['step_ms']}; K3 ms by "
                  f"step {res['k3_ms']}; K3 launches (all, resident) by step "
                  f"{res['k3_launches']}", flush=True)
        print(f"summary: world {args.world}, root {args.root}, delay {summary['delay']}: "
              f"step median {summary['step_ms_median']!r} ms, K3 call median "
              f"{summary['k3_ms_median']!r} ms, max {summary['k3_ms_max']!r} ms (steps after "
              f"{w} warm-up ones, all ranks)", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 1 if failed else 0


def main() -> int:
    args = parse()
    if "RANK" in os.environ:
        print("RESULT " + json.dumps(rank_main(args)), flush=True)
        return 0
    return launch(args)


if __name__ == "__main__":
    sys.exit(main())
