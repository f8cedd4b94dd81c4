#!/usr/bin/env python3
"""Time this checkout's scan kernels and training steps in turns with another
checkout of the port (its parent commit, say), on one CUDA card.

    git archive <parent> | tar -x -C proof/parent     # a directory .gitignore lists
    python tools/torch_scan_turns.py --parent proof/parent [--runs LABELS] [--out FILE]

In the order parent, this checkout, this checkout, parent, runs each
checkout's copy of
  tools/torch_serving_scans.py   K1 and K4 at the serving shapes (T=501, B=8,
                                 H=1024), f32 and bf16, 2 directions and 1,
                                 and at about an evaluation batch's (T=577, B=20);
  tools/torch_lstm_microbench.py K1 to K5 and K8 at the training shapes
                                 (T=512, B=64, H=1024, bf16);
  tools/torch_profile_train.py   one bf16 training step of the 5x BiLSTM-1024
                                 flagship and of the 5x BiGRU-1024, B=64, T=1024
                                 frames;
  tools/torch_profile_eval.py    one f32 evaluation batch of the flagship (20
                                 utterances of 2-12 s, beam W=10);
each in a process of its own from that checkout's root, so each builds and
times its own kernels; --runs takes a comma-separated subset of these
labels ("serving scans", "microbench", "train step lstm bf16", "train step
gru bf16", "eval batch f32"). This checkout's torch_serving_scans.py,
torch_profile_train.py and torch_profile_eval.py are copied into the other
first: both sides run the same measuring code. Prints one line a figure and
turn with the card's name and power limit, and with --out writes every tool's
JSON, by turn. Needs a card; imports nothing of jax.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIED = ("torch_serving_scans.py", "torch_profile_train.py", "torch_profile_eval.py")


# (label, tool, arguments) of one turn
RUNS = (("serving scans", "torch_serving_scans.py", []),
        ("microbench", "torch_lstm_microbench.py", []),
        ("train step lstm bf16", "torch_profile_train.py", ["--rnn", "lstm"]),
        ("train step gru bf16", "torch_profile_train.py", ["--rnn", "gru"]),
        ("eval batch f32", "torch_profile_eval.py", []))


def figures(label: str, data: dict) -> dict:
    """The figures of one tool's JSON that the summary lines show."""
    if label == "serving scans":
        return {f"{k} {d}": v[f"{d} ms"] for k, v in data["results"].items()
                for d in ("2 directions", "1 direction") if f"{d} ms" in v}
    if label == "microbench":
        return {k: v["ms"] for k, v in data.items() if isinstance(v, dict) and "ms" in v}
    if label == "eval batch f32":
        return {"forward ms": data["forward_ms"], "K7 ms": data["k7_ms"],
                "backtrack ms": data["backtrack_ms"],
                "backtrack impl": data["backtrack_impl"],
                "backtrack device ms": data["backtrack_device_ms"],
                **{f"profile {k} kernel ms": v["kernel_ms"] for k, v in data["profile"].items()},
                **{f"profile {k} idle share": v["idle_share"] for k, v in data["profile"].items()}}
    r = data["result"]
    return {"step wall median ms": r["step_wall_ms_median"],
            "device kernel ms": r["device_kernel_ms"], "idle share": r["idle_share"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="root of the other checkout")
    ap.add_argument("--runs", default=",".join(r[0] for r in RUNS),
                    help="the labels of the tools to run, comma-separated")
    ap.add_argument("--out", default="", help="write every tool's JSON here, by turn")
    args = ap.parse_args()
    runs = [r for r in RUNS if r[0] in args.runs.split(",")]
    parent = os.path.abspath(args.parent)
    for name in COPIED:
        shutil.copy(os.path.join(ROOT, "tools", name), os.path.join(parent, "tools", name))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card.splitlines()[0])
    turns = [("parent", parent), ("change", ROOT), ("change", ROOT), ("parent", parent)]
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (side, tree) in enumerate(turns):
            turn = {"side": side, "tree": tree}
            for label, tool, extra in runs:
                out = os.path.join(tmp, f"{i}_{tool}_{'_'.join(extra)}.json")
                proc = subprocess.run([sys.executable, os.path.join(tree, "tools", tool), *extra,
                                       "--out", out], cwd=tree, capture_output=True, text=True)
                if proc.returncode != 0:
                    print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                    raise SystemExit(f"turn {i} ({side}): {tool} {extra} exited "
                                     f"{proc.returncode}")
                with open(out) as f:
                    data = json.load(f)
                turn[label] = data
                for key, value in figures(label, data).items():
                    print(f"turn {i} {side:6s} {label}: {key} {value!r}")
            results.append(turn)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "turns": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
