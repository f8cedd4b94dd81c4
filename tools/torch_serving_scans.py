#!/usr/bin/env python3
"""Time the serving forward scans K1 (LSTM) and K4 (GRU) on one CUDA card.

    python tools/torch_serving_scans.py [--out FILE]

At the serving shapes of chip_smoke.py's phases 3 and 14 (T=501, B=8,
H=1024, ragged lengths of 10 s utterances, nonzero carry, W_hh at 0.03):
``lstm_scan`` and ``gru_scan`` outside autograd, f32 and bf16, both
directions in one call and one direction; both directions at B=1 (one
utterance of T steps); then both directions at about
the scan shape of one flagship evaluation batch as tools/torch_profile_eval.py
forms it (20 utterances of 2-12 s padded to 1152 frames, 576 scan steps):
T=577, B=20, 100-577 valid steps a row. Each figure
is the median of 20 calls timed with CUDA events after 2 warm-up calls,
with the card's name and power limit. It calls only the ops' public functions, so the same file
times an older checkout of the port when run from there. Needs a card;
imports nothing of jax.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, B, H = 501, 8, 1024
REPS = 20
LENGTHS = [T, 1, 250, T, 37, 400, T - 2, 128]
EVAL_T, EVAL_B = 577, 20


def cuda_ms(torch, fn):
    """Median milliseconds of fn() over REPS calls after 2 warm-up calls."""
    fn()
    fn()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run(torch, np):
    from dsjax_torch.ops import gru, lstm

    rng = np.random.default_rng(0)
    # (label, T, B, lengths, whether to time one direction too)
    shapes = (("", T, B, np.array(LENGTHS), True),
              (" B=1", T, 1, np.array([T]), False),
              (f" eval T={EVAL_T} B={EVAL_B}", EVAL_T, EVAL_B,
               rng.integers(100, EVAL_T + 1, EVAL_B), False))
    out = {}
    for label, n_t, n_b, lengths, one_dir in shapes:
        mask_np = (np.arange(n_t)[:, None] < lengths[None, :]).astype(np.float32)
        mask = torch.from_numpy(mask_np).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            dev = lambda a: torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)
            for kernel, gates, scan, carry in (("K1", 4, lstm.lstm_scan, 2),
                                               ("K4", 3, gru.gru_scan, 1)):
                xp = dev(rng.standard_normal((2, n_t, n_b, gates * H)) * 0.3)
                w = dev(rng.standard_normal((2, gates * H, H)) * 0.03)
                b = dev(rng.standard_normal((2, gates * H)) * 0.1)
                state = [dev(rng.standard_normal((2, n_b, H)) * 0.1) for _ in range(carry)]
                with torch.no_grad():
                    both = cuda_ms(torch, lambda: scan(xp, mask, w, b, *state, (False, True)))
                    r = {"T": n_t, "B": n_b, "2 directions ms": both,
                         "us a step, 2 directions": both * 1e3 / n_t}
                    if one_dir:
                        r["1 direction ms"] = cuda_ms(
                            torch, lambda: scan(xp[:1], mask, w[:1], b[:1],
                                                *[s[:1] for s in state], (False,)))
                out[f"{kernel} {name}{label}"] = r
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="", help="write the figures as JSON here")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_serving_scans: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card.splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    res = run(torch, np)
    for key, r in res.items():
        one = (f", 1 direction {r['1 direction ms']!r} ms" if "1 direction ms" in r else "")
        print(f"{key} T={r['T']} B={r['B']} H={H}: 2 directions {r['2 directions ms']!r} ms "
              f"({r['us a step, 2 directions']!r} us a step){one} (median of {REPS}, CUDA "
              f"events)")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "tree": ROOT, "results": res}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
