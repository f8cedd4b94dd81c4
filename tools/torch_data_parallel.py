#!/usr/bin/env python3
"""Run chip_smoke.py's phase 24, data-parallel inference, by itself.

    python tools/torch_data_parallel.py [--out FILE]

Builds the kernels and the host library from the checkout, then drives the
seeded flagship (5 x BiLSTM-1024, tests/golden_flagship.py) over the
replicas of one ``ModelBundle``, TF32 off: every visible card when there
are two or more, else two replicas sharing cuda:0. It holds the gathered
posteriors, every decoder's strings, the server's and
``workflows.evaluate``'s output against one card's, counts K1, K6, K7 and
backtrack launches, and times one evaluation batch (forward with the
greedy and the scan-route beam decode) on one card and on the replicas.
Prints the card's name and power limit, and writes the phase's results as
JSON to FILE. Needs a card; imports nothing of jax.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="write the results as JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_data_parallel: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import chip_smoke
    from dsjax_torch.audio import native
    from dsjax_torch.model.convert import infer_architecture
    from dsjax_torch.ops import _build
    from tests.golden_flagship import flagship_state

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    gpu_name = torch.cuda.get_device_name(0)
    print(smi.stdout.strip())
    print(f"device: {gpu_name}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible")
    t0 = time.perf_counter()
    _build.build(force=True)
    _build.load_library()
    native.build(force=True)
    native.load_library()
    print(f"build: {time.perf_counter() - t0!r} s")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    state = flagship_state()
    model_cfg, _ = infer_architecture(state)
    result = chip_smoke.phase_data_parallel(torch, np, state, model_cfg, gpu_name, card)
    result["card"] = card
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
