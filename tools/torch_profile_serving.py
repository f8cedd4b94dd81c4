#!/usr/bin/env python3
"""Profile one serving batch of dsjax_torch's flagship model on a CUDA card.

    python tools/torch_profile_serving.py [--batch 8] [--seconds 10] [--out FILE]

Builds the full-width 5x BiLSTM-1024 DeepSpeech2 from the seeded weights of
tests/golden_flagship.py and, in float32 and in bfloat16 (the server's
precision=32 and precision=16), runs the serving batch path of
``dsjax_torch.server.BatchWorker._process`` piece by piece on ``--batch``
synthetic utterances of ``--seconds`` each:

  host STFT   FeatureExtractor on each utterance, one after another (host clock)
  forward     ModelBundle.forward on the padded batch plus a synchronize,
              median and min of 10 (host clock)
  device      torch.profiler over 3 forwards: kernel time per forward, split
              into the LSTM forward K1 (the persistent kernel, or the
              per-step kernel of older checkouts), matrix products, convolutions,
              copies and the rest; idle share = 1 - kernel time / profiled
              wall time
  decode      GreedyDecoder on the batch's posteriors, median of 5 after a
              first call (host clock)

PyTorch's default TF32 settings stay as the server runs them. Prints one
line per figure, each precision's top kernels by device time, and, with
--out, writes every figure and the full kernel table as JSON. Needs a card;
imports nothing of jax.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000


def kernel_group(name: str) -> str:
    low = name.lower()
    if "persistent_scan" in low or "lstm_step_kernel" in low:
        return "lstm forward (K1)"
    if "conv" in low or "fprop" in low:
        return "convolution"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet")):
        return "matrix product"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def device_us(evt) -> float:
    """Time of a device-side event (a kernel or a copy) in microseconds."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_precision(torch, np, precision: int, state, batch: int, seconds: float):
    from dsjax_torch.audio.features import FeatureExtractor
    from dsjax_torch.config import SpectConfig
    from dsjax_torch.decode.greedy import GreedyDecoder
    from dsjax_torch.inference import ModelBundle
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.model.convert import from_reference_state_dict, infer_architecture
    from dsjax_torch.model.ds2 import DeepSpeech2

    model_cfg, classes = infer_architecture(state)
    dtype = torch.bfloat16 if precision == 16 else torch.float32
    model = DeepSpeech2(classes, SpectConfig(), model_cfg, dtype=dtype)
    model.load_state_dict(from_reference_state_dict(state))
    bundle = ModelBundle(model, list(DEFAULT_LABELS), SpectConfig(), "cuda:0")
    decoder = GreedyDecoder(DEFAULT_LABELS)
    extractor = FeatureExtractor(bundle.spect_cfg, normalize=True)

    rng = np.random.default_rng(precision)
    n = int(SR * seconds)
    ys = [(0.2 * np.sin(2 * np.pi * rng.uniform(120, 400) * np.arange(n) / SR)
           + 0.05 * rng.standard_normal(n)).astype(np.float32) for _ in range(batch)]
    t0 = time.perf_counter()
    spects = [extractor(y) for y in ys]
    stft_ms = (time.perf_counter() - t0) * 1e3
    max_t = (max(s.shape[1] for s in spects) + 63) // 64 * 64
    inputs = np.zeros((batch, spects[0].shape[0], max_t), np.float32)
    lengths = np.array([s.shape[1] for s in spects], np.int32)
    for i, s in enumerate(spects):
        inputs[i, :, : s.shape[1]] = s

    def forward():
        out = bundle.forward(inputs, lengths)
        torch.cuda.synchronize()
        return out

    for _ in range(3):
        forward()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        probs, out_lens, _ = forward()
        walls.append((time.perf_counter() - t0) * 1e3)
    decoder.decode(probs, out_lens)                # first use loads its kernels
    decodes = []
    for _ in range(5):
        t0 = time.perf_counter()
        decoder.decode(probs, out_lens)
        decodes.append((time.perf_counter() - t0) * 1e3)

    reps = 3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            forward()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels = {}
    for evt in prof.key_averages():
        # operators and runtime calls also carry the device time of the
        # kernels they launched; count each kernel once, as its own event
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = device_us(evt)
        if us > 0:
            row = kernels.setdefault(evt.key, [0.0, 0])
            row[0] += us / 1e3 / reps
            row[1] += evt.count // reps
    device_ms = sum(ms for ms, _ in kernels.values())
    groups = {}
    for name, (ms, _) in kernels.items():
        groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + ms
    return {
        "precision": precision, "batch": batch, "seconds": seconds,
        "frames": int(max_t), "scan_steps": int(probs.shape[1]),
        "host_stft_ms": stft_ms, "forward_wall_ms_median": statistics.median(walls),
        "forward_wall_ms_min": min(walls), "greedy_decode_ms_median": statistics.median(decodes),
        "profiled_wall_ms": prof_wall_ms, "device_kernel_ms": device_ms,
        "idle_share": 1.0 - device_ms / prof_wall_ms, "groups_ms": groups,
        "kernels": sorted(([name, ms, count] for name, (ms, count) in kernels.items()),
                          key=lambda r: -r[1]),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default="", help="write every figure as JSON here")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_serving: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from tests.golden_flagship import flagship_state

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card.splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; PyTorch default TF32 "
          f"settings (cudnn {torch.backends.cudnn.allow_tf32}, matmul "
          f"{torch.backends.cuda.matmul.allow_tf32})")
    state = flagship_state()
    results = []
    for precision in (32, 16):
        r = profile_precision(torch, np, precision, state, args.batch, args.seconds)
        results.append(r)
        tag = "f32" if precision == 32 else "bf16"
        print(f"[{tag}] B={r['batch']} x {r['seconds']} s, T={r['frames']} frames, "
              f"{r['scan_steps']} scan steps: host STFT {r['host_stft_ms']!r} ms; forward wall "
              f"median {r['forward_wall_ms_median']!r} ms (min {r['forward_wall_ms_min']!r}); "
              f"greedy decode median {r['greedy_decode_ms_median']!r} ms")
        print(f"[{tag}] device kernel time per forward {r['device_kernel_ms']!r} ms of "
              f"{r['profiled_wall_ms']!r} ms profiled wall; idle share {r['idle_share']!r}")
        print(f"[{tag}] by group: " + ", ".join(
            f"{k} {v!r} ms" for k, v in sorted(r["groups_ms"].items(), key=lambda kv: -kv[1])))
        for name, ms, count in r["kernels"][:8]:
            print(f"[{tag}] {ms:10.3f} ms x {count:5d}  {name[:100]}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "torch": torch.__version__, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
