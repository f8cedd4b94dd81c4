#!/usr/bin/env python3
"""Profile dsjax_torch's training step of the flagship model on a CUDA card.

    python tools/torch_profile_train.py [--batch 64] [--frames 1024] [--precision 16]
                                        [--rnn lstm|gru] [--out FILE]

Builds the full-width 5x BiLSTM-1024 DeepSpeech2 (or with --rnn gru the
5x BiGRU-1024, whose scans are K4 with residuals and K5; weights from the
trainer's seed) and runs ``Trainer.train_step`` (forward, f32 log-softmax,
CTC, backward through the LSTM kernels K2 and K3, global-norm clip 400,
AdamW) on one synthetic batch of ``--batch`` utterances of ``--frames``
spectrogram frames each (1024 frames = 10.24 s, 512 scan steps after the
conv stack), with targets of 100-200 characters:

  step     host clock around train_step plus a synchronize, median and min
           of 5 after 2 warm-up steps
  device   torch.profiler over 2 steps: kernel time per step, split into
           the residual-saving forward (K2), the reverse scan (K3), matrix
           products (cuBLAS), convolutions (cuDNN), CTC, the optimizer's
           multi-tensor kernels, copies and the rest; idle share =
           1 - kernel time / profiled wall time
  memory   peak device memory of a step

Prints one line per figure and the top kernels by device time, and, with
--out, writes every figure and the full kernel table as JSON. Needs a
card; imports nothing of jax.
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


def kernel_group(name: str) -> str:
    low = name.lower()
    if "lstm_bwd_step_kernel" in low:
        return "lstm reverse scan (K3)"
    if "gru_bwd_step_kernel" in low:
        return "gru reverse scan (K5)"
    if "lstm_residual_step_kernel" in low:
        return "lstm forward (K2)"
    if "gru_residual_step_kernel" in low:
        return "gru forward (K4r)"
    if any(k in low for k in ("persistent_scan", "lstm_step_kernel", "gru_step_kernel")):
        return "serving forward (K1, K4; validation only)"
    if "ctc" in low:
        return "ctc"
    if "multi_tensor_apply" in low or "adam" in low:
        return "optimizer"
    if "conv" in low or "fprop" in low or "dgrad" in low or "wgrad" in low:
        return "convolution"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet", "splitk")):
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


def synthetic_batch(np, batch: int, frames: int, seed: int):
    from dsjax_torch.data.dataset import Batch

    rng = np.random.default_rng(seed)
    inputs = rng.standard_normal((batch, 161, frames)).astype(np.float32)
    lengths = np.full((batch,), frames, np.int32)
    target_lengths = rng.integers(100, 201, batch).astype(np.int32)
    targets = rng.integers(1, 29, (batch, 256)).astype(np.int32)
    return Batch(inputs, lengths, targets, target_lengths, lengths / frames,
                 valid=np.ones((batch,), bool))


def profile_step(torch, np, precision: int, batch_size: int, frames: int, rnn: str = "lstm"):
    from dsjax_torch.config import TrainConfig, compose
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.train.loop import Trainer

    cfg = compose(TrainConfig, [f"trainer.precision={precision}", "trainer.device=cuda",
                                "trainer.devices=1", "data.device_features=false",
                                f"data.batch_size={batch_size}", f"model.rnn_type={rnn}"])
    trainer = Trainer(cfg, list(DEFAULT_LABELS))
    state = trainer.init_state()
    batch = synthetic_batch(np, batch_size, frames, seed=0)

    def step():
        nonlocal state
        state, loss = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        return float(loss)

    losses = [step() for _ in range(2)]
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        t0 = time.perf_counter()
        losses.append(step())
        walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()

    reps = 2
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
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
        "precision": precision, "batch": batch_size, "frames": frames, "rnn": rnn,
        "scan_steps": (frames - 1) // 2 + 1, "losses": losses,
        "step_wall_ms_median": statistics.median(walls), "step_wall_ms_min": min(walls),
        "utt_per_sec": batch_size / (statistics.median(walls) / 1e3),
        "peak_memory_gib": peak / 2 ** 30, "profiled_wall_ms": prof_wall_ms,
        "device_kernel_ms": device_ms, "idle_share": 1.0 - device_ms / prof_wall_ms,
        "groups_ms": groups,
        "kernels": sorted(([name, ms, count] for name, (ms, count) in kernels.items()),
                          key=lambda r: -r[1]),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--precision", type=int, default=16, choices=(16, 32))
    ap.add_argument("--rnn", default="lstm", choices=("lstm", "gru"))
    ap.add_argument("--out", default="", help="write every figure as JSON here")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_train: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card.splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; PyTorch default TF32 "
          f"settings (cudnn {torch.backends.cudnn.allow_tf32}, matmul "
          f"{torch.backends.cuda.matmul.allow_tf32})")
    r = profile_step(torch, np, args.precision, args.batch, args.frames, args.rnn)
    tag = f"{args.rnn} {'bf16' if args.precision == 16 else 'f32'}"
    print(f"[{tag}] B={r['batch']}, T={r['frames']} frames, {r['scan_steps']} scan steps: "
          f"step wall median {r['step_wall_ms_median']!r} ms (min {r['step_wall_ms_min']!r}), "
          f"{r['utt_per_sec']!r} utt/s; peak memory {r['peak_memory_gib']!r} GiB; "
          f"losses {r['losses']}")
    print(f"[{tag}] device kernel time per step {r['device_kernel_ms']!r} ms of "
          f"{r['profiled_wall_ms']!r} ms profiled wall; idle share {r['idle_share']!r}")
    print(f"[{tag}] by group: " + ", ".join(
        f"{k} {v!r} ms" for k, v in sorted(r["groups_ms"].items(), key=lambda kv: -kv[1])))
    for name, ms, count in r["kernels"][:12]:
        print(f"[{tag}] {ms:10.3f} ms x {count:5d}  {name[:100]}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "torch": torch.__version__, "result": r}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
