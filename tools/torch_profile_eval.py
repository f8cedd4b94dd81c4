#!/usr/bin/env python3
"""Profile one flagship evaluation batch of dsjax_torch on a CUDA card.

    python tools/torch_profile_eval.py [--batch 20] [--width 10] [--out FILE]

Builds the full-width 5x BiLSTM-1024 DeepSpeech2 from the seeded weights of
tests/golden_flagship.py (float32, evaluate's default precision) and runs
the pieces of one batch of ``dsjax_torch.workflows.evaluate`` on ``--batch``
synthetic utterances of 2-12 s, with the STFT on the card and beam
decoding at ``--width``:

  host prep   pad_audio_for_device + int16 + collate_audio of the batch
              (host clock; evaluate runs it on loader threads)
  copy        the int16 batch to the card (CUDA events)
  STFT        spectrogram_torch on the card (CUDA events, median of 10)
  forward     the model on the features (CUDA events, median of 5)
  scan+K6     the beam scan route: _beam_scan (a K6 launch a frame) and
              the K6 ranking (CUDA events, median of 3)
  K7          the fused beam scan with its ranking (CUDA events, median of 10)
  backtrack   the backtrack of the top beam (CUDA events, median of 5), and
              its kernels' device time under torch.profiler: the backtrack
              kernel (ops.beam.backtrack), or the gather loop of
              _backtrack in a tree that has no kernel
  decode      DeviceBeamDecoder.decode(n_best=1) wall on each route, and
              GreedyDecoder's (host clock, median of 5); the host share is
              the wall less the device pieces above
  profile     torch.profiler over STFT + forward + decode on each route:
              kernel time, profiled wall and the idle share

PyTorch's default TF32 settings stay as evaluate runs them. Prints one line
per figure and, with --out, writes them as JSON. Needs a card; imports
nothing of jax.
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


def device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def events_ms(torch, fn, reps: int) -> float:
    """Median CUDA-event time of fn() over reps runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(torch, fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profiled(torch, fn, reps: int = 2):
    """(device kernel ms, profiled wall ms) per call of fn."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    kernel = sum(device_us(e) for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps
    return kernel, wall


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=20)
    ap.add_argument("--width", type=int, default=10)
    ap.add_argument("--out", default="", help="write every figure as JSON here")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_eval: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from dsjax_torch.audio.features import pad_audio_for_device, spectrogram_torch
    from dsjax_torch.config import SpectConfig
    from dsjax_torch.data.dataset import collate_audio
    from dsjax_torch.decode.beam_device import DeviceBeamDecoder, _backtrack, _beam_scan
    from dsjax_torch.decode.greedy import GreedyDecoder
    from dsjax_torch.inference import ModelBundle
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.model.convert import from_reference_state_dict, infer_architecture
    from dsjax_torch.model.ds2 import DeepSpeech2
    from dsjax_torch.ops import beam, topk
    from tests.golden_flagship import flagship_state

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card.splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; PyTorch default TF32 settings")
    state = flagship_state()
    model_cfg, classes = infer_architecture(state)
    model = DeepSpeech2(classes, SpectConfig(), model_cfg)
    model.load_state_dict(from_reference_state_dict(state))
    bundle = ModelBundle(model, list(DEFAULT_LABELS), SpectConfig(), "cuda:0")
    cfg = bundle.spect_cfg
    hop = int(cfg.sample_rate * cfg.window_stride)

    rng = np.random.default_rng(0)
    seconds = rng.uniform(2.0, 12.0, args.batch)
    ys = []
    for s in seconds:
        t = np.arange(int(SR * s)) / SR
        ys.append((0.1 * np.sin(2 * np.pi * rng.uniform(120, 400) * t)
                   + 0.01 * rng.standard_normal(len(t))).astype(np.float32))

    def host_prep():
        items = []
        for y in ys:
            yp, n = pad_audio_for_device(y, cfg)
            items.append((np.clip(np.rint(yp * 32768.0), -32768, 32767).astype(np.int16), n,
                          [1]))
        return collate_audio(items, hop, 64, 64, args.batch)

    t0 = time.perf_counter()
    batch = host_prep()
    prep_ms = (time.perf_counter() - t0) * 1e3
    audio_host = torch.from_numpy(batch.audio).pin_memory()
    lens = torch.from_numpy(batch.input_lengths).cuda()
    audio = audio_host.cuda()
    copy_ms = events_ms(torch, lambda: audio_host.to("cuda", non_blocking=True), 10)
    stft_ms = events_ms(torch, lambda: spectrogram_torch(audio, lens, cfg), 10)
    feats = spectrogram_torch(audio, lens, cfg)
    with torch.inference_mode():
        forward_ms = events_ms(torch, lambda: model(feats, lens), 5)
        probs, out_lens, _ = model(feats, lens)
    lp = torch.log(torch.clamp_min(probs.float(), 1e-30))
    w = args.width

    def scan_route():
        out = _beam_scan(lp, out_lens, w, 0)
        return out, topk.topk(out[3], 1)

    before = topk.LAUNCHES
    scan_route()
    k6_per_decode = topk.LAUNCHES - before
    scan_ms = events_ms(torch, scan_route, 3)
    k7_ms = events_ms(torch, lambda: beam.fused_beam_scan(lp, out_lens, w, 0), 10)
    bp, em, _, _, _, (_, order) = beam.fused_beam_scan(lp, out_lens, w, 0)
    # a tree before the backtrack kernel has only the gather loop; the JSON
    # says which one was timed
    backtrack = getattr(beam, "backtrack", _backtrack)
    backtrack_impl = "gather loop" if backtrack is _backtrack else "kernel"
    backtrack_ms = events_ms(torch, lambda: backtrack(bp, em, order[:, :1]), 5)
    backtrack_device_ms = profiled(torch, lambda: backtrack(bp, em, order[:, :1]), 5)[0]

    decoder = DeviceBeamDecoder(DEFAULT_LABELS, beam_width=w)
    greedy = GreedyDecoder(DEFAULT_LABELS)
    walls, profiles = {}, {}
    for route, env in (("scan+K6", "0"), ("K7", "1")):
        os.environ["DSJAX_FUSED_BEAM"] = env
        walls[route] = wall_ms(torch, lambda: decoder.decode(probs, out_lens, n_best=1), 5)

        def step():
            with torch.inference_mode():
                x = spectrogram_torch(audio, lens, cfg)
                p, o, _ = model(x, lens)
            decoder.decode(p, o, n_best=1)

        profiles[route] = profiled(torch, step)
    os.environ.pop("DSJAX_FUSED_BEAM")
    walls["greedy"] = wall_ms(torch, lambda: greedy.decode(probs, out_lens, n_best=1), 5)
    host_share = {"scan+K6": walls["scan+K6"] - scan_ms - backtrack_ms,
                  "K7": walls["K7"] - k7_ms - backtrack_ms}
    r = {"card": card, "torch": torch.__version__, "batch": args.batch, "width": w,
         "seconds": [float(s) for s in seconds], "frames": int(feats.shape[2]),
         "scan_steps": int(probs.shape[1]), "host_prep_ms": prep_ms, "copy_ms": copy_ms,
         "stft_ms": stft_ms, "forward_ms": forward_ms, "scan_k6_ms": scan_ms,
         "k6_launches_per_decode": k6_per_decode, "k7_ms": k7_ms, "backtrack_ms": backtrack_ms,
         "backtrack_impl": backtrack_impl, "backtrack_device_ms": backtrack_device_ms,
         "decode_wall_ms": walls, "decode_host_ms": host_share,
         "profile": {k: {"kernel_ms": v[0], "wall_ms": v[1], "idle_share": 1 - v[0] / v[1]}
                     for k, v in profiles.items()}}
    print(f"B={args.batch} utterances of 2-12 s, padded to {r['frames']} frames, "
          f"{r['scan_steps']} output frames, beam W={w}")
    print(f"host prep (pad, int16, collate) {prep_ms!r} ms; copy to the card {copy_ms!r} ms; "
          f"STFT {stft_ms!r} ms; forward {forward_ms!r} ms (CUDA events)")
    print(f"beam: scan with K6 {scan_ms!r} ms ({k6_per_decode} K6 launches); K7 {k7_ms!r} ms; "
          f"backtrack ({backtrack_impl}) {backtrack_ms!r} ms (CUDA events), "
          f"{backtrack_device_ms!r} ms of kernels (torch.profiler)")
    print(f"decode wall (n_best=1): {walls}; host share {host_share}")
    for k, v in r["profile"].items():
        print(f"profile STFT + forward + decode ({k}): kernel {v['kernel_ms']!r} ms of "
              f"{v['wall_ms']!r} ms wall, idle share {v['idle_share']!r}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(r, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
