#!/usr/bin/env python3
"""Microbenchmark of the port's recurrent scan kernels beside their floor,
the matmul-only chain K8: the counterpart of tools/lstm_microbench.py on one
CUDA card.

    python tools/torch_lstm_microbench.py [--out microbench.json]

One direction, bf16, every row valid, at the training shapes of the
flagship (B=64, H=1024, T=512). Times with CUDA events (median of 5 after
one warm-up call) of:
  K1                    lstm_scan_fwd (inference);
  K2                    lstm_scan_fwd(save_residuals=True);
  K2, 2 directions      the same, both directions of a layer in one call (the
                        second scans backwards), as chip_smoke.py times it;
  K2 + K3               K2 then lstm_scan_bwd on its residuals;
  K3, 2 directions      lstm_scan_bwd alone on K2's residuals, both directions of
                        a layer in one call (the second scans them backwards);
  K4                    gru_scan_fwd (inference);
  K4 with residuals     gru_scan_fwd(save_residuals=True);
  K4 with residuals, 2 directions  as K2's row;
  K4 with residuals + K5  that, then gru_scan_bwd (h_prev computed once,
                        outside the timing);
  K5, 2 directions      gru_scan_bwd alone on K4's residuals, both directions
                        of a layer in one call, as K3's row;
  K8                    mm_chain, h <- (h . W + xp[t])[:, :H] over 4H columns.
Prints each in ms and us per step, and K8's share of the bf16 tensor-core
peak (989 TFLOP/s, H100 SXM), as the JAX tool prints the MXU's. Then one
more call of each under torch.profiler gives the kernels' own device time
and launch count, so the share of a call spent between launches shows
beside its CUDA-event time. Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_PEAK = 989e12
B, H, T = 64, 1024, 512      # the flagship's training batch, width, scan steps
REPS = 5


def cuda_ms(torch, fn):
    """Median milliseconds of fn() over REPS runs after one warm-up call."""
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


def device_profile(torch, cases, log):
    """{name: kernel device ms and launches} of one call of each case under
    torch.profiler, each kernel counted once as its own event."""
    out = {}
    for name, fn in cases.items():
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        us, launches = 0.0, 0
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            t = next((float(getattr(evt, a)) for a in ("self_device_time_total",
                                                        "self_cuda_time_total")
                      if hasattr(evt, a)), 0.0)
            if t > 0:
                us += t
                launches += evt.count
        out[name] = {"kernel_ms": us / 1e3, "kernel_launches": launches}
        log(f"{name:28s} kernels {us / 1e3:10.3f} ms in {launches} launches "
            f"({us / max(launches, 1):.3f} us each; torch.profiler)")
    return out


def run(log=print):
    """Time every kernel at (B, H, T); returns {name: {"ms", "us_per_step",
    "kernel_ms", "kernel_launches", "busy_share"}} plus K8's FLOP count and
    peak share. Each case runs REPS + 3 times: a warm-up, the timed reps, a
    warm-up and one call under the profiler."""
    import torch

    from dsjax_torch.ops import gru, lstm, mm_chain
    from dsjax_torch.ops.lstm import _carried_h_prev

    if not torch.cuda.is_available():
        raise RuntimeError("torch_lstm_microbench needs a CUDA card")
    gen = torch.Generator().manual_seed(0)
    dt, rev = torch.bfloat16, (False,)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda", dt)

    mask = torch.ones((T, B), device="cuda")
    xp4, w4, b4 = randn(1, T, B, 4 * H), randn(1, 4 * H, H, scale=0.02), randn(1, 4 * H)
    xp3, w3, b3 = randn(1, T, B, 3 * H), randn(1, 3 * H, H, scale=0.02), randn(1, 3 * H)
    h0 = torch.zeros((1, B, H), device="cuda", dtype=dt)
    dy, dh = randn(1, T, B, H), randn(1, B, H)
    y4, _, _, g4, c_seq = lstm.lstm_scan_fwd(xp4, mask, w4, b4, h0, h0, rev, save_residuals=True)
    y3, _, g3 = gru.gru_scan_fwd(xp3, mask, w3, b3, h0, rev, save_residuals=True)
    h_prev = _carried_h_prev(y3, mask, h0, rev)
    xp_chain, w_chain = xp4[0], randn(H, 4 * H, scale=0.01)
    g2, w2, z2, c2, dy2, dh2 = (torch.cat([a, a]) for a in (g4, w4, h0, c_seq, dy, dh))
    gg2, gw2, gh2 = (torch.cat([a, a]) for a in (g3, w3, h_prev))
    xp4_2, b4_2, xp3_2, b3_2 = (torch.cat([a, a]) for a in (xp4, b4, xp3, b3))

    def k2_k3():
        _, _, _, g, c = lstm.lstm_scan_fwd(xp4, mask, w4, b4, h0, h0, rev, save_residuals=True)
        lstm.lstm_scan_bwd(g, mask, w4, h0, c, dy, dh, dh, rev)

    def k4r_k5():
        _, _, g = gru.gru_scan_fwd(xp3, mask, w3, b3, h0, rev, save_residuals=True)
        gru.gru_scan_bwd(g, mask, w3, h_prev, dy, dh, rev)

    cases = {
        "K1 lstm_fwd": lambda: lstm.lstm_scan_fwd(xp4, mask, w4, b4, h0, h0, rev),
        "K2 lstm_fwd_residuals": lambda: lstm.lstm_scan_fwd(xp4, mask, w4, b4, h0, h0, rev,
                                                            save_residuals=True),
        "K2 lstm_fwd_residuals, 2 dir": lambda: lstm.lstm_scan_fwd(
            xp4_2, mask, w2, b4_2, z2, z2, (False, True), save_residuals=True),
        "K2 + K3 lstm_bwd": k2_k3,
        # both directions in one call, as a bidirectional layer runs it (the
        # second direction scans the same residuals backwards in time)
        "K3 lstm_bwd, 2 directions": lambda: lstm.lstm_scan_bwd(g2, mask, w2, z2, c2, dy2, dh2,
                                                                  dh2, (False, True)),
        "K4 gru_fwd": lambda: gru.gru_scan_fwd(xp3, mask, w3, b3, h0, rev),
        "K4 gru_fwd_residuals": lambda: gru.gru_scan_fwd(xp3, mask, w3, b3, h0, rev,
                                                         save_residuals=True),
        "K4 gru_fwd_residuals, 2 dir": lambda: gru.gru_scan_fwd(
            xp3_2, mask, gw2, b3_2, z2, (False, True), save_residuals=True),
        "K4 residuals + K5 gru_bwd": k4r_k5,
        "K5 gru_bwd, 2 directions": lambda: gru.gru_scan_bwd(gg2, mask, gw2, gh2, dy2, dh2,
                                                              (False, True)),
        "K8 mm_chain": lambda: mm_chain.mm_chain(xp_chain, w_chain, h0[0]),
    }
    del y4, g4, c_seq, g3
    out = {}
    log(f"B={B} H={H} T={T} bf16, one direction, all rows valid; "
        f"{torch.cuda.get_device_name(0)}")
    for name, fn in cases.items():
        ms = cuda_ms(torch, fn)
        out[name] = {"ms": ms, "us_per_step": ms * 1e3 / T}
        log(f"{name:28s} {ms:10.3f} ms  {ms * 1e3 / T:9.3f} us/step")
    step_flops = 2 * B * H * 4 * H
    floor_s = out["K8 mm_chain"]["ms"] / 1e3 / T
    share = step_flops / BF16_PEAK / floor_s
    out["K8 step_flops"] = step_flops
    out["K8 bf16_peak_share"] = share
    log(f"recurrent matmul per step: {step_flops / 1e6:.0f} MFLOP -> "
        f"{step_flops / BF16_PEAK * 1e6:.3f} us at the bf16 peak; K8 floor "
        f"{floor_s * 1e6:.3f} us/step = {100 * share:.1f}% of peak")
    for name in ("K1 lstm_fwd", "K4 gru_fwd"):
        log(f"{name} over the floor: {out[name]['us_per_step'] - floor_s * 1e6:+.3f} us/step")
    for name, row in device_profile(torch, cases, log).items():
        out[name].update(row, busy_share=row["kernel_ms"] / out[name]["ms"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    out = run()
    out["card"] = smi.stdout.strip()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
