#!/usr/bin/env python3
"""Drive dsjax_torch's serving path once on one CUDA card and check it.

    python3 chip_smoke.py          # from the root of a checkout; needs one card

Phases, each printing what it measured; any failure exits non-zero:
  1. device   nvidia-smi's name and power limit, torch and CUDA versions;
  2. build    every kernel of the path compiled from dsjax_torch/csrc;
  3. kernel   each kernel against its plain PyTorch version on the card at
              the serving shapes (T=501, B=8, H=1024), f32 and bf16, with
              max errors and CUDA-event median times of both;
  4. parity   the full-width 5x BiLSTM-1024 DeepSpeech2 (seeded weights of
              tests/golden_flagship.py) against tests/fixtures/golden_flagship.npz;
  5. serving  the port's HTTP server on 127.0.0.1 answering 8 concurrent
              /transcribe requests, one chunked long upload and a /stream
              session, checked against the direct forward + greedy decode.
The parity phases turn TF32 off (cuDNN convolutions and matmuls in full
float32); the serving phase runs PyTorch's defaults. The last two lines are
a JSON object of kernel results and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import http.client
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
T, B, H = 501, 8, 1024                      # 10 s utterances, max_batch 8, flagship width
TOLERANCE = {"float32": (2e-5, 1e-4), "bfloat16": (3e-2, 0.0)}   # (atol, rtol)
GOLDEN_TOL = (5e-6, 1e-4)
SR = 16000


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_time(fn, reps: int):
    """Median milliseconds of fn() over reps runs, each timed with CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernel(torch, np):
    """K1: dsjax/ops/lstm_pallas.py:_fwd_kernel -> dsjax_torch/csrc/lstm_fwd.cu."""
    from dsjax_torch.ops import lstm

    rng = np.random.default_rng(0)
    lengths = np.array([T, 1, 250, T, 37, 400, T - 2, 128])
    prefix = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]

        def dev(a, dt=dtype):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to("cuda", dt)

        xp = dev(rng.standard_normal((2, T, B, 4 * H)) * 0.3)
        w = dev(rng.standard_normal((2, 4 * H, H)) * 0.03)
        b = dev(rng.standard_normal((2, 4 * H)) * 0.1)
        h0 = dev(rng.standard_normal((2, B, H)) * 0.1)
        c0 = dev(rng.standard_normal((2, B, H)) * 0.1)
        cases = {"bidirectional, prefix mask": (dev(prefix, torch.float32), (False, True)),
                 "forward, suffix mask": (dev(prefix[::-1], torch.float32), (False, False))}
        atol, rtol = TOLERANCE[name]
        err = 0.0
        for case, (mask, reverse) in cases.items():
            out = lstm.lstm_scan(xp, mask, w, b, h0, c0, reverse)
            ref = lstm.lstm_scan_reference(xp, mask, w, b, h0, c0, reverse)
            torch.cuda.synchronize()
            for o, r, what in zip(out, ref, ("y", "h_T", "c_T")):
                check(bool(torch.isfinite(o.float()).all()), f"{name} {case}: {what} not finite")
                e = (o.float() - r.float()).abs()
                bound = atol + rtol * r.float().abs()
                check(bool((e <= bound).all()),
                      f"{name} {case}: {what} max err {e.max().item()} over atol {atol} rtol {rtol}")
                err = max(err, e.max().item())
        mask, reverse = cases["bidirectional, prefix mask"]
        k_ms = cuda_time(lambda: lstm.lstm_scan(xp, mask, w, b, h0, c0, reverse), 20)
        p_ms = cuda_time(lambda: lstm.lstm_scan_reference(xp, mask, w, b, h0, c0, reverse), 5)
        print(f"kernel lstm_fwd {name} T={T} B={B} H={H} 2 directions: max_abs_err {err!r} "
              f"(atol {atol}, rtol {rtol}); kernel {k_ms!r} ms, plain {p_ms!r} ms (median, CUDA events)")
        result[name] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms}
    return result


def phase_parity(torch, np):
    from dsjax_torch.config import SpectConfig
    from dsjax_torch.inference import ModelBundle
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.model.convert import from_reference_state_dict, infer_architecture
    from dsjax_torch.model.ds2 import DeepSpeech2
    from dsjax_torch.ops import lstm
    from tests.golden_flagship import flagship_input, flagship_state

    state = flagship_state()
    model_cfg, classes = infer_architecture(state)
    check((model_cfg.hidden_size, model_cfg.hidden_layers) == (1024, 5), "not the flagship")
    model = DeepSpeech2(classes, SpectConfig(), model_cfg)
    model.load_state_dict(from_reference_state_dict(state))
    bundle = ModelBundle(model, list(DEFAULT_LABELS), SpectConfig(), device="cuda")
    x, lengths = flagship_input()
    before = lstm.LAUNCHES
    probs, out_lens, carry = bundle.forward(x, lengths)
    torch.cuda.synchronize()
    launched = lstm.LAUNCHES - before
    check(launched == model_cfg.hidden_layers,
          f"{launched} lstm_fwd launches for {model_cfg.hidden_layers} layers")
    golden = np.load(os.path.join(ROOT, "tests", "fixtures", "golden_flagship.npz"))
    probs, out_lens = probs.cpu().numpy(), out_lens.cpu().numpy()
    check(np.array_equal(out_lens, golden["out_lens"]), f"out_lens {out_lens}")
    check(bool(np.isfinite(probs).all()), "probs not finite")
    atol, rtol = GOLDEN_TOL
    err = 0.0
    for i, n in enumerate(golden["out_lens"]):
        e = np.abs(probs[i, :n] - golden["probs"][i, :n])
        check(bool((e <= atol + rtol * np.abs(golden["probs"][i, :n])).all()),
              f"probs row {i}: max err {e.max()} over atol {atol} rtol {rtol}")
        err = max(err, float(e.max()))
    print(f"parity flagship 5x BiLSTM-1024 f32 probs {probs.shape} vs golden_flagship.npz: "
          f"max_abs_err {err!r} (atol {atol}, rtol {rtol}); out_lens {out_lens.tolist()}; "
          f"lstm_fwd launches {launched}")
    return state, model_cfg


def synth(rng, np, seconds):
    n = int(SR * seconds)
    t = np.arange(n) / SR
    f0, f1 = rng.uniform(120, 400), rng.uniform(600, 2400)
    y = (0.2 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(2 * np.pi * f1 * t)
         + 0.05 * rng.standard_normal(n))
    return y.astype(np.float32)


def multipart(y) -> tuple:
    from dsjax_torch.audio.io import save_wav

    buf = io.BytesIO()
    save_wav(buf, y, SR)
    boundary = "chipsmokeboundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"a.wav\"\r\nContent-Type: audio/wav\r\n\r\n").encode()
    body += buf.getvalue() + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def post(port, path, y):
    body, ctype = multipart(y)
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", path, body=body, headers={"Content-Type": ctype})
        r = conn.getresponse()
        payload = json.loads(r.read())
    finally:
        conn.close()
    return r.status, payload, (time.perf_counter() - t0) * 1000.0


def direct_transcripts(worker, ys, np):
    """The batch the server formed from ys, run straight through
    ModelBundle.forward + GreedyDecoder (same padding, same shapes)."""
    spects = [worker.extractor(y) for y in ys]
    max_t = ((max(s.shape[1] for s in spects) + 63) // 64) * 64
    inputs = np.zeros((len(ys), spects[0].shape[0], max_t), np.float32)
    lengths = np.ones((len(ys),), np.int32)
    for i, s in enumerate(spects):
        inputs[i, :, : s.shape[1]] = s
        lengths[i] = s.shape[1]
    probs, out_lens, _ = worker.bundle.forward(inputs, lengths)
    return [s[0] for s in worker.decoder.decode(probs, out_lens)[0]]


def direct_chunked(worker, y, chunk_s, np, torch):
    carry, outs = None, []
    for chunk in worker.extractor.chunks(y, chunk_s):
        spect = worker.extractor(chunk)[None]
        t_true = spect.shape[2]
        spect = np.pad(spect, ((0, 0), (0, 0), (0, (t_true + 63) // 64 * 64 - t_true)))
        probs, out_lens, carry = worker.bundle.forward(spect, [t_true], carry)
        outs.append(probs[:, : int(out_lens[0])])
    return worker.decoder.decode(torch.cat(outs, dim=1))[0][0][0]


def phase_serving(torch, np, state, model_cfg, gpu_name):
    from dsjax_torch.config import ServerConfig, SpectConfig, compose
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.model.convert import from_reference_state_dict, save_checkpoint
    from dsjax_torch.ops import lstm
    from dsjax_torch.server import serve, shutdown

    rng = np.random.default_rng(7)
    seconds = [round(float(s), 2) for s in rng.uniform(1.0, 10.0, 8)]
    ys = [synth(rng, np, s) for s in seconds]
    long_y = synth(rng, np, 25.0)
    stream_ys = [synth(rng, np, 1.0) for _ in range(3)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flagship.pt")
        save_checkpoint(path, from_reference_state_dict(state), model_cfg, SpectConfig(),
                        DEFAULT_LABELS)
        # the 8 concurrent requests must form one batch, so that the direct
        # forward below can rebuild it shape for shape: a long collection
        # window, closed early by the 8th request (max_batch)
        cfg = compose(ServerConfig, [f"model.model_path={path}", "host=127.0.0.1", "port=0",
                                     "device=cuda", "max_batch=8", "batch_timeout_ms=2000",
                                     "chunk_size_seconds=10", "warmup_seconds=10"])
        lstm.LAUNCHES = lstm.STEP_LAUNCHES = 0
        t0 = time.perf_counter()
        server, worker = serve(cfg)
        try:
            setup_s = time.perf_counter() - t0
            port = server.server_address[1]
            results = [None] * len(ys)

            def client(i):
                results[i] = post(port, "/transcribe", ys[i])

            threads = [threading.Thread(target=client, args=(i,)) for i in range(len(ys))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
                check(not t.is_alive(), "a /transcribe request hung")
            long_result = post(port, "/transcribe", long_y)
            stream = [post(port, f"/stream?session=smoke&final={int(i == 2)}", y)
                      for i, y in enumerate(stream_ys)]
            torch.cuda.synchronize()
            launches, step_launches = lstm.LAUNCHES, lstm.STEP_LAUNCHES

            for (status, payload, _), s in zip(results + [long_result], seconds + [25.0]):
                check(status == 200, f"/transcribe ({s} s) -> {status} {payload}")
                check(isinstance(payload["output"][0]["transcription"], str)
                      and payload["_meta"]["decoder"]["type"] == "greedy",
                      f"/transcribe result {payload}")
            for status, payload, _ in stream:
                check(status == 200 and isinstance(payload.get("transcription"), str),
                      f"/stream -> {status} {payload}")
            check(stream[-1][1]["final"] is True, "the final /stream chunk was not final")
            # one scan call per layer and forward: a warmup forward per
            # power-of-two batch size, the one batch of 8, each chunk of the
            # long upload and each /stream chunk
            warmups = cfg.max_batch.bit_length()
            chunks = sum(1 for c in worker.extractor.chunks(long_y, cfg.chunk_size_seconds)
                         if len(c))
            forwards = warmups + 1 + chunks + len(stream_ys)
            check(launches == forwards * model_cfg.hidden_layers,
                  f"{launches} lstm_fwd calls for {forwards} forwards of "
                  f"{model_cfg.hidden_layers} layers")

            want = direct_transcripts(worker, ys, np)
            got = [r[1]["output"][0]["transcription"] for r in results]
            check(got == want, f"/transcribe transcripts differ from the direct forward:\n"
                               f"{got}\n{want}")
            want_long = direct_chunked(worker, long_y, cfg.chunk_size_seconds, np, torch)
            check(long_result[1]["output"][0]["transcription"] == want_long,
                  "chunked /transcribe differs from the direct chunked forward")
        finally:
            shutdown(server, worker)
    lat = sorted(r[2] for r in results)
    print(f"serving on {gpu_name}: setup (load, warmup 1-8 x 10 s) {setup_s!r} s; "
          f"8 concurrent /transcribe of {seconds} s: p50 {statistics.median(lat)!r} ms, "
          f"max {lat[-1]!r} ms; chunked 25 s upload {long_result[2]!r} ms; /stream chunks "
          f"{[round(s[2], 3) for s in stream]} ms; transcripts equal the direct forward; "
          f"lstm_fwd calls {launches} ({forwards} forwards x {model_cfg.hidden_layers} "
          f"layers), {step_launches} step kernels")
    return launches, step_launches


def run(torch, np):
    from dsjax_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    gpu_name = torch.cuda.get_device_name(0)
    print(card)
    print(f"device: {gpu_name}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible")

    t0 = time.perf_counter()
    _build.build(force=True)
    _build.load_library()
    print(f"build: {[str(p.relative_to(ROOT)) for p in _build.sources()]} -> "
          f"{_build.LIB_PATH.relative_to(ROOT)} in {time.perf_counter() - t0!r} s")

    defaults = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print("parity phases: cudnn TF32 off, matmul TF32 off, float32 matmul precision 'highest'")
    kernel = phase_kernel(torch, np)
    state, model_cfg = phase_parity(torch, np)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = defaults[:2]
    torch.set_float32_matmul_precision(defaults[2])
    print(f"serving phase: PyTorch defaults (cudnn TF32 {defaults[0]}, matmul TF32 "
          f"{defaults[1]}, precision {defaults[2]!r})")
    launches, step_launches = phase_serving(torch, np, state, model_cfg, gpu_name)

    f32 = kernel["float32"]
    print(json.dumps({"kernels": [{
        "name": "lstm_fwd", "route": "cuda", "source": "dsjax_torch/csrc/lstm_fwd.cu",
        "replaces": "dsjax/ops/lstm_pallas.py:62", "launches": launches,
        "step_launches": step_launches,
        "max_abs_err": f32["max_abs_err"], "ms": f32["ms"], "plain_ms": f32["plain_ms"]}]}))
    return gpu_name


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "dsjax_torch")):
        print(f"chip_smoke: no dsjax_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    try:
        gpu_name = run(torch, np)
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": gpu_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
