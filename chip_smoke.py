#!/usr/bin/env python3
"""Drive dsjax_torch's serving, training and evaluation paths once on one
CUDA card and check them.

    python3 chip_smoke.py          # from the root of a checkout; needs one card

Phases, each printing what it measured; any failure exits non-zero:
  1. device   nvidia-smi's name and power limit, torch and CUDA versions;
  2. build    every kernel compiled from dsjax_torch/csrc;
  3. kernel   K1 (the LSTM forward) against its plain PyTorch version on the
              card at the serving shapes (T=501, B=8, H=1024), f32 and bf16,
              with max errors and CUDA-event median times of both;
  4. parity   the full-width 5x BiLSTM-1024 DeepSpeech2 (seeded weights of
              tests/golden_flagship.py) against tests/fixtures/golden_flagship.npz;
  5. serving  the port's HTTP server on 127.0.0.1 answering 8 concurrent
              /transcribe requests, one chunked long upload and a /stream
              session, checked against the direct forward + greedy decode;
  6. train kernels  K2 (the residual-saving forward) and K3 (the reverse
              scan) against their plain versions at the training shapes
              (T=512, B=64, H=1024, both directions, ragged lengths, a
              suffix mask, nonzero carry), f32 and bf16, with max errors
              and CUDA-event median times of both;
  7. gradients  the differentiated lstm_scan (K2 + K3) against autograd
              through the plain loop, both on the card;
  8. training  ``dsjax_torch.workflows.train`` on a synthetic corpus of
              10.23 s utterances (1024 STFT frames, 512 scan steps): the
              flagship in bf16 at B=64 for 2 epochs of 3 steps, with
              validation and checkpoints; exact K2/K3/K1 launch counts,
              finite losses, and the last checkpoint loaded as the server
              loads it giving the trainer's eval posteriors;
  9. step parity  one training step of a small model (H=256, 2 layers, f32)
              on the card against the same step on the CPU;
 10. top-k kernel  K6 against its plain version (a stable sort) at the beam
              pool's shapes (16, 3840) -> 128 and (20, 300) -> 10, at
              (64, 7680) -> 256, and on a tie-heavy pool: values and indices
              exactly equal; CUDA-event median times of both;
 11. beam kernel  K7 against the plain scan at (B, T, W, C) = (16, 500, 128,
              29) and (20, 500, 10, 29), log-softmax posteriors with ragged
              sizes including 0, 1 and T: backptr, emit, h1, h2 and the
              integer carry exactly equal, totals and the float carry within
              1e-5; a two-chunk K7 stream equal to the one-shot K7; times
              of K7, of the scan with K6 and of the plain scan;
 12. evaluation  ``workflows.evaluate`` of the flagship (seeded weights) on a
              synthetic corpus of 40 WAVs of 2-12 s, with the STFT on the
              card from int16 raw audio, batch 20: greedy, beam W=10 by the
              scan with K6, and beam W=10 with DSJAX_FUSED_BEAM=1 (K7); the
              two beam routes give identical transcripts, WER and CER; exact
              K1, K6 and K7 launch counts; the raw-audio forward's
              posteriors against the host-feature forward's;
 13. beam serving  the server with lm.decoder_type=beam: 8 concurrent
              /transcribe requests against DeviceBeamDecoder.decode on the
              same posteriors, a /stream session whose last transcript
              equals the one-shot beam decode of the same chunks, and a
              one-chunk session equal to /transcribe of the same audio.
The parity phases (3, 4, 6, 7, 9, 10, 11 and 12's posterior comparison)
turn TF32 off (cuDNN convolutions and matmuls in full float32); serving,
training and evaluation run PyTorch's defaults. The last two lines are a
JSON object of kernel results and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
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
TRAIN_T, TRAIN_B = 512, 64                   # 1024 frames after the conv stack, bench batch
TOLERANCE = {"float32": (2e-5, 1e-4), "bfloat16": (3e-2, 0.0)}   # (atol, rtol)
# the reverse scan carries dh through every step: f32 sum order only; in
# bf16 each step's dgates round to bf16 before the product with W_hh
BWD_TOLERANCE = {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 2e-2)}
GRAD_TOL = (1e-4, 1e-4)
# the trainer's step on the card against the CPU's, per parameter, times
# the parameter's largest gradient: cuDNN may take FFT or Winograd
# algorithms for the 41x11 and 21x11 convolutions, whose f32 error exceeds
# direct summation's, and BatchNorm's one-pass f32 variance magnifies the
# two devices' different sum orders (tests/test_torch_train.py); measured
# up to 1.4e-4 on an H100
STEP_TOL = 1e-3
GOLDEN_TOL = (5e-6, 1e-4)
SR = 16000
TOPK_SHAPES = [(16, 3840, 128), (20, 300, 10), (64, 7680, 256)]
BEAM_SHAPES = [(16, 500, 128, 29), (20, 500, 10, 29)]      # (B, T, W, C)
BEAM_TOL = 1e-5                 # totals and the float carry of K7 vs the scan
EVAL_UTTS, EVAL_BATCH, EVAL_WIDTH = 40, 20, 10
# the flagship's posteriors from int16 raw audio with the STFT on the card
# against host features of the same 16-bit WAVs: the STFT's rounding only
FEATURE_PATH_TOL = 1e-4


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


def reset_counts():
    """Every kernel's launch count to 0, before a path is driven."""
    from dsjax_torch.ops import beam, lstm, topk

    lstm.LAUNCHES = lstm.STEP_LAUNCHES = lstm.RESIDUAL_LAUNCHES = lstm.BWD_LAUNCHES = 0
    topk.LAUNCHES = beam.LAUNCHES = 0


def read_counts():
    from dsjax_torch.ops import beam, lstm, topk

    return {"lstm_fwd": lstm.LAUNCHES, "lstm_steps": lstm.STEP_LAUNCHES,
            "lstm_fwd_residuals": lstm.RESIDUAL_LAUNCHES, "lstm_bwd": lstm.BWD_LAUNCHES,
            "topk": topk.LAUNCHES, "beam_scan": beam.LAUNCHES}


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
        reset_counts()
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


def within(got, want, atol, rtol):
    """(max abs error, whether every element is within atol + rtol |want|)."""
    e = (got.float() - want.float()).abs()
    return e.max().item(), bool((e <= atol + rtol * want.float().abs()).all())


def phase_train_kernels(torch, np):
    """K2: lstm_pallas.py:_fwd_kernel (save_residuals) -> csrc/lstm_fwd.cu;
    K3: lstm_pallas.py:_bwd_kernel -> csrc/lstm_bwd.cu."""
    from dsjax_torch.ops import lstm

    rng = np.random.default_rng(1)
    lengths = rng.integers(1, TRAIN_T + 1, TRAIN_B)
    lengths[:3] = (TRAIN_T, 1, TRAIN_T - 1)
    prefix = (np.arange(TRAIN_T)[:, None] < lengths[None, :]).astype(np.float32)
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]

        def dev(a, dt=dtype):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to("cuda", dt)

        xp = dev(rng.standard_normal((2, TRAIN_T, TRAIN_B, 4 * H)) * 0.3)
        w = dev(rng.standard_normal((2, 4 * H, H)) * 0.03)
        b = dev(rng.standard_normal((2, 4 * H)) * 0.1)
        h0 = dev(rng.standard_normal((2, TRAIN_B, H)) * 0.1)
        c0 = dev(rng.standard_normal((2, TRAIN_B, H)) * 0.1)
        cot = [dev(rng.standard_normal(shape)) for shape in
               ((2, TRAIN_T, TRAIN_B, H), (2, TRAIN_B, H), (2, TRAIN_B, H))]
        cases = {"bidirectional, prefix mask": (dev(prefix, torch.float32), (False, True)),
                 "forward, suffix mask": (dev(prefix[::-1], torch.float32), (False, False))}
        err = {"fwd": 0.0, "bwd": 0.0}
        for case, (mask, reverse) in cases.items():
            out = lstm.lstm_scan_fwd(xp, mask, w, b, h0, c0, reverse, save_residuals=True)
            ref = lstm.lstm_scan_reference(xp, mask, w, b, h0, c0, reverse, save_residuals=True)
            torch.cuda.synchronize()
            atol, rtol = TOLERANCE[name]
            for o, r, what in zip(out, ref, ("y", "h_T", "c_T", "gates", "c_seq")):
                check(bool(torch.isfinite(o.float()).all()), f"K2 {name} {case}: {what} not finite")
                e, ok = within(o, r, atol, rtol)
                check(ok, f"K2 {name} {case}: {what} max err {e} over atol {atol} rtol {rtol}")
                err["fwd"] = max(err["fwd"], e)
            g_seq, c_seq = ref[3], ref[4]
            dout = lstm.lstm_scan_bwd(g_seq, mask, w, c0, c_seq, *cot, reverse)
            dref = lstm.lstm_scan_backward_reference(g_seq, mask, w, c0, c_seq, *cot, reverse)
            torch.cuda.synchronize()
            atol, rtol = BWD_TOLERANCE[name]
            for o, r, what in zip(dout, dref, ("dgates", "dh0", "dc0")):
                check(bool(torch.isfinite(o.float()).all()), f"K3 {name} {case}: {what} not finite")
                e, ok = within(o, r, atol, rtol)
                check(ok, f"K3 {name} {case}: {what} max err {e} over atol {atol} rtol {rtol}")
                err["bwd"] = max(err["bwd"], e)
        mask, reverse = cases["bidirectional, prefix mask"]
        _, _, _, g_seq, c_seq = lstm.lstm_scan_reference(xp, mask, w, b, h0, c0, reverse,
                                                         save_residuals=True)
        times = {
            "fwd": (cuda_time(lambda: lstm.lstm_scan_fwd(xp, mask, w, b, h0, c0, reverse,
                                                         save_residuals=True), 10),
                    cuda_time(lambda: lstm.lstm_scan_reference(
                        xp, mask, w, b, h0, c0, reverse, save_residuals=True), 3)),
            "bwd": (cuda_time(lambda: lstm.lstm_scan_bwd(g_seq, mask, w, c0, c_seq, *cot,
                                                         reverse), 10),
                    cuda_time(lambda: lstm.lstm_scan_backward_reference(
                        g_seq, mask, w, c0, c_seq, *cot, reverse), 3))}
        for key, label in (("fwd", "lstm_fwd_residuals (K2)"), ("bwd", "lstm_bwd (K3)")):
            tol = TOLERANCE[name] if key == "fwd" else BWD_TOLERANCE[name]
            print(f"kernel {label} {name} T={TRAIN_T} B={TRAIN_B} H={H} 2 directions: "
                  f"max_abs_err {err[key]!r} (atol {tol[0]}, rtol {tol[1]}); kernel "
                  f"{times[key][0]!r} ms, plain {times[key][1]!r} ms (median, CUDA events)")
            result[(key, name)] = {"max_abs_err": err[key], "ms": times[key][0],
                                   "plain_ms": times[key][1]}
    return result


def phase_gradients(torch, np):
    """The differentiated lstm_scan (K2 then K3, dW and db reduced by
    matmul) against autograd through lstm_scan_reference, on the card."""
    from dsjax_torch.ops import lstm

    t_dim, b_dim, h_dim = 64, 16, 256
    rng = np.random.default_rng(2)
    lengths = rng.integers(1, t_dim + 1, b_dim)
    lengths[:2] = (t_dim, 1)
    mask = torch.from_numpy((np.arange(t_dim)[:, None] < lengths[None, :])
                            .astype(np.float32)).cuda()
    shapes = ((2, t_dim, b_dim, 4 * h_dim), (2, 4 * h_dim, h_dim), (2, 4 * h_dim),
              (2, b_dim, h_dim), (2, b_dim, h_dim))
    scales = (0.3, 0.1, 0.1, 0.1, 0.1)
    inputs = [torch.from_numpy((rng.standard_normal(s) * k).astype(np.float32)).cuda()
              .requires_grad_(True) for s, k in zip(shapes, scales)]
    weights = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda()
               for s in ((2, t_dim, b_dim, h_dim), (2, b_dim, h_dim), (2, b_dim, h_dim))]
    counts = (lstm.RESIDUAL_LAUNCHES, lstm.BWD_LAUNCHES)
    out = lstm.lstm_scan(inputs[0], mask, *inputs[1:], (False, True))
    got = torch.autograd.grad(sum((o * wt).sum() for o, wt in zip(out, weights)), inputs)
    ref = lstm.lstm_scan_reference(inputs[0], mask, *inputs[1:], (False, True))
    want = torch.autograd.grad(sum((o * wt).sum() for o, wt in zip(ref, weights)), inputs)
    torch.cuda.synchronize()
    check((lstm.RESIDUAL_LAUNCHES - counts[0], lstm.BWD_LAUNCHES - counts[1]) == (1, 1),
          "the differentiated scan did not run K2 and K3 once each")
    errs = {}
    for name, g, w in zip(("dxp", "dW_hh", "db_hh", "dh0", "dc0"), got, want):
        e, ok = within(g, w, *GRAD_TOL)
        check(ok and w.abs().max().item() > 0,
              f"gradient {name}: max err {e} over atol {GRAD_TOL[0]} rtol {GRAD_TOL[1]}")
        errs[name] = e
    print(f"gradients of lstm_scan (K2 + K3) vs autograd through the plain loop, f32, "
          f"T={t_dim} B={b_dim} H={h_dim} 2 directions: max_abs_err {errs} "
          f"(atol {GRAD_TOL[0]}, rtol {GRAD_TOL[1]})")


TRAIN_SECONDS = 1023 * 160 / SR               # 1024 STFT frames, 512 scan steps
TRAIN_UTTS, VAL_UTTS, EPOCHS = 192, 16, 2


def phase_training(torch, np, gpu_name, card):
    from dsjax_torch.config import TrainConfig, compose
    from dsjax_torch.inference import load_model
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.ops import lstm
    from dsjax_torch.train.checkpoint import CheckpointHandler
    from dsjax_torch.train.loop import Trainer
    from dsjax_torch.workflows import _pipelines, train
    from tests.synthetic_manifest import write_manifest

    rng = np.random.default_rng(3)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        train_path = write_manifest(tmp, "train", [TRAIN_SECONDS] * TRAIN_UTTS, seed=4)
        val_path = write_manifest(tmp, "val", list(rng.uniform(3.0, TRAIN_SECONDS, VAL_UTTS)),
                                  seed=5)
        data_s = time.perf_counter() - t0
        ckpt = os.path.join(tmp, "ckpt")
        cfg = compose(TrainConfig, [
            f"data.train_path={train_path}", f"data.val_path={val_path}",
            "data.device_features=false", f"data.batch_size={TRAIN_B}", "data.num_workers=4",
            "trainer.precision=16", "trainer.device=cuda", "trainer.devices=1",
            f"trainer.max_epochs={EPOCHS}", "trainer.log_every_n_steps=1",
            f"trainer.log_dir={os.path.join(tmp, 'logs')}", f"checkpoint.dirpath={ckpt}"])
        reset_counts()
        t0 = time.perf_counter()
        state = train(cfg)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = {"lstm_fwd": lstm.LAUNCHES, "lstm_fwd_residuals": lstm.RESIDUAL_LAUNCHES,
                    "lstm_bwd": lstm.BWD_LAUNCHES}

        layers = cfg.model.hidden_layers
        steps = EPOCHS * -(-TRAIN_UTTS // TRAIN_B)
        val_forwards = EPOCHS * -(-VAL_UTTS // TRAIN_B)
        check(state.step == steps, f"{state.step} optimizer steps, expected {steps}")
        check(launches == {"lstm_fwd": layers * val_forwards,
                           "lstm_fwd_residuals": layers * steps, "lstm_bwd": layers * steps},
              f"launches {launches} for {steps} steps and {val_forwards} validation "
              f"forwards of {layers} layers")
        records = [json.loads(line) for line in open(os.path.join(tmp, "logs", "metrics.jsonl"))]
        losses = [r["loss"] for r in records if "loss" in r]
        check(len(losses) == steps and all(np.isfinite(losses)), f"losses {losses}")
        # a step's time: between the loss syncs of consecutive steps of an epoch
        step_ms = [1e3 * (b["time"] - a["time"]) for a, b in zip(records, records[1:])
                   if "loss" in a and "loss" in b and a["epoch"] == b["epoch"]]
        val = [r for r in records if "wer" in r and "mean_loss" in r]
        check(len(val) == EPOCHS and all(np.isfinite(r["mean_loss"]) for r in val),
              f"validation records {val}")

        handler = CheckpointHandler(ckpt)
        last = handler.path()
        size_gb = os.path.getsize(last) / 1e9
        trainer = Trainer(cfg, list(DEFAULT_LABELS))
        batch = next(iter(_pipelines(cfg, list(DEFAULT_LABELS))[1]))
        want, want_lens = trainer.eval_step(state, batch)
        bundle = load_model(last, precision=16, device="cuda")
        got, got_lens, _ = bundle.forward(batch.inputs, batch.input_lengths)
        torch.cuda.synchronize()
        check(torch.equal(got_lens, want_lens), "out_lens of the loaded checkpoint differ")
        load_err = (got - want).abs().max().item()
        check(load_err <= 1e-6, f"loaded checkpoint's posteriors differ by {load_err}")
    med = statistics.median(step_ms)
    print(f"training on {gpu_name} ({card}): flagship 5x BiLSTM-1024 bf16, B={TRAIN_B} x "
          f"{TRAIN_SECONDS} s (T=1024 frames, {TRAIN_T} scan steps), {steps} steps over "
          f"{EPOCHS} epochs: step median {med!r} ms of {sorted(step_ms)}, "
          f"{TRAIN_B / (med / 1e3)!r} utt/s; losses {losses}; validation wer/cer "
          f"{[(r['wer'], r['cer']) for r in val]}; launches {launches}; run {train_s!r} s "
          f"(corpus written in {data_s!r} s); last checkpoint {size_gb!r} GB, loaded with "
          f"load_model: posteriors max_abs_err {load_err!r} against the trainer's (<= 1e-6)")
    return launches


def phase_step_parity(torch, np):
    """One training step of a small model on the card and on the CPU, from
    the same weights and batch: every parameter's gradient and the loss."""
    from dsjax_torch.config import TrainConfig, compose
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.train.loop import Trainer
    from dsjax_torch.workflows import _pipelines
    from tests.synthetic_manifest import write_manifest

    with tempfile.TemporaryDirectory() as tmp:
        path = write_manifest(tmp, "small", [2.0, 3.1, 2.6, 1.4, 3.5, 2.2, 0.8, 2.9], seed=6)
        argv = [f"data.train_path={path}", f"data.val_path={path}", "data.batch_size=8",
                "data.device_features=false", "model.hidden_size=256", "model.hidden_layers=2",
                "trainer.precision=32", "trainer.devices=1"]
        cfgs = {dev: compose(TrainConfig, argv + [f"trainer.device={dev}"])
                for dev in ("cuda", "cpu")}
        batch = next(iter(_pipelines(cfgs["cpu"], list(DEFAULT_LABELS))[0]))
    results = {}
    for dev, cfg in cfgs.items():
        trainer = Trainer(cfg, list(DEFAULT_LABELS))
        state = trainer.init_state(seed=0)
        grads, loss = trainer.grad_step(state, batch)
        results[dev] = ({k: v.cpu() for k, v in grads.items()}, float(loss))
    rel = {}
    for name, want in results["cpu"][0].items():
        got = results["cuda"][0][name]
        scale = want.abs().max().item()
        e = (got - want).abs().max().item()
        check(e <= STEP_TOL * scale, f"step parity {name}: max err {e} over {STEP_TOL} x {scale}")
        rel[name] = e / max(scale, 1e-30)
    worst = max(rel.values())
    loss_err = abs(results["cuda"][1] - results["cpu"][1]) / abs(results["cpu"][1])
    check(loss_err <= 1e-5, f"step parity loss {results['cuda'][1]} vs {results['cpu'][1]}")
    print(f"step parity H=256 x 2 layers f32, B=8: cuda vs cpu gradients max err "
          f"{worst!r} x each parameter's largest gradient (<= {STEP_TOL}; by parameter "
          f"{ {k: float(f'{v:.3g}') for k, v in rel.items()} }); loss "
          f"{results['cuda'][1]!r} vs {results['cpu'][1]!r} (relative {loss_err!r})")


def phase_topk(torch, np):
    """K6: dsjax/ops/topk_pallas.py:_topk_kernel -> dsjax_torch/csrc/topk.cu."""
    from dsjax_torch.ops import topk

    rng = np.random.default_rng(10)
    result = {}
    cases = [(f"({b}, {n}) -> {k}", rng.standard_normal((b, n)).astype(np.float32), k)
             for b, n, k in TOPK_SHAPES]
    ties = rng.standard_normal((16, 3840)).astype(np.float32)
    ties[:, ::2] = np.float32(-1e30)                     # half the pool dead
    ties[:, 1::6] = np.float32(-3.25)                    # repeated scores
    ties[0] = np.float32(-1e30)
    cases.append(("tie-heavy (16, 3840) -> 128", ties, 128))
    for name, s_np, k in cases:
        s = torch.from_numpy(s_np).cuda()
        got = topk.topk(s, k)
        want = topk.topk_reference(s, k)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"K6 {name}: differs from the stable sort")
        k_ms = cuda_time(lambda: topk.topk(s, k), 50)
        p_ms = cuda_time(lambda: topk.topk_reference(s, k), 50)
        print(f"kernel topk {name}: values and indices equal to the plain version (max_abs_err "
              f"0.0); kernel {k_ms!r} ms, plain {p_ms!r} ms (median, CUDA events)")
        result[name] = {"max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms}
    return result


def beam_inputs(torch, np, b, t, c, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, c)) * 2.5
    logits[..., 0] += 2.0                                 # blank-heavy, as CTC output is
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    sizes = rng.integers(2, t + 1, b).astype(np.int32)
    sizes[:3] = (0, 1, t)
    return (torch.from_numpy(lp.astype(np.float32)).cuda(), torch.from_numpy(sizes).cuda())


def same_scan(torch, got, want, what):
    """K7's outputs against the scan's: integers exactly, floats to BEAM_TOL."""
    err = 0.0
    for name, g, w in (("backptr", got[0], want[0]), ("emit", got[1], want[1]),
                       ("h1", got[2][0], want[2][0]), ("h2", got[2][1], want[2][1]),
                       ("totals", got[3], want[3])) + tuple(
                           (f"carry[{i}]", g, w) for i, (g, w) in enumerate(zip(got[4], want[4]))):
        if g.dtype == torch.int32:
            check(torch.equal(g, w), f"{what}: {name} differs")
        else:
            e = (g - w).abs().max().item() if g.numel() else 0.0
            check(e <= BEAM_TOL, f"{what}: {name} max err {e} over {BEAM_TOL}")
            err = max(err, e)
    return err


def phase_beam_kernel(torch, np):
    """K7: dsjax/ops/beam_pallas.py:_beam_kernel -> dsjax_torch/csrc/beam_scan.cu."""
    from dsjax_torch.decode.beam_device import _beam_scan
    from dsjax_torch.ops import beam, topk

    result = {}
    for b, t, w, c in BEAM_SHAPES:
        what = f"B={b} T={t} W={w} C={c}"
        lp, sizes = beam_inputs(torch, np, b, t, c, seed=w)
        got = beam.fused_beam_scan(lp, sizes, w, 0)
        want = beam.fused_beam_scan_reference(lp, sizes, w, 0)
        torch.cuda.synchronize()
        err = same_scan(torch, got, want, f"K7 {what}")
        check(torch.equal(got[5][1], want[5][1]), f"K7 {what}: ranking differs")
        scan = _beam_scan(lp, sizes, w, 0)                # the scan route, with K6
        err = max(err, same_scan(torch, got, scan, f"K7 vs the K6 scan {what}"))
        # a stream of two chunks from the carry equals the one-shot scan
        half = t // 2
        first = beam.fused_beam_scan(lp[:, :half], sizes.clamp(max=half), w, 0)
        second = beam.fused_beam_scan(lp[:, half:], (sizes - half).clamp(min=0), w, 0,
                                      carry0=first[4])
        joined = (torch.cat([first[0], second[0]]), torch.cat([first[1], second[1]]),
                  (torch.cat([first[2][0], second[2][0]]), torch.cat([first[2][1], second[2][1]])),
                  second[3], second[4])
        torch.cuda.synchronize()
        err = max(err, same_scan(torch, joined, got, f"K7 two-chunk stream {what}"))
        k_ms = cuda_time(lambda: beam.fused_beam_scan(lp, sizes, w, 0), 10)
        s_ms = cuda_time(lambda: _beam_scan(lp, sizes, w, 0), 3)
        p_ms = cuda_time(lambda: beam.fused_beam_scan_reference(lp, sizes, w, 0), 3)
        print(f"kernel beam_scan {what}: backptr, emit, h1, h2, carry and ranking equal to the "
              f"plain scan and to the K6 scan, totals max_abs_err {err!r} (atol {BEAM_TOL}); "
              f"two-chunk stream equal; K7 {k_ms!r} ms, scan with K6 {s_ms!r} ms, plain scan "
              f"{p_ms!r} ms (median, CUDA events)")
        result[what] = {"max_abs_err": err, "ms": k_ms, "scan_k6_ms": s_ms, "plain_ms": p_ms}
    return result


def phase_feature_paths(torch, np, state, model_cfg, root):
    """The raw-audio forward (STFT on the card) against host features."""
    from dsjax_torch.audio.features import FeatureExtractor, pad_audio_for_device
    from dsjax_torch.audio.io import load_audio
    from dsjax_torch.config import SpectConfig
    from dsjax_torch.inference import ModelBundle
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.model.convert import from_reference_state_dict
    from dsjax_torch.model.ds2 import DeepSpeech2

    model = DeepSpeech2(len(DEFAULT_LABELS), SpectConfig(), model_cfg)
    model.load_state_dict(from_reference_state_dict(state))
    bundle = ModelBundle(model, list(DEFAULT_LABELS), SpectConfig(), device="cuda")
    ys = [load_audio(os.path.join(root, "wav", f"eval_{i}.wav")) for i in range(6)]
    items = [pad_audio_for_device(y, bundle.spect_cfg) for y in ys]
    n_valid = np.array([n for _, n in items], np.int32)
    t_max = int(n_valid.max())
    items = [pad_audio_for_device(y, bundle.spect_cfg, t_max) for y in ys]
    audio = np.stack([np.clip(np.rint(yp * 32768.0), -32768, 32767).astype(np.int16)
                      for yp, _ in items])
    extractor = FeatureExtractor(bundle.spect_cfg)
    feats = np.zeros((len(ys), extractor.n_freq, t_max), np.float32)
    for i, y in enumerate(ys):
        f = extractor(y)
        feats[i, :, : f.shape[1]] = f
    raw, raw_lens, _ = bundle.forward(audio, n_valid)
    host, host_lens, _ = bundle.forward(feats, n_valid)
    torch.cuda.synchronize()
    check(torch.equal(raw_lens, host_lens), "raw-audio and host-feature out_lens differ")
    err = max((raw[i, :n] - host[i, :n]).abs().max().item()
              for i, n in enumerate(raw_lens.tolist()))
    check(err <= FEATURE_PATH_TOL, f"raw-audio posteriors differ from host-feature ones by {err}")
    return err


def phase_evaluation(torch, np, state, model_cfg, gpu_name, full_fp32, defaults_back):
    from dsjax_torch.config import EvalConfig, SpectConfig, compose
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.model.convert import from_reference_state_dict, save_checkpoint
    from dsjax_torch.workflows import evaluate
    from tests.synthetic_manifest import write_manifest

    rng = np.random.default_rng(12)
    with tempfile.TemporaryDirectory() as tmp:
        seconds = [round(float(s), 2) for s in rng.uniform(2.0, 12.0, EVAL_UTTS)]
        manifest = write_manifest(tmp, "eval", seconds, seed=13)
        path = os.path.join(tmp, "flagship.pt")
        save_checkpoint(path, from_reference_state_dict(state), model_cfg, SpectConfig(),
                        DEFAULT_LABELS)
        full_fp32()
        feature_err = phase_feature_paths(torch, np, state, model_cfg, tmp)
        defaults_back()
        runs = {}
        for name, decoder, fused in (("greedy", "greedy", "0"), ("beam, scan with K6", "beam", "0"),
                                     ("beam, K7", "beam", "1")):
            os.environ["DSJAX_FUSED_BEAM"] = fused
            cfg = compose(EvalConfig, [f"model.model_path={path}", f"test_path={manifest}",
                                       f"batch_size={EVAL_BATCH}", "num_workers=4",
                                       "device=cuda", f"lm.decoder_type={decoder}",
                                       f"lm.beam_width={EVAL_WIDTH}"])
            out = io.StringIO()
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                wer, cer = evaluate(cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            lines = out.getvalue().splitlines()
            hyps = [line for line in lines if line.startswith("Hyp:")]
            summary = [line for line in lines if line.startswith("Test Summary")]
            check(len(hyps) == EVAL_UTTS and len(summary) == 1, f"evaluate ({name}) printed "
                  f"{len(hyps)} hypotheses and {len(summary)} summaries")
            runs[name] = dict(wer=wer, cer=cer, hyps=hyps, summary=summary[0].strip(),
                              counts=counts, wall=wall)
        os.environ.pop("DSJAX_FUSED_BEAM")
    layers, batches = model_cfg.hidden_layers, -(-EVAL_UTTS // EVAL_BATCH)
    for name, r in runs.items():
        c = r["counts"]
        check(c["lstm_fwd"] == layers * batches,
              f"evaluate ({name}): {c['lstm_fwd']} lstm_fwd launches for {batches} batches")
        check(np.isfinite(r["wer"]) and np.isfinite(r["cer"]), f"evaluate ({name}): {r}")
    steps = runs["greedy"]["counts"]["lstm_steps"] // layers      # output frames, all batches
    want = {"greedy": (0, 0), "beam, scan with K6": (steps + batches, 0),
            "beam, K7": (0, batches)}
    for name, (n_topk, n_beam) in want.items():
        c = runs[name]["counts"]
        check((c["topk"], c["beam_scan"]) == (n_topk, n_beam),
              f"evaluate ({name}): topk {c['topk']} and beam_scan {c['beam_scan']} launches, "
              f"expected {n_topk} and {n_beam} ({steps} frames in {batches} batches)")
    scan, fused = runs["beam, scan with K6"], runs["beam, K7"]
    check(scan["hyps"] == fused["hyps"], "the two beam routes' transcripts differ")
    check((scan["wer"], scan["cer"]) == (fused["wer"], fused["cer"]),
          f"the two beam routes' WER/CER differ: {scan['wer'], scan['cer']} vs "
          f"{fused['wer'], fused['cer']}")
    for name, r in runs.items():
        print(f"evaluation on {gpu_name}, flagship f32, {EVAL_UTTS} utterances of 2-12 s, batch "
              f"{EVAL_BATCH}, STFT on the card ({name}): {r['summary']!r}; wall {r['wall']!r} s; "
              f"launches {r['counts']}")
    print(f"evaluation: beam routes identical ({EVAL_UTTS} transcripts, WER {scan['wer']!r}, CER "
          f"{scan['cer']!r}); raw-audio vs host-feature posteriors max_abs_err {feature_err!r} "
          f"(<= {FEATURE_PATH_TOL}, TF32 off)")
    return runs


def phase_beam_serving(torch, np, state, model_cfg, gpu_name):
    from dsjax_torch.config import ServerConfig, SpectConfig, compose
    from dsjax_torch.decode.beam_device import DeviceBeamDecoder
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.model.convert import from_reference_state_dict, save_checkpoint
    from dsjax_torch.server import serve, shutdown

    rng = np.random.default_rng(14)
    seconds = [round(float(s), 2) for s in rng.uniform(1.0, 8.0, 8)]
    ys = [synth(rng, np, s) for s in seconds]
    stream_ys = [synth(rng, np, 1.0) for _ in range(3)]
    single_y = synth(rng, np, 2.5)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flagship.pt")
        save_checkpoint(path, from_reference_state_dict(state), model_cfg, SpectConfig(),
                        DEFAULT_LABELS)
        cfg = compose(ServerConfig, [f"model.model_path={path}", "host=127.0.0.1", "port=0",
                                     "device=cuda", "max_batch=8", "batch_timeout_ms=2000",
                                     "warmup_seconds=2", "lm.decoder_type=beam",
                                     f"lm.beam_width={EVAL_WIDTH}"])
        server, worker = serve(cfg)
        try:
            check(isinstance(worker.decoder, DeviceBeamDecoder), "the server's decoder is not "
                  "the device beam")
            port = server.server_address[1]
            chunks_seen = []
            decode_chunk = worker.decoder.decode_chunk

            def recording(probs, state=None):
                chunks_seen.append(probs.clone())
                return decode_chunk(probs, state)

            worker.decoder.decode_chunk = recording
            results = [None] * len(ys)

            def client(i):
                results[i] = post(port, "/transcribe", ys[i])

            threads = [threading.Thread(target=client, args=(i,)) for i in range(len(ys))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
                check(not t.is_alive(), "a beam /transcribe request hung")
            stream = [post(port, f"/stream?session=beam&final={int(i == 2)}", y)
                      for i, y in enumerate(stream_ys)]
            stream_chunks = list(chunks_seen)
            single = post(port, "/stream?session=one&final=1", single_y)
            single_ref = post(port, "/transcribe", single_y)
            for status, payload, _ in results + stream + [single, single_ref]:
                check(status == 200, f"beam server -> {status} {payload}")
            want = direct_transcripts(worker, ys, np)
            got = [r[1]["output"][0]["transcription"] for r in results]
            check(got == want, f"beam /transcribe differs from DeviceBeamDecoder.decode on the "
                               f"same posteriors:\n{got}\n{want}")
            one_shot = worker.decoder.decode(torch.cat(stream_chunks, dim=1))[0][0][0]
            check(stream[-1][1]["transcription"] == one_shot,
                  f"/stream beam transcript {stream[-1][1]['transcription']!r} differs from the "
                  f"one-shot beam decode of its chunks {one_shot!r}")
            check(single[1]["transcription"] == single_ref[1]["output"][0]["transcription"],
                  "a one-chunk beam /stream session differs from /transcribe")
        finally:
            shutdown(server, worker)
    lat = sorted(r[2] for r in results)
    print(f"beam serving on {gpu_name} (W={EVAL_WIDTH}): 8 concurrent /transcribe of {seconds} s: "
          f"p50 {statistics.median(lat)!r} ms, max {lat[-1]!r} ms, equal to "
          f"DeviceBeamDecoder.decode on the same posteriors; /stream chunks "
          f"{[round(s[2], 3) for s in stream]} ms, last transcript equal to the one-shot beam "
          f"decode of its {len(stream_chunks)} chunks; a one-chunk session equals /transcribe")


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

    def full_fp32():
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")

    def defaults_back():
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = defaults[:2]
        torch.set_float32_matmul_precision(defaults[2])

    full_fp32()
    print("parity phases: cudnn TF32 off, matmul TF32 off, float32 matmul precision 'highest'")
    kernel = phase_kernel(torch, np)
    state, model_cfg = phase_parity(torch, np)
    defaults_back()
    print(f"serving phase: PyTorch defaults (cudnn TF32 {defaults[0]}, matmul TF32 "
          f"{defaults[1]}, precision {defaults[2]!r})")
    launches, step_launches = phase_serving(torch, np, state, model_cfg, gpu_name)
    full_fp32()
    train_kernels = phase_train_kernels(torch, np)
    phase_gradients(torch, np)
    phase_step_parity(torch, np)
    defaults_back()
    print("training phase: PyTorch defaults")
    train_launches = phase_training(torch, np, gpu_name, card)
    full_fp32()
    topk_res = phase_topk(torch, np)
    beam_res = phase_beam_kernel(torch, np)
    defaults_back()
    print("evaluation and beam serving phases: PyTorch defaults (the posterior comparison with "
          "TF32 off)")
    eval_runs = phase_evaluation(torch, np, state, model_cfg, gpu_name, full_fp32, defaults_back)
    phase_beam_serving(torch, np, state, model_cfg, gpu_name)

    f32 = kernel["float32"]
    rows = [{"name": "lstm_fwd", "route": "cuda", "source": "dsjax_torch/csrc/lstm_fwd.cu",
             "replaces": "dsjax/ops/lstm_pallas.py:62", "launches": launches,
             "step_launches": step_launches, "launches_in_training": train_launches["lstm_fwd"],
             "launches_in_evaluation": eval_runs["greedy"]["counts"]["lstm_fwd"],
             "max_abs_err": f32["max_abs_err"], "ms": f32["ms"], "plain_ms": f32["plain_ms"]}]
    for key, name, source, replaces in (
            ("fwd", "lstm_fwd_residuals", "dsjax_torch/csrc/lstm_fwd.cu",
             "dsjax/ops/lstm_pallas.py:381"),
            ("bwd", "lstm_bwd", "dsjax_torch/csrc/lstm_bwd.cu",
             "dsjax/ops/lstm_pallas.py:225")):
        r32, r16 = train_kernels[(key, "float32")], train_kernels[(key, "bfloat16")]
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": train_launches[name], "max_abs_err": r32["max_abs_err"],
                     "ms": r32["ms"], "plain_ms": r32["plain_ms"],
                     "bf16_max_abs_err": r16["max_abs_err"], "bf16_ms": r16["ms"],
                     "bf16_plain_ms": r16["plain_ms"]})
    first_topk, first_beam = TOPK_SHAPES[0], BEAM_SHAPES[0]
    k6 = topk_res[f"({first_topk[0]}, {first_topk[1]}) -> {first_topk[2]}"]
    rows.append({"name": "topk", "route": "cuda", "source": "dsjax_torch/csrc/topk.cu",
                 "replaces": "dsjax/ops/topk_pallas.py:139",
                 "launches": eval_runs["beam, scan with K6"]["counts"]["topk"],
                 "max_abs_err": k6["max_abs_err"], "ms": k6["ms"], "plain_ms": k6["plain_ms"],
                 "shapes": topk_res})
    b, t, w, c = first_beam
    k7 = beam_res[f"B={b} T={t} W={w} C={c}"]
    rows.append({"name": "beam_scan", "route": "cuda", "source": "dsjax_torch/csrc/beam_scan.cu",
                 "replaces": "dsjax/ops/beam_pallas.py:121",
                 "launches": eval_runs["beam, K7"]["counts"]["beam_scan"],
                 "max_abs_err": k7["max_abs_err"], "ms": k7["ms"], "plain_ms": k7["plain_ms"],
                 "shapes": beam_res})
    print(json.dumps({"kernels": rows}))
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
