#!/usr/bin/env python3
"""Drive dsjax_torch's serving, training, evaluation and LM decoding paths
once on one CUDA card and check them.

    python3 chip_smoke.py          # from the root of a checkout; needs one card

Phases, each printing what it measured; any failure exits non-zero:
  1. device   nvidia-smi's name and power limit, torch and CUDA versions;
  2. build    every kernel compiled from dsjax_torch/csrc;
  3. kernel   K1 (the LSTM forward, one persistent cooperative launch a
              call) against its plain PyTorch version on the card at the
              serving shapes (T=501, B=8, H=1024), 2 directions and 1, f32
              and bf16, with max errors and CUDA-event median times of both,
              and cuDNN's, and its plan (units and CTAs; resident,
              streamed and register W_hh rows a CTA) and kernel as built
              under it (no local memory);
  4. parity   the full-width 5x BiLSTM-1024 DeepSpeech2 (seeded weights of
              tests/golden_flagship.py) against tests/fixtures/golden_flagship.npz;
  5. serving  the port's HTTP server on 127.0.0.1 answering 8 concurrent
              /transcribe requests, one chunked long upload and a /stream
              session, checked against the direct forward + greedy decode,
              with exact K1 launch counts (one a layer call);
  6. train kernels  K2 (the residual-saving forward) and K3 (the reverse
              scan) against their plain versions at the training shapes
              (T=512, B=64, H=1024, both directions, ragged lengths, a
              suffix mask, nonzero carry), f32 and bf16, with max errors
              and CUDA-event median times of both, and K2's and K3's step
              kernels as built (hidden units, registers and shared memory
              a CTA; K2 with no local memory);
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
 10. top-k kernel  K6 against its plain version (a stable sort of the
              total-order keys) at the beam pool's shapes (16, 3840) -> 128
              and (20, 300) -> 10, at (64, 7680) -> 256, on a tie-heavy pool
              and on a pool of signed zeros, subnormals, -inf and -1e30:
              values (bit for bit) and indices exactly equal; CUDA-event
              median times of both, and the kernel's own device time under
              torch.profiler;
 11. beam kernel  K7 (a CTA an utterance) against the plain scan at (B, T,
              W, C) = (16, 500, 128, 29), (20, 500, 10, 29) and an
              evaluation batch's (20, 577, 10, 29), and at W = 1, 11, 32 and
              33, log-softmax posteriors with ragged sizes
              including 0, 1 and T: backptr, emit, h1, h2 and the integer
              carry exactly equal, totals and the float carry within 1e-5; a
              two-chunk K7 stream equal to the one-shot K7; pools of signed
              zeros and exact ties (W = 4 and 40) bit for bit; times of K7,
              of the scan with K6 and of the plain scan. Then the backtrack
              kernel against _backtrack, exactly, on K7's and the scan
              route's outputs and a two-chunk stream's, with its time, its
              device time under torch.profiler and the plain loop's at the
              evaluation batch;
 12. evaluation  ``workflows.evaluate`` of the flagship (seeded weights) on a
              synthetic corpus of 40 WAVs of 2-12 s, with the STFT on the
              card from int16 raw audio, batch 20: greedy, beam W=10 by the
              scan with K6, and beam W=10 with DSJAX_FUSED_BEAM=1 (K7); the
              two beam routes give identical transcripts, WER and CER; exact
              K1, K6, K7 and backtrack launch counts (one backtrack a batch
              on either beam route); the raw-audio forward's posteriors
              against the host-feature forward's;
 13. beam serving  the server with lm.decoder_type=beam: 8 concurrent
              /transcribe requests against DeviceBeamDecoder.decode on the
              same posteriors, a /stream session whose last transcript
              equals the one-shot beam decode of the same chunks, and a
              one-chunk session equal to /transcribe of the same audio,
              with exact K1 launch counts;
 14. GRU kernel  K4 (the GRU forward, K1's persistent kernel with three
              gates) against its plain version at the serving shapes, 2
              directions and 1, prefix and suffix masks, f32 and bf16, with
              its plans and kernel as built, as phase 3;
 15. GRU train kernels  K4 with residuals and K5 (the GRU reverse scan) at
              T=512, B=64: ragged lengths, a prefix mask with a nonzero carry
              and a suffix mask with a zero one, f32 and bf16, and the step
              kernels of both as built (K4 with residuals' with no local
              memory);
 16. GRU gradients  the differentiated gru_scan against autograd through
              the plain loop;
 17. GRU parity  5 x BiGRU-1024 and 5 x GRU-1024 + Lookahead 20
              (tests/golden_gru.py) loaded from checkpoints, against
              tests/fixtures/golden_gru.npz;
 18. GRU serving  the server on the BiGRU checkpoint answering 8 concurrent
              /transcribe requests, and on the unidirectional checkpoint a
              /stream session of 1 s chunks equal to the direct chunked
              forward, with exact K4 launch counts;
 19. GRU training  phase 8 for 5 x BiGRU-1024 (one epoch of 3 steps), exact
              K4-with-residuals, K5 and K4 counts;
 20. K8  the matmul-only chain (one cooperative launch, W resident, the
              step product on wgmma) against its plain version at T=512,
              B=64, H=1024, bf16, with its plan and kernel as built (no
              local memory), its time beside its bound and beside a CUDA
              graph of the T torch.addmm calls (cuBLAS) that compute the
              same chain, then tools/torch_lstm_microbench.py's run with its
              K8 launches counted.
 21. LM  n-gram LM decoding with a seeded synthetic 3-gram over A-Z
              (tests/synthetic_lm.py: every word of 1-3 letters and longer
              ones to 20k words, 200k bigrams, 400k trigrams): the host
              library built with lm.cpp and beam.cpp; the ARPA converted to
              DSLMBIN2 by build_lm_binary and the device tables packed from
              both, equal bucket for bucket, with their bytes and build
              seconds; score_word_ln on the card over 4096 (word, 2-word
              context) samples within 1e-4 of ArpaLM; the LM-fused scan with
              K6 at (B, T, W, C) = (20, 577, 10, 29) and (16, 500, 32, 29),
              and pruned (cutoff_top_n 10), bit for bit against the same
              scan with the plain top-k (exactly T K6 launches a call), a
              two-chunk LM stream against the one-shot scan, their times, K6
              alone at the LM pools, and an LM decode under
              DSJAX_FUSED_BEAM=1 with no K7 launch; ``workflows.evaluate``
              of the flagship on phase 12's corpus with the LM (alpha 0.8,
              beta 0.3, W=10), on the device route (exact K1, K6, K7 = 0
              and backtrack counts) and the host beam (4 threads); the
              server with the LM: 8 concurrent /transcribe against
              DeviceBeamDecoder(lm_path=the binary).decode on the same
              posteriors, a /stream session against the one-shot LM decode
              of its chunks, and a /stream session on the host LM beam
              (greedy) against the direct chunked forward; then
              ``python -m dsjax_torch.search_lm_params`` on a 2 x 2 grid
              with the device beam and ``select_lm_params`` on its JSON.
 22. augmented training  BASELINE.json config #4 (5 x GRU-1024 + Lookahead 20):
              the device SpecAugment masks on the card at (B, F, T) =
              (64, 161, 1024) bit for bit against the CPU's from the same
              uniforms, the same for the same (seed, step) and others for the
              next step; ``workflows.train`` in bf16 at B=64 for one epoch
              of 2 steps on 10.23 s utterances with tempo/gain, noise
              (4 seeded noise WAVs at 8 and 16 kHz, shorter and longer than
              an utterance, noise_prob 1) and host SpecAugment (host
              features forced), then the same with the masks in the step
              (raw audio, spec_augment_device) under trainer.profile
              (steps 0 and 1: a Chrome trace of 2 annotated steps); exact
              K4-with-residuals, K5 and K4 counts (one direction a launch)
              and finite losses on both routes; then each of the three
              kernels at every (D, T, B) the two runs gave it (B=64, T
              after tempo), on seeded inputs with the run's own masks,
              against its plain version; the step median of each
              route, each step alone on a ready batch, the host work of one
              batch of 64 items by part (tempo, noise, STFT, host
              SpecAugment; serially through ``__getitem__``) and its ratio
              to the step, each loader thread's wall and CPU ms an item in
              the run; the phase's wall seconds.
 23. multi-device training  (a) ``workflows.train`` under torchrun's
              environment for one NCCL rank, in this process: phase 8's
              flagship, bf16, B=64, one epoch of 3 steps with validation and
              a checkpoint, between two plain runs of the same batches; the
              backend, world size and DDP wrapper, exact K2/K3/K1 counts,
              losses against the plain runs within the spread of the two
              plain runs, the checkpoint through load_model, the DDP step's
              ms beside the plain one's (metrics.jsonl medians); (b) ``python
              -m torch.distributed.run --standalone --nproc_per_node 1 -m
              dsjax_torch.train`` at phase 9's size trains and writes a
              checkpoint; (c) two gloo ranks sharing the card
              (tests/torch_ddp_worker.py; NCCL refuses two ranks on one
              device) at phase 9's size, B=4 a rank padded to 64 and 48
              frames, TF32 off, against one process on the union batch:
              losses, gradients, SGD updates, running stats (equal across the
              ranks) and the device SpecAugment masks.
 24. data-parallel inference  the flagship over the replicas of one
              ModelBundle in this process: every visible card when there are
              two or more, else two replicas sharing cuda:0 (``device=
              "cuda:0,cuda:0"``); an evaluation batch of 20 utterances of
              about 10 s (padded to a multiple of the replicas), int16 raw
              audio through the STFT on the card, TF32 off: the posteriors,
              row shards gathered onto cuda:0, against one card's within
              TOLERANCE, out_lens equal, 5 K1 launches a shard; on both
              forwards' posteriors the strings of greedy, the scan-route beam
              (T + 1 K6 launches), K7's route (one K7 and one backtrack) and
              the device-LM beam on phase 21's seeded 3-gram (as DSLMBIN2)
              identical; the server on the replicas answers 8 concurrent
              /transcribe requests with the one-card server's strings;
              ``workflows.evaluate`` (``python -m dsjax_torch.evaluate``'s
              entry point) over 24 WAVs gives the one-card WER, CER and
              hypotheses; CUDA-event and wall ms of one evaluation batch
              (forward and greedy or scan-route beam decode), one card and
              the replicas, medians of 5 after a warm-up, and K1 alone at a
              shard's rows and at the batch's. Phases 2-23 run their
              bundles, servers and evaluations on cuda:0 alone.
              ``tools/torch_data_parallel.py`` runs this phase by itself.
 25. resume  continuing a run from a checkpoint, as a dsjax run moved to
              the card continues: phase 8's flagship (bf16, B=64) trains 2
              of an epoch's 3 steps and saves mid-epoch (last_only,
              start_index, epoch) as F; F's state is mapped to dsjax's tree
              layout (tests/dsjax_layout.py, numpy) and written back by
              ``train.checkpoint.from_dsjax_state``, as
              tools/dsjax_checkpoint_to_torch.py writes a dsjax step, as F',
              which must equal F tensor for tensor (weights, running stats,
              Adam's step, exp_avg and exp_avg_sq, param groups, step, epoch,
              start_index); ``workflows.train`` with load_auto_checkpoint
              resumes F and F' to the end of the epoch: exact K2/K3 (the
              step left x 5 layers) and K1 (validation) counts, finite
              losses, the two runs' losses equal (else within the spread of
              a second resume of F); the seconds of the save, the restore
              onto the card, the mapping and the conversion.
 26. quick start  the README's quick start in the port: a synthetic archive
              in AN4's layout (tests/synthetic_corpora.py: 24 train, 8 val
              and 8 test utterances of 1-4 s from a seed, transcripts drawn
              from the label set, and a 0.5 s utterance in train and in
              test) prepared by ``python -m dsjax_torch.datasets.an4
              --target-dir an4_dataset --manifest-dir data/`` in a
              subprocess where jax, its companions and dsjax raise
              ImportError; the three manifests sorted by duration, the 0.5 s
              train utterance pruned and the test one kept, and ``python -m
              dsjax_torch.data.verify_manifest`` exiting 0 on them; in that
              directory ``workflows.train`` of TrainConfig composed from
              ``+configs=an4 trainer.max_epochs=1`` (the flagship, bf16,
              B=8; one epoch of 3 steps with validation and a checkpoint):
              exact K2/K3 (5 a step) and K1 (5 a validation batch) counts and
              finite losses; ``workflows.evaluate`` of the last checkpoint on
              the test manifest on cuda:0, greedy, batch 20: exact K1 counts
              (5 a batch), finite WER and CER, one hypothesis an utterance;
              the seconds of the preparation, the epoch and the evaluation.
Every kernel phase also times the kernel's library counterpart where one
PyTorch call computes the same function (torch.nn.LSTM or GRU on cuDNN in
f32, and for K2, K3, K4 with residuals and K5 in bf16 as well; torch.topk;
for K8 a CUDA graph of T torch.addmm calls; the port never calls them),
times K2 + K3 and K4 with residuals + K5 each as one call beside cuDNN's
forward plus backward under autograd (the backward rows' with_forward_ms
and with_forward_library_ms), and computes each kernel's bound: the larger
of its operations over the H100's peak for their type and its bytes over
3.35 TB/s. The parity phases (3, 4, 6, 7, 9, 10, 11, 12's posterior
comparison, 14-17, 20 and 24) turn TF32 off (cuDNN convolutions and matmuls in
full float32); serving, training and evaluation run PyTorch's defaults. The
last two lines are a JSON object of kernel results and {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import contextlib
import http.client
import io
import json
import os
import re
import shutil
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
# (B, T, W, C): the widest beam, evaluation's width, an evaluation batch
BEAM_SHAPES = [(16, 500, 128, 29), (20, 500, 10, 29), (20, 577, 10, 29)]
BEAM_EDGE_WIDTHS = (1, 11, 32, 33)  # the narrowest, past evaluation's, a warp's and past it
BEAM_TOL = 1e-5                 # totals and the float carry of K7 vs the scan
EVAL_UTTS, EVAL_BATCH, EVAL_WIDTH = 40, 20, 10
# the flagship's posteriors from int16 raw audio with the STFT on the card
# against host features of the same 16-bit WAVs: the STFT's rounding only
FEATURE_PATH_TOL = 1e-4
# phase 21: the LM weights, the space label, score_word_ln's samples and its
# tolerance against ArpaLM (tests/test_lm_device.py's), and the LM scans'
# (B, T, W, C, cutoff_top_n): an evaluation batch, K6's Pallas regime in
# dsjax (a pool of 960), and the evaluation batch pruned
LM_ALPHA, LM_BETA, LM_SPACE = 0.8, 0.3, 28
LM_SAMPLES, LM_SCORE_TOL = 4096, 1e-4
LM_SCAN_SHAPES = [(20, 577, 10, 29, 10 ** 9), (16, 500, 32, 29, 10 ** 9), (20, 577, 10, 29, 10)]


# H100 SXM at 700 W (NVIDIA's data sheet): HBM rate, and peak rates by type
# (float32 outside the tensor cores, bfloat16 on them)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


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


def persistent_plan(torch, mod, dtype, gates, n_dir, label):
    """K1's or K4's plan at the serving shapes and its kernel as built under
    it, printed: units, CTAs, resident, streamed and register W_hh rows a
    CTA, ring, registers, shared and local memory; no local memory allowed."""
    from dsjax_torch.ops import lstm

    name = str(dtype).split(".")[1]
    plan = lstm.scan_plan(n_dir, H, gates, dtype, B, torch.cuda.get_device_properties(0)
                          .multi_processor_count)
    attrs = mod.scan_kernel_attributes(dtype, plan)
    print(f"kernel {label} {name} {n_dir} direction(s) plan: {plan.units} units a CTA, "
          f"{plan.ctas} CTAs a direction, {plan.resident_rows} W_hh rows resident, "
          f"{plan.streamed_rows} streamed and {plan.register_rows} in registers a CTA (share "
          f"kept on the SM {attrs['resident_share']!r}), "
          f"{plan.stages} ring stages of {plan.chunk_bytes} B chunks; {attrs['registers']} "
          f"registers a thread, {attrs['static_smem_bytes'] + attrs['dynamic_smem_bytes']} bytes "
          f"of shared memory a CTA, {attrs['local_bytes']} bytes of local memory a thread "
          f"(cudaFuncGetAttributes)")
    check(attrs["local_bytes"] == 0, f"{label} {name}: the persistent kernel spills "
                                     f"{attrs['local_bytes']} bytes a thread")
    return {"plan": plan._asdict(), "kernel_attributes": attrs}


def phase_kernel(torch, np):
    """K1: dsjax/ops/lstm_pallas.py:_fwd_kernel -> dsjax_torch/csrc/lstm_fwd.cu
    (the persistent kernel of csrc/scan_persist.cuh), at the serving shapes,
    both directions and one."""
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
        mask, suffix = dev(prefix, torch.float32), dev(prefix[::-1], torch.float32)
        cases = {"bidirectional, prefix mask": (xp, mask, w, b, h0, c0, (False, True)),
                 "2 forward directions, suffix mask": (xp, suffix, w, b, h0, c0, (False, False)),
                 "1 direction, prefix mask": (xp[:1], mask, w[:1], b[:1], h0[:1], c0[:1],
                                              (False,))}
        atol, rtol = TOLERANCE[name]
        err = 0.0
        for case, args in cases.items():
            out = lstm.lstm_scan(*args)
            ref = lstm.lstm_scan_reference(*args)
            torch.cuda.synchronize()
            for o, r, what in zip(out, ref, ("y", "h_T", "c_T")):
                check(bool(torch.isfinite(o.float()).all()), f"{name} {case}: {what} not finite")
                e = (o.float() - r.float()).abs()
                bound = atol + rtol * r.float().abs()
                check(bool((e <= bound).all()),
                      f"{name} {case}: {what} max err {e.max().item()} over atol {atol} rtol {rtol}")
                err = max(err, e.max().item())
        args = cases["bidirectional, prefix mask"]
        k_ms = cuda_time(lambda: lstm.lstm_scan(*args), 20)
        k1_ms = cuda_time(lambda: lstm.lstm_scan(*cases["1 direction, prefix mask"]), 20)
        p_ms = cuda_time(lambda: lstm.lstm_scan_reference(*args), 5)
        out = lstm.lstm_scan(*args)
        bound_ms, bound_by = least_time(scan_flops(mask, 2, 4, H), nbytes(*args[:6], *out), name)
        lib_ms = library_times(torch, "LSTM", w, b, lengths, T, 20, train=False)[0]
        print(f"kernel lstm_fwd (K1) {name} T={T} B={B} H={H}: max_abs_err {err!r} (atol "
              f"{atol}, rtol {rtol}); 2 directions: kernel {k_ms!r} ms, plain {p_ms!r} ms, "
              f"torch.nn.LSTM (cuDNN) {lib_ms!r} ms; 1 direction: kernel {k1_ms!r} ms (median, "
              f"CUDA events); bound {bound_ms!r} ms ({bound_by})")
        result[name] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                        "one_direction_ms": k1_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": lib_ms,
                        "plans": {f"{n} directions": persistent_plan(torch, lstm, dtype, 4, n,
                                                                     "lstm_fwd (K1)")
                                  for n in (2, 1)}}
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
    bundle = ModelBundle(model, list(DEFAULT_LABELS), SpectConfig(), "cuda:0")
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
    from dsjax_torch.ops import beam, gru, lstm, mm_chain, topk

    for scan in (lstm, gru):
        scan.LAUNCHES = scan.STEPS = scan.RESIDUAL_LAUNCHES = scan.BWD_LAUNCHES = 0
    topk.LAUNCHES = beam.LAUNCHES = beam.BACKTRACK_LAUNCHES = mm_chain.LAUNCHES = 0


def read_counts():
    from dsjax_torch.ops import beam, gru, lstm, mm_chain, topk

    return {"lstm_fwd": lstm.LAUNCHES, "lstm_steps": lstm.STEPS,
            "lstm_fwd_residuals": lstm.RESIDUAL_LAUNCHES, "lstm_bwd": lstm.BWD_LAUNCHES,
            "gru_fwd": gru.LAUNCHES, "gru_steps": gru.STEPS,
            "gru_fwd_residuals": gru.RESIDUAL_LAUNCHES, "gru_bwd": gru.BWD_LAUNCHES,
            "topk": topk.LAUNCHES, "beam_scan": beam.LAUNCHES,
            "beam_backtrack": beam.BACKTRACK_LAUNCHES, "mm_chain": mm_chain.LAUNCHES}


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
                                     "device=cuda:0", "max_batch=8", "batch_timeout_ms=2000",
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
            launches, steps = lstm.LAUNCHES, lstm.STEPS

            for (status, payload, _), s in zip(results + [long_result], seconds + [25.0]):
                check(status == 200, f"/transcribe ({s} s) -> {status} {payload}")
                check(isinstance(payload["output"][0]["transcription"], str)
                      and payload["_meta"]["decoder"]["type"] == "greedy",
                      f"/transcribe result {payload}")
            for status, payload, _ in stream:
                check(status == 200 and isinstance(payload.get("transcription"), str),
                      f"/stream -> {status} {payload}")
            check(stream[-1][1]["final"] is True, "the final /stream chunk was not final")
            # one K1 launch per layer and forward: a warmup forward per
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
          f"lstm_fwd launches {launches} ({forwards} forwards x {model_cfg.hidden_layers} "
          f"layers, one a layer call), {steps} time steps scanned")
    return launches, steps


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def least_time(flops, n_bytes, dtype_name):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the operations over the peak rate of their type and the bytes (each
    input read once, each output written once) over the HBM rate."""
    ops_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def scan_flops(mask, n_dir, gates, n_h):
    """The recurrent product of a masked scan, 2 * (G * H) * H per direction
    and valid (t, b): what this run's lengths need (masked steps need none)."""
    return 2.0 * gates * n_h * n_h * float(mask.sum().item()) * n_dir


def cudnn_rnn(torch, kind, w_hh, b_hh, lengths, t_dim):
    """torch.nn.LSTM or GRU (cuDNN) with a scan's recurrent weights, random
    input weights, and a packed random input of the scan's lengths: the
    library call timed beside a scan kernel (it also does the input
    projection, so its time bounds the recurrence's from above). The port
    never calls it."""
    n_dir, _, n_h = w_hh.shape
    rnn = getattr(torch.nn, kind)(n_h, n_h, bidirectional=n_dir == 2).to("cuda", w_hh.dtype)
    with torch.no_grad():
        for d in range(n_dir):
            sfx = "_reverse" if d else ""
            getattr(rnn, f"weight_hh_l0{sfx}").copy_(w_hh[d])
            getattr(rnn, f"bias_hh_l0{sfx}").copy_(b_hh[d])
    x = torch.randn(t_dim, len(lengths), n_h, device="cuda", dtype=w_hh.dtype)
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        x, torch.as_tensor([max(int(n), 1) for n in lengths]), enforce_sorted=False)
    return rnn, packed


def library_times(torch, kind, w_hh, b_hh, lengths, t_dim, reps, train):
    """cuDNN's time for the scan: the forward without grad (inference), or
    (the training forward, its backward timed alone, the forward plus the
    backward under autograd as one figure)."""
    rnn, packed = cudnn_rnn(torch, kind, w_hh, b_hh, lengths, t_dim)
    if not train:
        with torch.no_grad():
            return cuda_time(lambda: rnn(packed), reps), None, None
    packed = torch.nn.utils.rnn.PackedSequence(packed.data.detach().requires_grad_(True),
                                               packed.batch_sizes, packed.sorted_indices,
                                               packed.unsorted_indices)
    wrt = [packed.data] + list(rnn.parameters())

    def fwd_bwd():
        out = rnn(packed)[0].data
        return torch.autograd.grad(out, wrt, torch.ones_like(out))

    fwd_ms = cuda_time(lambda: rnn(packed), reps)
    times = []
    for _ in range(reps):
        out = rnn(packed)[0].data
        grad = torch.ones_like(out)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.autograd.grad(out, wrt, grad)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return fwd_ms, statistics.median(times), cuda_time(fwd_bwd, reps)


def within(got, want, atol, rtol):
    """(max abs error, whether every element is within atol + rtol |want|)."""
    e = (got.float() - want.float()).abs()
    return e.max().item(), bool((e <= atol + rtol * want.float().abs()).all())


def step_kernel_attributes(fn, dtype, label):
    """A scan's step kernel as built (``fn``, an ops module's
    *_kernel_attributes), printed: units, registers, shared and local memory."""
    attrs = fn(dtype)
    print(f"kernel {label} {str(dtype).split('.')[1]} step kernel: {attrs['units']} hidden "
          f"units a CTA, {attrs['registers']} registers a thread, "
          f"{attrs['static_smem_bytes'] + attrs['dynamic_smem_bytes']} bytes of shared memory "
          f"a CTA, {attrs['local_bytes']} bytes of local memory a thread "
          f"(cudaFuncGetAttributes)")
    return attrs


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
        fwd_out = lstm.lstm_scan_reference(xp, mask, w, b, h0, c0, reverse, save_residuals=True)
        g_seq, c_seq = fwd_out[3], fwd_out[4]
        bwd_out = lstm.lstm_scan_backward_reference(g_seq, mask, w, c0, c_seq, *cot, reverse)
        flops = scan_flops(mask, 2, 4, H)
        bounds = {"fwd": least_time(flops, nbytes(xp, mask, w, b, h0, c0, *fwd_out), name),
                  "bwd": least_time(flops, nbytes(g_seq, mask, w, c0, c_seq, *cot, *bwd_out),
                                    name)}
        # cuDNN in the working dtype: the bf16 pair is held to cuDNN in bf16
        lib = library_times(torch, "LSTM", w, b, lengths, TRAIN_T, 5, train=True)

        def k2_k3():
            res = lstm.lstm_scan_fwd(xp, mask, w, b, h0, c0, reverse, save_residuals=True)
            return lstm.lstm_scan_bwd(res[3], mask, w, c0, res[4], *cot, reverse)

        pair_ms = cuda_time(k2_k3, 10)
        times = {
            "fwd": (cuda_time(lambda: lstm.lstm_scan_fwd(xp, mask, w, b, h0, c0, reverse,
                                                         save_residuals=True), 10),
                    cuda_time(lambda: lstm.lstm_scan_reference(
                        xp, mask, w, b, h0, c0, reverse, save_residuals=True), 3)),
            "bwd": (cuda_time(lambda: lstm.lstm_scan_bwd(g_seq, mask, w, c0, c_seq, *cot,
                                                         reverse), 10),
                    cuda_time(lambda: lstm.lstm_scan_backward_reference(
                        g_seq, mask, w, c0, c_seq, *cot, reverse), 3))}
        for i, (key, label) in enumerate((("fwd", "lstm_fwd_residuals (K2)"),
                                          ("bwd", "lstm_bwd (K3)"))):
            tol = TOLERANCE[name] if key == "fwd" else BWD_TOLERANCE[name]
            print(f"kernel {label} {name} T={TRAIN_T} B={TRAIN_B} H={H} 2 directions: "
                  f"max_abs_err {err[key]!r} (atol {tol[0]}, rtol {tol[1]}); kernel "
                  f"{times[key][0]!r} ms, plain {times[key][1]!r} ms, torch.nn.LSTM (cuDNN) "
                  f"{'training forward' if key == 'fwd' else 'backward'} {lib[i]!r} ms (median, "
                  f"CUDA events); bound {bounds[key][0]!r} ms ({bounds[key][1]})")
            result[(key, name)] = {"max_abs_err": err[key], "ms": times[key][0],
                                   "plain_ms": times[key][1], "bound_ms": bounds[key][0],
                                   "bound_by": bounds[key][1], "library_ms": lib[i]}
        print(f"kernels K2 + K3 {name} as one call: {pair_ms!r} ms; torch.nn.LSTM (cuDNN) "
              f"forward + backward under autograd {lib[2]!r} ms (median, CUDA events)")
        attrs = {key: step_kernel_attributes(fn, dtype, label) for key, fn, label in (
            ("fwd", lstm.fwd_kernel_attributes, "lstm_fwd_residuals (K2)"),
            ("bwd", lstm.bwd_kernel_attributes, "lstm_bwd (K3)"))}
        check(attrs["fwd"]["local_bytes"] == 0, f"K2 {name}: the step kernel spills "
                                                f"{attrs['fwd']['local_bytes']} bytes a thread")
        result[("fwd", name)].update(kernel_attributes=attrs["fwd"])
        result[("bwd", name)].update(with_forward_ms=pair_ms, with_forward_library_ms=lib[2],
                                     kernel_attributes=attrs["bwd"])
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


def phase_training(torch, np, gpu_name, card, rnn="lstm", epochs=EPOCHS):
    """``workflows.train`` of the flagship width (5 x BiLSTM-1024, or with
    ``rnn="gru"`` 5 x BiGRU-1024) in bf16 at B=64, with exact scan-kernel
    counts; returns {kernel: launches} of the run."""
    from dsjax_torch.config import TrainConfig, compose
    from dsjax_torch.inference import load_model
    from dsjax_torch.labels import DEFAULT_LABELS
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
            f"model.rnn_type={rnn}", f"trainer.max_epochs={epochs}",
            "trainer.log_every_n_steps=1", f"trainer.log_dir={os.path.join(tmp, 'logs')}",
            f"checkpoint.dirpath={ckpt}"])
        reset_counts()
        t0 = time.perf_counter()
        state = train(cfg)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = read_counts()
        launches = {k: counts[k] for k in (f"{rnn}_fwd", f"{rnn}_fwd_residuals", f"{rnn}_bwd")}

        layers = cfg.model.hidden_layers
        steps = epochs * -(-TRAIN_UTTS // TRAIN_B)
        val_forwards = epochs * -(-VAL_UTTS // TRAIN_B)
        check(state.step == steps, f"{state.step} optimizer steps, expected {steps}")
        check(launches == {f"{rnn}_fwd": layers * val_forwards,
                           f"{rnn}_fwd_residuals": layers * steps, f"{rnn}_bwd": layers * steps}
              and sum(counts.values()) == sum(launches.values()) + counts[f"{rnn}_steps"],
              f"launches {counts} for {steps} steps and {val_forwards} validation "
              f"forwards of {layers} {rnn} layers")
        records = [json.loads(line) for line in open(os.path.join(tmp, "logs", "metrics.jsonl"))]
        losses = [r["loss"] for r in records if "loss" in r]
        check(len(losses) == steps and all(np.isfinite(losses)), f"losses {losses}")
        # a step's time: between the loss syncs of consecutive steps of an epoch
        step_ms = [1e3 * (b["time"] - a["time"]) for a, b in zip(records, records[1:])
                   if "loss" in a and "loss" in b and a["epoch"] == b["epoch"]]
        val = [r for r in records if "wer" in r and "mean_loss" in r]
        check(len(val) == epochs and all(np.isfinite(r["mean_loss"]) for r in val),
              f"validation records {val}")

        handler = CheckpointHandler(ckpt)
        last = handler.path()
        size_gb = os.path.getsize(last) / 1e9
        trainer = Trainer(cfg, list(DEFAULT_LABELS))
        batch = next(iter(_pipelines(cfg, list(DEFAULT_LABELS))[1]))
        want, want_lens = trainer.eval_step(state, batch)
        bundle = load_model(last, precision=16, device="cuda:0")
        got, got_lens, _ = bundle.forward(batch.inputs, batch.input_lengths)
        torch.cuda.synchronize()
        check(torch.equal(got_lens, want_lens), "out_lens of the loaded checkpoint differ")
        load_err = (got - want).abs().max().item()
        check(load_err <= 1e-6, f"loaded checkpoint's posteriors differ by {load_err}")
    med = statistics.median(step_ms)
    print(f"training on {gpu_name} ({card}): 5x Bi{rnn.upper()}-1024 bf16, B={TRAIN_B} x "
          f"{TRAIN_SECONDS} s (T=1024 frames, {TRAIN_T} scan steps), {steps} steps over "
          f"{epochs} epochs: step median {med!r} ms of {sorted(step_ms)}, "
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


def kernel_device_ms(torch, fn, name, reps):
    """The mean device time in ms of the kernels whose name holds ``name``
    over ``reps`` calls of fn under torch.profiler: the kernel's own time,
    without the wrapper's host work. None (not measured) when the profiler
    sees none of them."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, count = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA or name not in evt.key:
            continue
        us += next((float(getattr(evt, a)) for a in ("self_device_time_total",
                                                     "self_cuda_time_total")
                    if hasattr(evt, a)), 0.0)
        count += evt.count
    return us / 1e3 / count if count and us > 0 else None


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
    # jax.lax.top_k's total order: -0.0 below +0.0, subnormals kept
    edge = np.array([0.0, -0.0, 5e-45, -5e-45, 1e-40, -1e-40, -np.inf, -1e30, 1.0, -1.0],
                    np.float32)
    cases.append(("signed zeros, subnormals, -inf, -1e30 (16, 3840) -> 128",
                  rng.choice(edge, (16, 3840)).astype(np.float32), 128))
    for name, s_np, k in cases:
        s = torch.from_numpy(s_np).cuda()
        got = topk.topk(s, k)
        want = topk.topk_reference(s, k)
        torch.cuda.synchronize()
        # values bit for bit: torch.equal takes -0.0 for +0.0
        check(torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
              and torch.equal(got[1], want[1]), f"K6 {name}: differs from the plain version")
        k_ms = cuda_time(lambda: topk.topk(s, k), 50)
        dev_ms = kernel_device_ms(torch, lambda: topk.topk(s, k), "topk_kernel", 50)
        p_ms = cuda_time(lambda: topk.topk_reference(s, k), 50)
        lib_ms = cuda_time(lambda: torch.topk(s, k, dim=-1), 50)
        # a selection reads each score at least once: one operation per score
        bound_ms, bound_by = least_time(s.numel(), nbytes(s, *got), "float32")
        print(f"kernel topk {name}: values (bit for bit) and indices equal to the plain version "
              f"(max_abs_err 0.0); kernel {k_ms!r} ms (wrapper call, CUDA events), {dev_ms!r} "
              f"ms (the kernel's device time, torch.profiler), plain {p_ms!r} ms, torch.topk "
              f"{lib_ms!r} ms (median, CUDA events; its tie order differs); bound {bound_ms!r} ms "
              f"({bound_by})")
        result[name] = {"max_abs_err": 0.0, "ms": k_ms, "device_ms": dev_ms, "plain_ms": p_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}
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


def beam_stream(beam, lp, sizes, w, half):
    """A two-chunk K7 stream, split at frame ``half``: the first chunk's and
    the second's outputs."""
    first = beam.fused_beam_scan(lp[:, :half], sizes.clamp(max=half), w, 0)
    second = beam.fused_beam_scan(lp[:, half:], (sizes - half).clamp(min=0), w, 0,
                                  carry0=first[4])
    return first, second


def check_beam(torch, beam, _beam_scan, lp, sizes, w, what):
    """K7 against its plain version and the K6 scan, and a two-chunk K7
    stream against the one-shot K7; returns (K7's outputs, max float err)."""
    got = beam.fused_beam_scan(lp, sizes, w, 0)
    want = beam.fused_beam_scan_reference(lp, sizes, w, 0)
    torch.cuda.synchronize()
    err = same_scan(torch, got, want, f"K7 {what}")
    check(torch.equal(got[5][1], want[5][1]), f"K7 {what}: ranking differs")
    scan = _beam_scan(lp, sizes, w, 0)                    # the scan route, with K6
    err = max(err, same_scan(torch, got, scan, f"K7 vs the K6 scan {what}"))
    first, second = beam_stream(beam, lp, sizes, w, lp.shape[1] // 2)
    joined = (torch.cat([first[0], second[0]]), torch.cat([first[1], second[1]]),
              (torch.cat([first[2][0], second[2][0]]), torch.cat([first[2][1], second[2][1]])),
              second[3], second[4])
    torch.cuda.synchronize()
    err = max(err, same_scan(torch, joined, got, f"K7 two-chunk stream {what}"))
    return got, err


def signed_zero_problem(torch, np, b, t, c, w, seed):
    """Posteriors of log-probs 0.0, -0.0, -1 and -2 only (blank 0), and a
    carry whose live slots hold p_b = -0.0 with distinct last chars (slot
    q's is q + 1): in the first frame every extend scores +0.0 but slot 0's
    by its last char, -0.0, first in pool order, which K7's float order
    takes first among the ties and K6's total order after every +0.0
    (tests/test_torch_cuda.py builds the same)."""
    rng = np.random.default_rng(seed)
    lp = rng.choice(np.array([0.0, -0.0, -1.0, -2.0], np.float32), (b, t, c))
    lp[:, 0, 0] = -1.0
    lp[:, 0, 1:] = rng.choice(np.array([0.0, -0.0], np.float32), (b, c - 1))
    lp[:, 0, 1] = -0.0
    sizes = np.full(b, t, np.int32)
    sizes[0] = max(1, t - 1)
    live = min(w, c - 1)
    slot = np.arange(w, dtype=np.int32)
    sentinel = -(slot + 2)
    p_b = np.full((b, w), -1e30, np.float32)
    p_b[:, :live] = -0.0
    last = np.where(slot < live, slot % (c - 1) + 1, -1)
    h1 = np.where(slot < live, 7 * slot + 11, sentinel)
    h2 = np.where(slot < live, 13 * slot + 5, sentinel)
    ph1 = np.where(slot < live, h1 + 100003, sentinel)
    ph2 = np.where(slot < live, h2 + 100019, sentinel)
    carry = (p_b, np.full((b, w), -1e30, np.float32)) + tuple(
        np.ascontiguousarray(np.broadcast_to(a.astype(np.int32), (b, w)))
        for a in (last, h1, h2, ph1, ph2))
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    return cuda(lp), cuda(sizes), tuple(cuda(a) for a in carry)


def phase_beam_kernel(torch, np):
    """K7: dsjax/ops/beam_pallas.py:_beam_kernel -> dsjax_torch/csrc/beam_scan.cu."""
    from dsjax_torch.decode.beam_device import _beam_scan
    from dsjax_torch.ops import beam, topk

    result = {}
    for b, t, w, c in BEAM_SHAPES:
        what = f"B={b} T={t} W={w} C={c}"
        lp, sizes = beam_inputs(torch, np, b, t, c, seed=w)
        got, err = check_beam(torch, beam, _beam_scan, lp, sizes, w, what)
        # one operation per (frame, beam, class) candidate of the valid frames
        flops = float(sizes.sum().item()) * w * c
        bound_ms, bound_by = least_time(flops, nbytes(lp, sizes, got[0], got[1], *got[2],
                                                      got[3], *got[4], *got[5]), "float32")
        k_ms = cuda_time(lambda: beam.fused_beam_scan(lp, sizes, w, 0), 10)
        s_ms = cuda_time(lambda: _beam_scan(lp, sizes, w, 0), 3)
        p_ms = cuda_time(lambda: beam.fused_beam_scan_reference(lp, sizes, w, 0), 3)
        print(f"kernel beam_scan {what}: backptr, emit, h1, h2, carry and ranking equal to "
              f"the plain scan and to the K6 scan, totals max_abs_err {err!r} (atol "
              f"{BEAM_TOL}); two-chunk stream equal; K7 {k_ms!r} ms, scan with K6 "
              f"{s_ms!r} ms, plain scan {p_ms!r} ms (median, CUDA events); bound "
              f"{bound_ms!r} ms ({bound_by})")
        result[what] = {"max_abs_err": err, "ms": k_ms, "scan_k6_ms": s_ms, "plain_ms": p_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    for w in BEAM_EDGE_WIDTHS:
        what = f"B=8 T=120 W={w} C=29"
        lp, sizes = beam_inputs(torch, np, 8, 120, 29, seed=w)
        _, err = check_beam(torch, beam, _beam_scan, lp, sizes, w, what)
        k_ms = cuda_time(lambda: beam.fused_beam_scan(lp, sizes, w, 0), 10)
        print(f"kernel beam_scan {what}: equal to the plain scan and to the K6 scan, totals "
              f"max_abs_err {err!r}; two-chunk stream equal; K7 {k_ms!r} ms")
        result[what] = {"max_abs_err": err, "ms": k_ms}
    for w in (4, 40):
        what = f"signed zeros B=3 T=6 W={w} C=6"
        lp, sizes, carry = signed_zero_problem(torch, np, 3, 6, 6, w, seed=w)
        got = beam.fused_beam_scan(lp, sizes, w, 0, carry0=carry)
        want = beam.fused_beam_scan_reference(lp, sizes, w, 0, carry0=carry)
        lax_order = _beam_scan(lp, sizes, w, 0, carry0=carry, top_k=topk.topk_reference)
        torch.cuda.synchronize()
        check(not torch.equal(want[1], lax_order[1]), f"K7 {what}: the pool no longer ties "
                                                      f"-0.0 with +0.0")
        ints = (got[0], got[1], *got[2], got[5][1]) + got[4][2:]
        ints_want = (want[0], want[1], *want[2], want[5][1]) + want[4][2:]
        floats = (got[3], got[5][0]) + got[4][:2]
        floats_want = (want[3], want[5][0]) + want[4][:2]
        check(all(torch.equal(g, r) for g, r in zip(ints, ints_want)) and
              all(torch.equal(g.view(torch.int32), r.view(torch.int32))
                  for g, r in zip(floats, floats_want)),
              f"K7 {what}: differs from the plain version")
        print(f"kernel beam_scan {what}: every output bit for bit equal to the plain version "
              f"(float order: -0.0 ties +0.0), whose emits differ from a total-order selection")
        result[what] = {"max_abs_err": 0.0}
    return result


def phase_backtrack(torch, np):
    """The backtrack kernel (csrc/beam_scan.cu) against _backtrack on K7's
    and the scan route's outputs and a two-chunk stream's, timed at an
    evaluation batch's shape (T=577, B=20, W=10) following the best beam,
    as evaluate does."""
    from dsjax_torch.decode.beam_device import _backtrack, _beam_scan
    from dsjax_torch.ops import beam, topk

    b, t, w, c = BEAM_SHAPES[2]
    lp, sizes = beam_inputs(torch, np, b, t, c, seed=w)
    k7 = beam.fused_beam_scan(lp, sizes, w, 0)
    scan = _beam_scan(lp, sizes, w, 0)
    _, second = beam_stream(beam, lp, sizes, 40, t // 2)
    every = lambda n: torch.arange(n, dtype=torch.int32, device="cuda")[None].expand(b, -1)
    best = k7[5][1][:, :1]
    cases = (("K7 route, best beam", k7[0], k7[1], best),
             ("K7 route, every beam ranked", k7[0], k7[1], k7[5][1]),
             ("scan route, K6's best beam", scan[0], scan[1], topk.topk(scan[3], 1)[1]),
             ("second chunk of a W=40 stream, every slot", second[0], second[1], every(40)))
    for name, bp, em, order in cases:
        before = beam.BACKTRACK_LAUNCHES
        chars, start = beam.backtrack(bp, em, order)
        want = _backtrack(bp, em, order)
        torch.cuda.synchronize()
        check(beam.BACKTRACK_LAUNCHES == before + 1, f"backtrack {name}: launches")
        check(torch.equal(chars, want[0]) and torch.equal(start, want[1]),
              f"backtrack {name}: differs from _backtrack")
    fn = lambda: beam.backtrack(k7[0], k7[1], best)
    k_ms = cuda_time(fn, 20)
    dev_ms = kernel_device_ms(torch, fn, "backtrack_kernel", 20)
    p_ms = cuda_time(lambda: _backtrack(k7[0], k7[1], best), 5)
    chars, start = fn()
    # the T x B x K chased (parent, char) pairs, the slots and the outputs
    bound_ms, bound_by = least_time(float(t * b), t * b * 8 + nbytes(best, chars, start),
                                    "float32")
    print(f"kernel beam_backtrack: equal to _backtrack on {len(cases)} cases "
          f"({[n for n, *_ in cases]}); T={t} B={b} W={w} K=1: kernel {k_ms!r} ms (wrapper "
          f"call, CUDA events), {dev_ms!r} ms "
          f"(the kernel's device time, torch.profiler), plain {p_ms!r} ms; bound {bound_ms!r} ms "
          f"({bound_by})")
    return {"max_abs_err": 0.0, "ms": k_ms, "device_ms": dev_ms, "plain_ms": p_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": {"T": t, "B": b, "W": w, "K": 1}}


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
    bundle = ModelBundle(model, list(DEFAULT_LABELS), SpectConfig(), "cuda:0")
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


def eval_corpus(np, root):
    """Phase 12's corpus: EVAL_UTTS synthetic WAVs of 2-12 s under root;
    returns the manifest's path."""
    from tests.synthetic_manifest import write_manifest

    rng = np.random.default_rng(12)
    seconds = [round(float(s), 2) for s in rng.uniform(2.0, 12.0, EVAL_UTTS)]
    return write_manifest(root, "eval", seconds, seed=13)


def phase_evaluation(torch, np, state, model_cfg, gpu_name, full_fp32, defaults_back):
    from dsjax_torch.config import EvalConfig, SpectConfig, compose
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.model.convert import from_reference_state_dict, save_checkpoint
    from dsjax_torch.workflows import evaluate

    with tempfile.TemporaryDirectory() as tmp:
        manifest = eval_corpus(np, tmp)
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
                                       "device=cuda:0", f"lm.decoder_type={decoder}",
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
    # K6 a frame and a ranking a batch on the scan route, K7 a batch on the
    # fused one; one backtrack a batch on either beam route
    want = {"greedy": (0, 0, 0), "beam, scan with K6": (steps + batches, 0, batches),
            "beam, K7": (0, batches, batches)}
    for name, (n_topk, n_beam, n_back) in want.items():
        c = runs[name]["counts"]
        check((c["topk"], c["beam_scan"], c["beam_backtrack"]) == (n_topk, n_beam, n_back),
              f"evaluate ({name}): topk {c['topk']}, beam_scan {c['beam_scan']} and "
              f"beam_backtrack {c['beam_backtrack']} launches, expected {n_topk}, {n_beam} and "
              f"{n_back} ({steps} frames in {batches} batches)")
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
                                     "device=cuda:0", "max_batch=8", "batch_timeout_ms=2000",
                                     "warmup_seconds=2", "lm.decoder_type=beam",
                                     f"lm.beam_width={EVAL_WIDTH}"])
        reset_counts()
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
    # one K1 launch per layer and forward: a warmup forward per power-of-two
    # batch size, the batch of 8 and its direct rebuild, each /stream chunk,
    # the one-chunk session and its /transcribe
    torch.cuda.synchronize()
    counts = read_counts()
    forwards = cfg.max_batch.bit_length() + 2 + len(stream_ys) + 2
    check(counts["lstm_fwd"] == forwards * model_cfg.hidden_layers,
          f"beam serving: {counts['lstm_fwd']} lstm_fwd launches for {forwards} forwards of "
          f"{model_cfg.hidden_layers} layers")
    lat = sorted(r[2] for r in results)
    print(f"beam serving on {gpu_name} (W={EVAL_WIDTH}): 8 concurrent /transcribe of {seconds} s: "
          f"p50 {statistics.median(lat)!r} ms, max {lat[-1]!r} ms, equal to "
          f"DeviceBeamDecoder.decode on the same posteriors; /stream chunks "
          f"{[round(s[2], 3) for s in stream]} ms, last transcript equal to the one-shot beam "
          f"decode of its {len(stream_chunks)} chunks; a one-chunk session equals /transcribe; "
          f"lstm_fwd launches {counts['lstm_fwd']} ({forwards} forwards x "
          f"{model_cfg.hidden_layers} layers, one a layer call)")


def gru_inputs(torch, np, rng, t_dim, b_dim, dtype):
    def dev(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to("cuda", dt)

    return (dev(rng.standard_normal((2, t_dim, b_dim, 3 * H)) * 0.3),
            dev(rng.standard_normal((2, 3 * H, H)) * 0.03),
            dev(rng.standard_normal((2, 3 * H)) * 0.1),
            dev(rng.standard_normal((2, b_dim, H)) * 0.1), dev)


def check_all(torch, out, ref, tol, what):
    err = 0.0
    for i, (o, r) in enumerate(zip(out, ref)):
        check(bool(torch.isfinite(o.float()).all()), f"{what}: output {i} not finite")
        e, ok = within(o, r, *tol)
        check(ok, f"{what}: output {i} max err {e} over atol {tol[0]} rtol {tol[1]}")
        err = max(err, e)
    return err


def phase_gru_kernel(torch, np):
    """K4: dsjax/ops/gru_pallas.py:_fwd_kernel -> dsjax_torch/csrc/gru_fwd.cu, at
    the serving shapes (T=501, B=8, H=1024), both directions and one."""
    from dsjax_torch.ops import gru

    rng = np.random.default_rng(20)
    lengths = np.array([T, 1, 250, T, 37, 400, T - 2, 0])
    prefix = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        xp, w, b, h0, dev = gru_inputs(torch, np, rng, T, B, dtype)
        mask, suffix = dev(prefix, torch.float32), dev(prefix[::-1], torch.float32)
        zero = torch.zeros_like(h0[:1])
        cases = {"2 directions, prefix mask, nonzero carry": (xp, mask, w, b, h0, (False, True)),
                 "1 direction, suffix mask, zero carry": (xp[:1], suffix, w[:1], b[:1], zero,
                                                         (False,)),
                 "1 direction, prefix mask, nonzero carry": (xp[:1], mask, w[:1], b[:1], h0[:1],
                                                            (False,))}
        err = 0.0
        for case, args in cases.items():
            out = gru.gru_scan(*args)
            ref = gru.gru_scan_reference(*args)
            torch.cuda.synchronize()
            err = max(err, check_all(torch, out, ref, TOLERANCE[name], f"K4 {name} {case}"))
        args = cases["2 directions, prefix mask, nonzero carry"]
        k_ms = cuda_time(lambda: gru.gru_scan(*args), 20)
        k1_ms = cuda_time(lambda: gru.gru_scan(*cases["1 direction, prefix mask, nonzero carry"]),
                          20)
        p_ms = cuda_time(lambda: gru.gru_scan_reference(*args), 5)
        bound_ms, bound_by = least_time(scan_flops(mask, 2, 3, H),
                                        nbytes(*args[:5], *gru.gru_scan(*args)), name)
        lib_ms = library_times(torch, "GRU", w, b, lengths, T, 20, train=False)[0]
        print(f"kernel gru_fwd (K4) {name} T={T} B={B} H={H}: max_abs_err {err!r} (atol "
              f"{TOLERANCE[name][0]}, rtol {TOLERANCE[name][1]}); 2 directions: kernel {k_ms!r} "
              f"ms, plain {p_ms!r} ms, torch.nn.GRU (cuDNN) {lib_ms!r} ms; 1 direction: kernel "
              f"{k1_ms!r} ms (median, CUDA events); bound {bound_ms!r} ms ({bound_by})")
        result[name] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                        "one_direction_ms": k1_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": lib_ms,
                        "plans": {f"{n} directions": persistent_plan(torch, gru, dtype, 3, n,
                                                                     "gru_fwd (K4)")
                                  for n in (2, 1)}}
    return result


def phase_gru_train_kernels(torch, np):
    """K4 with residuals: gru_pallas.py:_fwd_kernel (save_residuals) -> csrc/gru_fwd.cu;
    K5: gru_pallas.py:_bwd_kernel -> csrc/gru_bwd.cu, at the training shapes."""
    from dsjax_torch.ops import gru
    from dsjax_torch.ops.lstm import _carried_h_prev

    rng = np.random.default_rng(21)
    lengths = rng.integers(1, TRAIN_T + 1, TRAIN_B)
    lengths[:4] = (TRAIN_T, 1, TRAIN_T - 1, 0)
    prefix = (np.arange(TRAIN_T)[:, None] < lengths[None, :]).astype(np.float32)
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        xp, w, b, h0, dev = gru_inputs(torch, np, rng, TRAIN_T, TRAIN_B, dtype)
        dy, dh_t = dev(rng.standard_normal((2, TRAIN_T, TRAIN_B, H))), dev(
            rng.standard_normal((2, TRAIN_B, H)))
        mask = dev(prefix, torch.float32)
        cases = {"2 directions, prefix mask, nonzero carry": (xp, mask, w, b, h0, (False, True)),
                 "1 direction, suffix mask, zero carry": (
                     xp[:1], dev(prefix[::-1], torch.float32), w[:1], b[:1],
                     torch.zeros_like(h0[:1]), (False,))}
        err = {"fwd": 0.0, "bwd": 0.0}
        for case, args in cases.items():
            out = gru.gru_scan_fwd(*args, save_residuals=True)
            ref = gru.gru_scan_reference(*args, save_residuals=True)
            torch.cuda.synchronize()
            err["fwd"] = max(err["fwd"], check_all(torch, out, ref, TOLERANCE[name],
                                                   f"K4 residuals {name} {case}"))
            n_dir, reverse = args[0].shape[0], args[5]
            h_prev = _carried_h_prev(ref[0], args[1], args[4], reverse)
            bwd_args = (ref[2], args[1], args[2], h_prev, dy[:n_dir], dh_t[:n_dir], reverse)
            dout = gru.gru_scan_bwd(*bwd_args)
            dref = gru.gru_scan_backward_reference(*bwd_args)
            torch.cuda.synchronize()
            err["bwd"] = max(err["bwd"], check_all(torch, dout, dref, BWD_TOLERANCE[name],
                                                   f"K5 {name} {case}"))
        args = cases["2 directions, prefix mask, nonzero carry"]
        fwd_out = gru.gru_scan_reference(*args, save_residuals=True)
        h_prev = _carried_h_prev(fwd_out[0], mask, h0, args[5])
        bwd_args = (fwd_out[2], mask, w, h_prev, dy, dh_t, args[5])
        bwd_out = gru.gru_scan_backward_reference(*bwd_args)
        flops = scan_flops(mask, 2, 3, H)
        bounds = {"fwd": least_time(flops, nbytes(*args[:5], *fwd_out), name),
                  "bwd": least_time(flops, nbytes(*bwd_args[:6], *bwd_out), name)}
        # cuDNN in the working dtype: the bf16 pair is held to cuDNN in bf16
        lib = library_times(torch, "GRU", w, b, lengths, TRAIN_T, 5, train=True)

        def k4r_k5():
            y, _, res = gru.gru_scan_fwd(*args, save_residuals=True)
            return gru.gru_scan_bwd(res, mask, w, _carried_h_prev(y, mask, h0, args[5]),
                                    *bwd_args[4:])

        pair_ms = cuda_time(k4r_k5, 10)
        times = {
            "fwd": (cuda_time(lambda: gru.gru_scan_fwd(*args, save_residuals=True), 10),
                    cuda_time(lambda: gru.gru_scan_reference(*args, save_residuals=True), 3)),
            "bwd": (cuda_time(lambda: gru.gru_scan_bwd(*bwd_args), 10),
                    cuda_time(lambda: gru.gru_scan_backward_reference(*bwd_args), 3))}
        for i, (key, label) in enumerate((("fwd", "gru_fwd_residuals (K4 with residuals)"),
                                          ("bwd", "gru_bwd (K5)"))):
            tol = TOLERANCE[name] if key == "fwd" else BWD_TOLERANCE[name]
            print(f"kernel {label} {name} T={TRAIN_T} B={TRAIN_B} H={H} 2 directions: "
                  f"max_abs_err {err[key]!r} (atol {tol[0]}, rtol {tol[1]}); kernel "
                  f"{times[key][0]!r} ms, plain {times[key][1]!r} ms, torch.nn.GRU (cuDNN) "
                  f"{'training forward' if key == 'fwd' else 'backward'} {lib[i]!r} ms (median, "
                  f"CUDA events); bound {bounds[key][0]!r} ms ({bounds[key][1]})")
            result[(key, name)] = {"max_abs_err": err[key], "ms": times[key][0],
                                   "plain_ms": times[key][1], "bound_ms": bounds[key][0],
                                   "bound_by": bounds[key][1], "library_ms": lib[i]}
        print(f"kernels K4 with residuals + K5 {name} as one call: {pair_ms!r} ms; "
              f"torch.nn.GRU (cuDNN) forward + backward under autograd {lib[2]!r} ms (median, "
              f"CUDA events)")
        attrs = {key: step_kernel_attributes(fn, dtype, label) for key, fn, label in (
            ("fwd", gru.fwd_kernel_attributes, "gru_fwd_residuals (K4 with residuals)"),
            ("bwd", gru.bwd_kernel_attributes, "gru_bwd (K5)"))}
        check(attrs["fwd"]["local_bytes"] == 0, f"K4 residuals {name}: the step kernel spills "
                                                f"{attrs['fwd']['local_bytes']} bytes a thread")
        result[("fwd", name)].update(kernel_attributes=attrs["fwd"])
        result[("bwd", name)].update(with_forward_ms=pair_ms, with_forward_library_ms=lib[2],
                                     kernel_attributes=attrs["bwd"])
    return result


def phase_gru_gradients(torch, np):
    """The differentiated gru_scan (K4 with residuals, K5, dW and db by
    matmul) against autograd through gru_scan_reference, on the card; the
    reverse direction meets a suffix mask with a nonzero carry."""
    from dsjax_torch.ops import gru

    t_dim, b_dim, h_dim = 64, 16, 256
    rng = np.random.default_rng(22)
    lengths = rng.integers(0, t_dim + 1, b_dim)
    lengths[:2] = (t_dim, 1)
    mask = torch.from_numpy((np.arange(t_dim)[:, None] < lengths[None, :])
                            .astype(np.float32)).cuda()
    shapes = ((2, t_dim, b_dim, 3 * h_dim), (2, 3 * h_dim, h_dim), (2, 3 * h_dim),
              (2, b_dim, h_dim))
    inputs = [torch.from_numpy((rng.standard_normal(s) * k).astype(np.float32)).cuda()
              .requires_grad_(True) for s, k in zip(shapes, (0.3, 0.1, 0.1, 0.3))]
    weights = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda()
               for s in ((2, t_dim, b_dim, h_dim), (2, b_dim, h_dim))]
    counts = (gru.RESIDUAL_LAUNCHES, gru.BWD_LAUNCHES)
    out = gru.gru_scan(inputs[0], mask, *inputs[1:], (False, True))
    got = torch.autograd.grad(sum((o * wt).sum() for o, wt in zip(out, weights)), inputs)
    ref = gru.gru_scan_reference(inputs[0], mask, *inputs[1:], (False, True))
    want = torch.autograd.grad(sum((o * wt).sum() for o, wt in zip(ref, weights)), inputs)
    torch.cuda.synchronize()
    check((gru.RESIDUAL_LAUNCHES - counts[0], gru.BWD_LAUNCHES - counts[1]) == (1, 1),
          "the differentiated GRU scan did not run K4 with residuals and K5 once each")
    errs = {}
    for name, g, w in zip(("dxp", "dW_hh", "db_hh", "dh0"), got, want):
        e, ok = within(g, w, *GRAD_TOL)
        check(ok and w.abs().max().item() > 0,
              f"GRU gradient {name}: max err {e} over atol {GRAD_TOL[0]} rtol {GRAD_TOL[1]}")
        errs[name] = e
    print(f"gradients of gru_scan (K4 with residuals + K5) vs autograd through the plain loop, "
          f"f32, T={t_dim} B={b_dim} H={h_dim} 2 directions, nonzero carry: max_abs_err {errs} "
          f"(atol {GRAD_TOL[0]}, rtol {GRAD_TOL[1]})")


def gru_checkpoint(tmp, name):
    """A port checkpoint of tests/golden_gru.py's model ``name``."""
    from dsjax_torch.config import SpectConfig
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.model.convert import (from_reference_state_dict, infer_architecture,
                                           save_checkpoint)
    from tests.golden_gru import gru_state

    state = gru_state(name)
    model_cfg, _ = infer_architecture(state)
    path = os.path.join(tmp, f"{name}.pt")
    save_checkpoint(path, from_reference_state_dict(state), model_cfg, SpectConfig(),
                    DEFAULT_LABELS)
    return path, model_cfg


def phase_gru_parity(torch, np, tmp):
    """5 x BiGRU-1024 and 5 x GRU-1024 + Lookahead 20 against
    tests/fixtures/golden_gru.npz (dsjax's posteriors), loaded as a user
    loads a checkpoint."""
    from dsjax_torch.inference import load_model
    from dsjax_torch.ops import gru
    from tests.golden_gru import GOLDEN_TOL, gru_input

    golden = np.load(os.path.join(ROOT, "tests", "fixtures", "golden_gru.npz"))
    x, lengths = gru_input()
    paths = {}
    for name in ("bigru", "unigru"):
        path, model_cfg = gru_checkpoint(tmp, name)
        paths[name] = (path, model_cfg)
        bundle = load_model(path, device="cuda:0")
        before = gru.LAUNCHES
        probs, out_lens, carry = bundle.forward(x, lengths)
        torch.cuda.synchronize()
        launched = gru.LAUNCHES - before
        check(launched == model_cfg.hidden_layers,
              f"{name}: {launched} gru_fwd launches for {model_cfg.hidden_layers} layers")
        check(all(len(c) == 1 for c in carry), f"{name}: the carry is not (h,) per layer")
        probs, out_lens = probs.cpu().numpy(), out_lens.cpu().numpy()
        check(np.array_equal(out_lens, golden[f"{name}_out_lens"]), f"{name} out_lens {out_lens}")
        check(bool(np.isfinite(probs).all()), f"{name} probs not finite")
        err = 0.0
        for i, n in enumerate(out_lens):
            want = golden[f"{name}_probs"][i, :n]
            e = np.abs(probs[i, :n] - want)
            check(bool((e <= GOLDEN_TOL[0] + GOLDEN_TOL[1] * np.abs(want)).all()),
                  f"{name} probs row {i}: max err {e.max()} over {GOLDEN_TOL}")
            err = max(err, float(e.max()))
        print(f"parity {name} ({model_cfg}) f32 probs {probs.shape} vs golden_gru.npz: "
              f"max_abs_err {err!r} (atol {GOLDEN_TOL[0]}, rtol {GOLDEN_TOL[1]}); gru_fwd "
              f"launches {launched}")
        del bundle
    return paths


def stream_direct(worker, chunks, np):
    """What a /stream session computes, straight through ModelBundle.forward:
    running feature statistics over the frames so far, the carry passed
    along, greedy collapse across chunks (dsjax_torch/server.py:stream_chunk)."""
    from dsjax_torch.audio.features import spectrogram_np

    cfg, dec = worker.bundle.spect_cfg, worker.decoder
    # the greedy decoder's table, or the host beam's (in its label map)
    int_to_char = getattr(dec, "int_to_char", None) or dec.label_map.int_to_char
    total = total_sq = 0.0
    count, carry, prev, text = 0, None, dec.blank_index, ""
    for y in chunks:
        raw = spectrogram_np(y, cfg, normalize=False)
        total += float(raw.astype(np.float64).sum())
        total_sq += float((raw.astype(np.float64) ** 2).sum())
        count += raw.size
        mean = total / count
        std = max(np.sqrt(max((total_sq - count * mean * mean) / max(count - 1, 1), 0.0)), 1e-10)
        spect = ((raw - mean) / std)[None].astype(np.float32)
        t_true = spect.shape[2]
        spect = np.pad(spect, ((0, 0), (0, 0), (0, (t_true + 63) // 64 * 64 - t_true)))
        probs, out_lens, carry = worker.bundle.forward(spect, [t_true], carry)
        for lbl in probs[0, : int(out_lens[0])].argmax(dim=-1).tolist():
            if lbl != dec.blank_index and lbl != prev:
                text += int_to_char[lbl]
            prev = lbl
    return text


def phase_gru_serving(torch, np, paths, gpu_name):
    """The server on the 5 x BiGRU-1024 checkpoint answering 8 concurrent
    /transcribe requests, and on the 5 x GRU-1024 + Lookahead checkpoint a
    /stream session of 1 s chunks; exact K4 launch counts over both."""
    from dsjax_torch.config import ServerConfig, compose
    from dsjax_torch.ops import gru
    from dsjax_torch.server import serve, shutdown

    rng = np.random.default_rng(23)
    seconds = [round(float(s), 2) for s in rng.uniform(1.0, 10.0, 8)]
    ys = [synth(rng, np, s) for s in seconds]
    stream_ys = [synth(rng, np, 1.0) for _ in range(5)]
    reset_counts()
    cfg = compose(ServerConfig, [f"model.model_path={paths['bigru'][0]}", "host=127.0.0.1",
                                 "port=0", "device=cuda:0", "max_batch=8", "batch_timeout_ms=2000",
                                 "warmup_seconds=10"])
    server, worker = serve(cfg)
    try:
        port = server.server_address[1]
        results = [None] * len(ys)

        def client(i):
            results[i] = post(port, "/transcribe", ys[i])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(ys))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            check(not t.is_alive(), "a GRU /transcribe request hung")
        for (status, payload, _), s in zip(results, seconds):
            check(status == 200, f"GRU /transcribe ({s} s) -> {status} {payload}")
        want = direct_transcripts(worker, ys, np)
        got = [r[1]["output"][0]["transcription"] for r in results]
        check(got == want, f"GRU /transcribe differs from the direct forward:\n{got}\n{want}")
        bi_forwards = cfg.max_batch.bit_length() + 1 + 1       # warmups, the batch, direct
    finally:
        shutdown(server, worker)
    layers = paths["bigru"][1].hidden_layers
    cfg = compose(ServerConfig, [f"model.model_path={paths['unigru'][0]}", "host=127.0.0.1",
                                 "port=0", "device=cuda:0", "max_batch=1", "warmup_seconds=1"])
    server, worker = serve(cfg)
    try:
        port = server.server_address[1]
        stream = [post(port, f"/stream?session=uni&final={int(i == len(stream_ys) - 1)}", y)
                  for i, y in enumerate(stream_ys)]
        for status, payload, _ in stream:
            check(status == 200 and isinstance(payload.get("transcription"), str),
                  f"GRU /stream -> {status} {payload}")
        direct = stream_direct(worker, stream_ys, np)
        check(stream[-1][1]["transcription"] == direct,
              f"the unidirectional /stream transcript {stream[-1][1]['transcription']!r} differs "
              f"from the direct chunked forward {direct!r}")
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        shutdown(server, worker)
    uni_forwards = 1 + 2 * len(stream_ys)                         # warmup, session, direct
    want_k4 = (bi_forwards + uni_forwards) * layers
    check(counts["gru_fwd"] == want_k4 and counts["lstm_fwd"] == 0,
          f"GRU serving launches {counts}, expected {want_k4} gru_fwd "
          f"({bi_forwards} + {uni_forwards} forwards x {layers} layers)")
    lat = sorted(r[2] for r in results)
    print(f"GRU serving on {gpu_name}: 5 x BiGRU-1024, 8 concurrent /transcribe of {seconds} s: "
          f"p50 {statistics.median(lat)!r} ms, max {lat[-1]!r} ms, equal to the direct forward; "
          f"5 x GRU-1024 + Lookahead 20 /stream of {len(stream_ys)} 1 s chunks: "
          f"{[round(s[2], 3) for s in stream]} ms, transcript equal to the direct chunked "
          f"forward; gru_fwd launches {counts['gru_fwd']} ({bi_forwards} + {uni_forwards} "
          f"forwards x {layers} layers, one a layer call), {counts['gru_steps']} time steps "
          f"scanned")
    return counts


def addmm_graph(torch, xp, w, h0):
    """The chain as T torch.addmm calls (cuBLAS; h the first H columns of
    the previous product, read in place) captured in one CUDA graph: the
    library yardstick of K8. Returns (the graph, h_T's view)."""
    n_t, n_h = xp.shape[0], h0.shape[1]
    z = torch.empty((2,) + tuple(xp.shape[1:]), dtype=xp.dtype, device=xp.device)

    def chain():
        h = h0
        for t in range(n_t):
            torch.addmm(xp[t], h, w, out=z[t % 2])
            h = z[t % 2][:, :n_h]
        return h

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        h_t = chain()
    return graph, h_t


def phase_mm_chain(torch, np):
    """K8: tools/lstm_microbench.py:_mm_kernel -> dsjax_torch/csrc/mm_chain.cu,
    at the microbench's shapes (T=512, B=64, H=1024, bf16), then the
    microbench tool itself (its main path) with K8's launches counted."""
    import importlib.util

    from dsjax_torch.ops import _card, mm_chain

    spec = importlib.util.spec_from_file_location(
        "torch_lstm_microbench", os.path.join(ROOT, "tools", "torch_lstm_microbench.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    rng = np.random.default_rng(24)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to("cuda", torch.bfloat16)
    xp = bf(rng.standard_normal((TRAIN_T, TRAIN_B, 4 * H)))
    w = bf(rng.standard_normal((H, 4 * H)) * 0.01)
    h0 = bf(rng.standard_normal((TRAIN_B, H)))
    plan = mm_chain.chain_plan(TRAIN_B, H, _card.sm_count(xp.device))
    attrs = mm_chain.kernel_attributes(plan)
    print(f"kernel mm_chain (K8) plan: {plan.ctas} CTAs of {plan.cols} columns (one an SM), "
          f"{plan.m_rows} rows a product, {plan.stages} K atoms of h in shared memory "
          f"({'resident' if plan.resident else 'streamed'}); {attrs['registers']} registers a "
          f"thread, {attrs['static_smem_bytes'] + attrs['dynamic_smem_bytes']} bytes of shared "
          f"memory a CTA, {attrs['local_bytes']} bytes of local memory a thread "
          f"(cudaFuncGetAttributes)")
    check(attrs["local_bytes"] == 0, f"K8 spills {attrs['local_bytes']} bytes a thread")
    got = mm_chain.mm_chain(xp, w, h0)
    want = mm_chain.mm_chain_reference(xp, w, h0)
    torch.cuda.synchronize()
    err = check_all(torch, got, want, BWD_TOLERANCE["bfloat16"], "K8")
    k_ms = cuda_time(lambda: mm_chain.mm_chain(xp, w, h0), 10)
    p_ms = cuda_time(lambda: mm_chain.mm_chain_reference(xp, w, h0), 3)
    graph, h_graph = addmm_graph(torch, xp, w, h0)
    graph.replay()
    torch.cuda.synchronize()
    lib_err = (h_graph.float() - want[0].float()).abs().max().item()
    check(bool(torch.isfinite(h_graph.float()).all()), "the cuBLAS chain is not finite")
    lib_ms = cuda_time(graph.replay, 10)
    flops = 2.0 * TRAIN_B * H * 4 * H * TRAIN_T
    bound_ms, bound_by = least_time(flops, nbytes(xp, w, h0, *got), "bfloat16")
    share = flops / PEAK_FLOPS["bfloat16"] / (k_ms / 1e3)
    print(f"kernel mm_chain (K8) bf16 T={TRAIN_T} B={TRAIN_B} H={H}: max_abs_err {err!r} (atol "
          f"{BWD_TOLERANCE['bfloat16'][0]}, rtol {BWD_TOLERANCE['bfloat16'][1]}); kernel "
          f"{k_ms!r} ms ({k_ms * 1e3 / TRAIN_T!r} us/step, {share!r} of the bf16 peak), plain "
          f"{p_ms!r} ms, a CUDA graph of {TRAIN_T} torch.addmm calls (cuBLAS) {lib_ms!r} ms "
          f"(h_T max_abs_err {lib_err!r} against the plain chain) (median, CUDA events); bound "
          f"{bound_ms!r} ms ({bound_by})")
    reset_counts()
    bench = tool.run(log=lambda line: print(f"microbench: {line}"))
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["mm_chain"] == 8, f"microbench: {counts['mm_chain']} mm_chain launches, "
                                   f"expected 8 (5 timed, 1 profiled, 2 warm-ups)")
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms,
            "library_call": f"a CUDA graph of {TRAIN_T} torch.addmm calls (cuBLAS), not one call",
            "library_max_abs_err": lib_err, "bf16_peak_share": share,
            "kernel_attributes": attrs, "launches": counts["mm_chain"], "microbench": bench}


def bits_equal(torch, a, b):
    """Equal tensors, floats bit for bit (signed zeros told apart)."""
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def bucket_sorted(np, data):
    """A table's (S, 4) slots with each bucket's slots in key order: the ARPA
    build inserts in the file's order, the binary's in word-id order."""
    rows = data.reshape(-1, 16, 4)
    keys = rows[..., 0].astype(np.uint64) << np.uint64(32) | rows[..., 1]
    return np.take_along_axis(rows, np.argsort(keys, axis=1, kind="stable")[..., None], axis=1)


def lm_samples(np, host, n, seed):
    """n (word, 2-word context) pairs for score_word_ln: trigrams of the LM,
    bigrams behind a random word, unigrams behind two random words, and
    words the LM lacks, in the word or the context (none with <s>, </s> or
    <unk>, which the decoder never produces)."""
    rng = np.random.default_rng(seed)
    specials = ("<s>", "</s>", "<unk>")
    uni = [w for (w,) in host.ngrams[0] if w not in specials]
    bi = [g for g in host.ngrams[1] if not set(g) & set(specials)]
    tri = [g for g in host.ngrams[2] if not set(g) & set(specials)]
    pick = lambda seq: seq[rng.integers(len(seq))]
    oov = lambda: "".join(rng.choice(list("QXZJ"), 9))
    out = []
    for i in range(n):
        kind = i % 8
        if kind < 3:
            g = pick(tri)
            out.append((g[2], [g[0], g[1]]))
        elif kind < 5:
            g = pick(bi)
            out.append((g[1], [pick(uni), g[0]]))
        elif kind < 7:
            out.append((pick(uni), [pick(uni), pick(uni)] if kind == 5 else [oov(), pick(uni)]))
        else:
            out.append((oov(), [pick(uni), pick(uni)]))
    return out


def lm_scan(_beam_scan, lp, sizes, w, lm, top_n=10 ** 9, top_k=None, carry0=None):
    return _beam_scan(lp, sizes, w, 0, cutoff_top_n=top_n, lm=lm, alpha=LM_ALPHA, beta=LM_BETA,
                      space=LM_SPACE, top_k=top_k, carry0=carry0)


def flat_scan(r):
    """Every tensor of an LM scan's outputs: backptr, emit, h1, h2, totals,
    the core carry and the LM state."""
    return (r[0], r[1], *r[2], r[3], *r[4][0], *r[4][1])


def phase_lm_formats(torch, np, tmp):
    """21 (a, b): the host library with lm.cpp and beam.cpp, the synthetic
    3-gram as ARPA and DSLMBIN2, the device tables from both, and
    score_word_ln on the card against ArpaLM."""
    from dsjax_torch.audio import native
    from dsjax_torch.decode import lm_device
    from dsjax_torch.decode.lm import ArpaLM
    from dsjax_torch.decode.native_beam import build_lm_binary
    from dsjax_torch.labels import DEFAULT_LABELS, LabelMap
    from tests.synthetic_lm import letter_trigram, write_arpa

    t0 = time.perf_counter()
    native.build(force=True)
    native.load_library()
    lib_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    arpa = write_arpa(os.path.join(tmp, "letters.arpa"), letter_trigram(seed=21))
    arpa_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    binary = os.path.join(tmp, "letters.bin")
    build_lm_binary(arpa, binary)
    bin_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = ArpaLM(arpa)
    from_text = lm_device.DeviceNgramLM(host, DEFAULT_LABELS)
    text_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    from_bin = lm_device.DeviceNgramLM(binary, DEFAULT_LABELS)
    packed = from_bin.device("cuda")
    torch.cuda.synchronize()
    packed_s = time.perf_counter() - t0
    counts = [len(g) for g in host.ngrams]
    check((from_text.order, from_text.unk_logp, from_text.n_vocab)
          == (from_bin.order, from_bin.unk_logp, from_bin.n_vocab),
          "the ARPA and binary LMs differ in order, <unk> or vocabulary")
    for i, (a, b) in enumerate(zip(from_text.tables, from_bin.tables)):
        check(a.data.shape == b.data.shape and np.array_equal(bucket_sorted(np, a.data),
                                                              bucket_sorted(np, b.data)),
              f"order {i + 1}: the ARPA and the binary pack different tables")
    table_bytes = packed.ngrams.numel() * packed.ngrams.element_size()
    print(f"lm formats: host library (flac, audio_decode, levenshtein, lm, beam) built in "
          f"{lib_s!r} s; synthetic 3-gram over A-Z {counts} n-grams written in {arpa_s!r} s, "
          f"DSLMBIN2 {os.path.getsize(binary)} bytes in {bin_s!r} s; device tables "
          f"{table_bytes} bytes ({from_bin.n_vocab} words) packed from the ARPA in {text_s!r} s "
          f"(parse included) and from the binary and copied to the card in {packed_s!r} s, "
          f"equal bucket for bucket")

    lmap = LabelMap(DEFAULT_LABELS)
    samples = lm_samples(np, host, LM_SAMPLES, seed=22)
    pair = lambda w: lm_device._word_hash([lmap.char_to_int[c] for c in w])
    cur = torch.tensor([pair(w) for w, _ in samples], dtype=torch.int64, device="cuda")
    ctx = torch.tensor([[pair(c) for c in cs] for _, cs in samples], dtype=torch.int64,
                       device="cuda")
    got = lm_device.score_word_ln(packed, cur[:, 0], cur[:, 1], ctx)[0].cpu().numpy()
    want = np.array([host.score_word_ln(w, cs) for w, cs in samples])
    err = float(np.abs(got - want).max())
    check(bool(np.isfinite(got).all()) and err <= LM_SCORE_TOL,
          f"score_word_ln on the card: max err {err} against ArpaLM over {LM_SAMPLES} samples")
    print(f"lm scoring: score_word_ln on the card over {LM_SAMPLES} (word, 2-word context) "
          f"samples against ArpaLM.score_word_ln: max_abs_err {err!r} (<= {LM_SCORE_TOL})")
    return arpa, binary, packed, {"ngrams": counts, "table_bytes": table_bytes,
                                  "binary_bytes": os.path.getsize(binary),
                                  "pack_from_arpa_s": text_s, "pack_from_binary_s": packed_s,
                                  "score_max_abs_err": err}


def phase_lm_scan(torch, np, packed):
    """21 (c): the LM-fused scan with K6 against the same scan with the plain
    top-k on the card, bit for bit; a two-chunk stream against the one-shot
    scan; K6 timed at the LM pool; no K7 for an LM decode."""
    from dsjax_torch.decode.beam_device import DeviceBeamDecoder, _beam_scan
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.ops import beam, topk

    result = {}
    for b, t, w, c, top_n in LM_SCAN_SHAPES:
        what = f"B={b} T={t} W={w} C={c}" + (f" cutoff_top_n={top_n}" if top_n < c else "")
        lp, sizes = beam_inputs(torch, np, b, t, c, seed=w + 100)
        before = topk.LAUNCHES
        got = lm_scan(_beam_scan, lp, sizes, w, packed, top_n)
        torch.cuda.synchronize()
        launches = topk.LAUNCHES - before
        check(launches == t, f"LM scan {what}: {launches} K6 launches for {t} frames")
        want = lm_scan(_beam_scan, lp, sizes, w, packed, top_n, top_k=topk.topk_reference)
        for i, (g, x) in enumerate(zip(flat_scan(got), flat_scan(want))):
            check(bits_equal(torch, g, x), f"LM scan {what}: output {i} differs from the plain "
                                           f"top-k's")
        check(bool(torch.isfinite(got[3][sizes > 0]).all()), f"LM scan {what}: totals not finite")
        half = t // 2
        first = lm_scan(_beam_scan, lp[:, :half], sizes.clamp(max=half), w, packed, top_n)
        second = lm_scan(_beam_scan, lp[:, half:], (sizes - half).clamp(min=0), w, packed,
                         top_n, carry0=first[4])
        joined = (torch.cat([first[0], second[0]]), torch.cat([first[1], second[1]]),
                  (torch.cat([first[2][0], second[2][0]]), torch.cat([first[2][1], second[2][1]])),
                  second[3], second[4])
        torch.cuda.synchronize()
        for i, (g, x) in enumerate(zip(flat_scan(joined), flat_scan(got))):
            check(bits_equal(torch, g, x), f"LM scan {what}: the two-chunk stream's output {i} "
                                           f"differs from the one-shot scan's")
        k_ms = cuda_time(lambda: lm_scan(_beam_scan, lp, sizes, w, packed, top_n), 3)
        p_ms = cuda_time(lambda: lm_scan(_beam_scan, lp, sizes, w, packed, top_n,
                                         top_k=topk.topk_reference), 3)
        print(f"lm scan {what}, alpha {LM_ALPHA} beta {LM_BETA}: with K6 every output and the "
              f"carry (LM hashes included) bit for bit equal to the plain top-k's; a two-chunk "
              f"stream equal to the one-shot scan; {launches} K6 launches ({t} frames); scan "
              f"with K6 {k_ms!r} ms, with the plain top-k {p_ms!r} ms (median, CUDA events)")
        result[what] = {"k6_launches": launches, "scan_k6_ms": k_ms, "scan_plain_ms": p_ms}

    # K6 alone at the LM pools: W stays and W * C extends a row
    rng = np.random.default_rng(25)
    for b, t, w, c, top_n in LM_SCAN_SHAPES[:2]:
        n = w + w * c
        s = torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32)).cuda()
        got, want = topk.topk(s, w), topk.topk_reference(s, w)
        torch.cuda.synchronize()
        check(bits_equal(torch, got[0], want[0]) and torch.equal(got[1], want[1]),
              f"K6 ({b}, {n}) -> {w}: differs from the plain version")
        k_ms = cuda_time(lambda: topk.topk(s, w), 50)
        dev_ms = kernel_device_ms(torch, lambda: topk.topk(s, w), "topk_kernel", 50)
        p_ms = cuda_time(lambda: topk.topk_reference(s, w), 50)
        lib_ms = cuda_time(lambda: torch.topk(s, w, dim=-1), 50)
        bound_ms, bound_by = least_time(s.numel(), nbytes(s, *got), "float32")
        print(f"kernel topk at the LM pool ({b}, {n}) -> {w}: equal to the plain version; kernel "
              f"{k_ms!r} ms, {dev_ms!r} ms device time (torch.profiler), plain {p_ms!r} ms, "
              f"torch.topk {lib_ms!r} ms; bound {bound_ms!r} ms ({bound_by})")
        result[f"K6 ({b}, {n}) -> {w}"] = {"max_abs_err": 0.0, "ms": k_ms, "device_ms": dev_ms,
                                            "plain_ms": p_ms, "bound_ms": bound_ms,
                                            "bound_by": bound_by, "library_ms": lib_ms}

    # an LM decode under DSJAX_FUSED_BEAM=1: K6 and the backtrack, no K7
    b, t, w, c, _ = LM_SCAN_SHAPES[0]
    lp, sizes = beam_inputs(torch, np, b, t, c, seed=3)
    dec = DeviceBeamDecoder(DEFAULT_LABELS, beam_width=w, alpha=LM_ALPHA, beta=LM_BETA,
                            shared_lm=packed)
    os.environ["DSJAX_FUSED_BEAM"] = "1"
    try:
        before = (topk.LAUNCHES, beam.LAUNCHES, beam.BACKTRACK_LAUNCHES)
        dec.decode(lp.exp(), sizes, n_best=1)
        torch.cuda.synchronize()
        counts = (topk.LAUNCHES - before[0], beam.LAUNCHES - before[1],
                  beam.BACKTRACK_LAUNCHES - before[2])
    finally:
        os.environ.pop("DSJAX_FUSED_BEAM")
    check(counts == (t + 1, 0, 1), f"an LM decode with DSJAX_FUSED_BEAM=1 launched K6, K7 and "
                                   f"the backtrack {counts} times, expected ({t + 1}, 0, 1)")
    print(f"lm decode with DSJAX_FUSED_BEAM=1 (B={b} T={t} W={w}): K6 {counts[0]}, K7 "
          f"{counts[1]}, backtrack {counts[2]} launches")
    return result


def lm_eval_args(arpa, device_beam):
    return ["lm.decoder_type=beam", f"lm.beam_width={EVAL_WIDTH}", f"lm.lm_path={arpa}",
            f"lm.alpha={LM_ALPHA}", f"lm.beta={LM_BETA}", f"lm.device_beam={device_beam}",
            "lm.lm_workers=4"]


def phase_lm_evaluation(torch, np, path, manifest, arpa, model_cfg, gpu_name):
    """21 (d): workflows.evaluate of the flagship on phase 12's corpus with the
    LM, on the device route (under DSJAX_FUSED_BEAM=1, which must not take
    K7) and the host route."""
    from dsjax_torch.config import EvalConfig, compose
    from dsjax_torch.workflows import evaluate

    runs = {}
    for name, device_beam in (("device LM beam", "true"), ("host LM beam", "false")):
        os.environ["DSJAX_FUSED_BEAM"] = "1"
        cfg = compose(EvalConfig, [f"model.model_path={path}", f"test_path={manifest}",
                                   f"batch_size={EVAL_BATCH}", "num_workers=4", "device=cuda:0"]
                      + lm_eval_args(arpa, device_beam))
        out = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                wer, cer = evaluate(cfg)
            torch.cuda.synchronize()
        finally:
            os.environ.pop("DSJAX_FUSED_BEAM")
        wall = time.perf_counter() - t0
        counts = read_counts()
        lines = out.getvalue().splitlines()
        hyps = [line for line in lines if line.startswith("Hyp:")]
        summary = [line for line in lines if line.startswith("Test Summary")]
        check(len(hyps) == EVAL_UTTS and len(summary) == 1, f"evaluate ({name}) printed "
              f"{len(hyps)} hypotheses and {len(summary)} summaries")
        check(np.isfinite(wer) and np.isfinite(cer), f"evaluate ({name}): WER {wer} CER {cer}")
        runs[name] = dict(wer=wer, cer=cer, summary=summary[0].strip(), counts=counts, wall=wall)
    layers, batches = model_cfg.hidden_layers, -(-EVAL_UTTS // EVAL_BATCH)
    steps = runs["device LM beam"]["counts"]["lstm_steps"] // layers   # frames, all batches
    want = {"device LM beam": (steps + batches, 0, batches), "host LM beam": (0, 0, 0)}
    for name, (n_topk, n_beam, n_back) in want.items():
        c = runs[name]["counts"]
        check(c["lstm_fwd"] == layers * batches,
              f"evaluate ({name}): {c['lstm_fwd']} lstm_fwd launches for {batches} batches")
        check((c["topk"], c["beam_scan"], c["beam_backtrack"]) == (n_topk, n_beam, n_back),
              f"evaluate ({name}): topk {c['topk']}, beam_scan {c['beam_scan']} and "
              f"beam_backtrack {c['beam_backtrack']} launches, expected {n_topk}, {n_beam} and "
              f"{n_back} ({steps} frames in {batches} batches)")
    for name, r in runs.items():
        print(f"lm evaluation on {gpu_name}, flagship f32, {EVAL_UTTS} utterances of 2-12 s, "
              f"batch {EVAL_BATCH}, W={EVAL_WIDTH}, alpha {LM_ALPHA} beta {LM_BETA} ({name}): "
              f"{r['summary']!r}; wall {r['wall']!r} s ({EVAL_UTTS / r['wall']!r} utt/s with "
              f"the model's load); launches {r['counts']}")
    return runs


def phase_lm_serving(torch, np, path, arpa, binary, gpu_name):
    """21 (e): the server with the LM. On the device route 8 concurrent
    /transcribe requests against DeviceBeamDecoder(lm_path=the binary).decode
    on the same posteriors and a /stream session against the one-shot LM
    decode of its chunks; on the host route a /stream session (greedy, the
    host beam cannot stream) against the direct chunked forward."""
    from dsjax_torch.config import ServerConfig, compose
    from dsjax_torch.decode.beam import BeamCTCDecoder
    from dsjax_torch.decode.beam_device import DeviceBeamDecoder
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.server import serve, shutdown

    rng = np.random.default_rng(26)
    seconds = [round(float(s), 2) for s in rng.uniform(1.0, 8.0, 8)]
    ys = [synth(rng, np, s) for s in seconds]
    stream_ys = [synth(rng, np, 1.0) for _ in range(3)]
    base = [f"model.model_path={path}", "host=127.0.0.1", "port=0", "device=cuda:0",
            "max_batch=8", "batch_timeout_ms=2000", "warmup_seconds=2"]
    cfg = compose(ServerConfig, base + lm_eval_args(arpa, "true"))
    server, worker = serve(cfg)
    try:
        check(isinstance(worker.decoder, DeviceBeamDecoder) and worker.decoder._lm is not None,
              "the LM server's decoder is not the device beam with the LM")
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
            check(not t.is_alive(), "an LM /transcribe request hung")
        stream = [post(port, f"/stream?session=lm&final={int(i == 2)}", y)
                  for i, y in enumerate(stream_ys)]
        for status, payload, _ in results + stream:
            check(status == 200, f"LM server -> {status} {payload}")
        from_binary = DeviceBeamDecoder(DEFAULT_LABELS, beam_width=EVAL_WIDTH, lm_path=binary,
                                        alpha=LM_ALPHA, beta=LM_BETA, cutoff_top_n=40)
        worker.decoder, device_decoder = from_binary, worker.decoder
        want = direct_transcripts(worker, ys, np)
        worker.decoder = device_decoder
        got = [r[1]["output"][0]["transcription"] for r in results]
        check(got == want, f"LM /transcribe differs from DeviceBeamDecoder(lm_path).decode on "
                           f"the same posteriors:\n{got}\n{want}")
        one_shot = from_binary.decode(torch.cat(chunks_seen, dim=1))[0][0][0]
        check(stream[-1][1]["transcription"] == one_shot,
              f"LM /stream transcript {stream[-1][1]['transcription']!r} differs from the "
              f"one-shot LM decode of its chunks {one_shot!r}")
    finally:
        shutdown(server, worker)
    cfg = compose(ServerConfig, base + lm_eval_args(arpa, "false"))
    server, worker = serve(cfg)
    try:
        check(isinstance(worker.decoder, BeamCTCDecoder) and worker.decoder.lm is not None,
              "the host LM server's decoder is not the host beam with the LM")
        port = server.server_address[1]
        host_stream = [post(port, f"/stream?session=host&final={int(i == 2)}", y)
                       for i, y in enumerate(stream_ys)]
        for status, payload, _ in host_stream:
            check(status == 200, f"host LM /stream -> {status} {payload}")
        direct = stream_direct(worker, stream_ys, np)
        check(host_stream[-1][1]["transcription"] == direct,
              f"the host LM /stream transcript {host_stream[-1][1]['transcription']!r} differs "
              f"from the direct chunked greedy forward {direct!r}")
    finally:
        shutdown(server, worker)
    lat = sorted(r[2] for r in results)
    print(f"lm serving on {gpu_name} (W={EVAL_WIDTH}, device LM beam): 8 concurrent /transcribe "
          f"of {seconds} s: p50 {statistics.median(lat)!r} ms, max {lat[-1]!r} ms, equal to "
          f"DeviceBeamDecoder(lm_path=DSLMBIN2).decode on the same posteriors; /stream chunks "
          f"{[round(s[2], 3) for s in stream]} ms, last transcript equal to the one-shot LM "
          f"decode; host LM beam /stream {[round(s[2], 3) for s in host_stream]} ms, equal to "
          f"the direct chunked greedy forward")


def phase_lm_tuner(np, path, manifest_dir, arpa):
    """21 (f): python -m dsjax_torch.search_lm_params on a 2 x 2 grid with the
    device beam on four WAVs, then python -m dsjax_torch.select_lm_params on
    its JSON."""
    from tests.synthetic_manifest import write_manifest

    manifest = write_manifest(manifest_dir, "tune", [2.5, 3.0, 4.0, 3.5], seed=27)
    out = os.path.join(manifest_dir, "grid.json")
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "dsjax_torch.search_lm_params", f"model_path={path}",
         f"test_path={manifest}", f"lm_path={arpa}", "grid=true", "grid_steps=2",
         "device_beam=true", f"beam_width={EVAL_WIDTH}", "batch_size=4", "n_jobs=2",
         "device=cuda:0", f"output_path={out}"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    tune_s = time.perf_counter() - t0
    check(run.returncode == 0, f"search_lm_params exited {run.returncode}:\n{run.stderr[-3000:]}")
    with open(out) as f:
        trials = json.load(f)
    check(len(trials) == 4 and all(len(t) == 4 and all(np.isfinite(t)) for t in trials),
          f"search_lm_params wrote {trials}")
    sel = subprocess.run([sys.executable, "-m", "dsjax_torch.select_lm_params", "--input-path",
                          out], cwd=ROOT, capture_output=True, text=True, timeout=120)
    check(sel.returncode == 0 and "Alpha" in sel.stdout,
          f"select_lm_params exited {sel.returncode}:\n{sel.stderr[-3000:]}")
    best = min(trials, key=lambda t: t[2])
    check(f"Alpha: {best[0]:f}" in sel.stdout,
          f"select_lm_params picked another row:\n{sel.stdout}")
    print(f"lm tuner: search_lm_params grid 2 x 2, device beam, flagship bf16, 4 WAVs: exit 0 in "
          f"{tune_s!r} s, trials {trials}; select_lm_params picked alpha {best[0]} beta {best[1]}")


def phase_lm(torch, np, state, model_cfg, gpu_name):
    """21: n-gram LM decoding (formats, scoring, the LM scan on K6,
    evaluation, serving, the tuner)."""
    from dsjax_torch.config import SpectConfig
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.model.convert import from_reference_state_dict, save_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        arpa, binary, packed, formats = phase_lm_formats(torch, np, tmp)
        scan = phase_lm_scan(torch, np, packed)
        del packed
        path = os.path.join(tmp, "flagship.pt")
        save_checkpoint(path, from_reference_state_dict(state), model_cfg, SpectConfig(),
                        DEFAULT_LABELS)
        manifest = eval_corpus(np, tmp)
        runs = phase_lm_evaluation(torch, np, path, manifest, arpa, model_cfg, gpu_name)
        phase_lm_serving(torch, np, path, arpa, binary, gpu_name)
        phase_lm_tuner(np, path, tmp, arpa)
    return {"formats": formats, "scan": scan, "evaluation": runs}


AUG_UTTS, AUG_VAL_UTTS = 2 * TRAIN_B, 16       # one epoch of 2 steps, one validation forward
AUG_MASKS = (TRAIN_B, 161, 1024)                # (B, F, T) of a training batch's features
# (sample rate, seconds) of the noise WAVs: shorter and longer than an utterance
AUG_NOISE = ((8000, 3.0), (16000, 6.5), (16000, 14.0), (8000, 21.0))
AUG_STEP_REPS = 3


@contextlib.contextmanager
def timed_parts(ds, totals):
    """Add each augmentation part's seconds, as ``ds.__getitem__`` calls it,
    to totals: tempo/gain, noise, STFT and host SpecAugment."""
    from dsjax_torch.audio import augment

    def timer(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            totals[name] = totals.get(name, 0.0) + time.perf_counter() - t0
            return out
        return run

    saved = augment.random_tempo_gain, augment.spec_augment, ds.augment.noise, ds.extractor
    augment.random_tempo_gain = timer("tempo", saved[0])
    augment.spec_augment = timer("spec_augment", saved[1])
    ds.augment.noise, ds.extractor = timer("noise", saved[2]), timer("stft", saved[3])
    try:
        yield
    finally:
        augment.random_tempo_gain, augment.spec_augment = saved[:2]
        ds.augment.noise, ds.extractor = saved[2:]


def host_batch(pipe, totals):
    """TRAIN_B items of pipe's dataset loaded serially through __getitem__
    (parts timed into totals), collated as the pipeline collates them."""
    ds = pipe.dataset
    items = []
    with timed_parts(ds, totals):
        t0, c0 = time.perf_counter(), time.thread_time()
        for i in range(TRAIN_B):
            items.append(ds[i])
        totals["item"] = time.perf_counter() - t0
        totals["item_cpu"] = time.thread_time() - c0
    return pipe._collate(items, TRAIN_B)


@contextlib.contextmanager
def path_scans(seen):
    """Record in seen, for each GRU kernel the enclosed path launches on the
    card (K4, K4 with residuals, K5), each distinct (directions, T, B, H,
    dtype, reverse) it ran at, with the first such call's mask."""
    from dsjax_torch.ops import gru

    saved = gru.gru_scan_fwd, gru.gru_scan_bwd

    def keep(name, x, gates, mask, reverse):
        if x.is_cuda:
            key = (*x.shape[:3], x.shape[3] // gates, x.dtype, tuple(reverse))
            seen.setdefault(name, {}).setdefault(key, mask.clone())

    def fwd(xp, mask, w_hh, b_hh, h0, reverse, save_residuals=False):
        keep("gru_fwd_residuals" if save_residuals else "gru_fwd", xp, 3, mask, reverse)
        return saved[0](xp, mask, w_hh, b_hh, h0, reverse, save_residuals=save_residuals)

    def bwd(g_seq, mask, w_hh, h_prev, dy, dh_t, reverse):
        keep("gru_bwd", g_seq, 4, mask, reverse)
        return saved[1](g_seq, mask, w_hh, h_prev, dy, dh_t, reverse)

    gru.gru_scan_fwd, gru.gru_scan_bwd = fwd, bwd
    try:
        yield
    finally:
        gru.gru_scan_fwd, gru.gru_scan_bwd = saved


def hold_path_scans(torch, np, seen):
    """Each GRU kernel at every shape seen on the path (path_scans), on
    seeded inputs at phases 14's and 15's scales with the path's own masks,
    against its plain version; returns {kernel: (max_abs_err, shapes)}."""
    from dsjax_torch.ops import gru
    from dsjax_torch.ops.lstm import _carried_h_prev

    rng = np.random.default_rng(23)
    result = {}
    for name, calls in seen.items():
        err, shapes = 0.0, []
        for (n_dir, n_t, n_b, n_h, dtype, reverse), mask in calls.items():
            dname = str(dtype).split(".")[1]

            def dev(*shape, scale):
                return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
                    np.float32)).to(mask.device, dtype)

            xp, w, b = (dev(n_dir, n_t, n_b, 3 * n_h, scale=0.3),
                        dev(n_dir, 3 * n_h, n_h, scale=0.03), dev(n_dir, 3 * n_h, scale=0.1))
            h0 = dev(n_dir, n_b, n_h, scale=0.1)
            args = (xp, mask, w, b, h0, reverse)
            what = f"{name} {dname} on the path's (D, T, B, H) = ({n_dir}, {n_t}, {n_b}, {n_h})"
            if name == "gru_fwd":
                out, ref, tol = gru.gru_scan(*args), gru.gru_scan_reference(*args), TOLERANCE
            elif name == "gru_fwd_residuals":
                out = gru.gru_scan_fwd(*args, save_residuals=True)
                ref, tol = gru.gru_scan_reference(*args, save_residuals=True), TOLERANCE
            else:
                y, _, g_seq = gru.gru_scan_reference(*args, save_residuals=True)
                bwd_args = (g_seq, mask, w, _carried_h_prev(y, mask, h0, reverse),
                            dev(n_dir, n_t, n_b, n_h, scale=1.0), dev(n_dir, n_b, n_h, scale=1.0),
                            reverse)
                out = gru.gru_scan_bwd(*bwd_args)
                ref, tol = gru.gru_scan_backward_reference(*bwd_args), BWD_TOLERANCE
            torch.cuda.synchronize()
            err = max(err, check_all(torch, out, ref, tol[dname], what))
            shapes.append((n_dir, n_t, n_b, n_h, dname))
        result[name] = (err, sorted(shapes))
    return result


@contextlib.contextmanager
def loader_items(records):
    """Append (thread, wall s, that thread's CPU s) to records for each
    augmented item the enclosed run loads through
    SpectrogramDataset.__getitem__."""
    from dsjax_torch.data.dataset import SpectrogramDataset

    saved = SpectrogramDataset.__getitem__

    def timed(self, index):
        if self.augment is None:
            return saved(self, index)
        w0, c0 = time.perf_counter(), time.thread_time()
        out = saved(self, index)
        records.append((threading.get_ident(), time.perf_counter() - w0,
                        time.thread_time() - c0))
        return out

    SpectrogramDataset.__getitem__ = timed
    try:
        yield
    finally:
        SpectrogramDataset.__getitem__ = saved


def step_alone_ms(torch, trainer, state, batch):
    """Median wall ms of trainer.train_step on a loaded batch (its copy to
    the card included), each ended by a synchronize, after one warm-up."""
    times = []
    for _ in range(AUG_STEP_REPS + 1):
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        check(bool(torch.isfinite(loss)), f"step alone: loss {float(loss)}")
    return statistics.median(times[1:])


def phase_augmented_training(torch, np, gpu_name, card):
    """22: BASELINE.json config #4 with augmentation (the masks on the card, then
    workflows.train on the host route and on the device route under
    trainer.profile, then its GRU kernels at the shapes those runs gave
    them); returns ({route: {kernel: launches}}, hold_path_scans' result)."""
    import warnings

    from dsjax_torch.audio import augment
    from dsjax_torch.audio.io import save_wav
    from dsjax_torch.config import TrainConfig, compose
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.train.loop import Trainer
    from dsjax_torch.workflows import _pipelines, train
    from tests.synthetic_manifest import write_manifest

    t_phase = time.perf_counter()
    # (a) the masks on the card against the CPU's from the same uniforms
    b, f_dim, t_dim = AUG_MASKS
    rng = np.random.default_rng(22)
    spec = torch.from_numpy(rng.standard_normal(AUG_MASKS).astype(np.float32))
    valid = torch.from_numpy(np.concatenate([[t_dim, 1, 69, 2], rng.integers(
        1, t_dim + 1, b - 4)]).astype(np.int32))
    spec_d, valid_d = spec.cuda(), valid.cuda()
    draws = augment.device_mask_draws(b, 1, 1, augment.step_generator(7, 0, "cuda"), "cuda")
    check(all(d.is_cuda and d.dtype == torch.float32 for d in draws), "draws off the card")
    got = augment.device_masks(spec_d, valid_d, *draws)
    want = augment.device_masks(spec, valid, *(d.cpu() for d in draws))
    check(bits_equal(torch, got.cpu(), want), "device masks: the card's differ from the CPU's")
    zeroed = int((want == 0).sum())
    check(zeroed > 0, "device masks masked nothing")
    again = augment.spec_augment_device(spec_d, valid_d, augment.step_generator(7, 0, "cuda"))
    later = augment.spec_augment_device(spec_d, valid_d, augment.step_generator(7, 1, "cuda"))
    check(bits_equal(torch, again, got), "the same (seed, step) gave other masks")
    check(not torch.equal(later, got), "the next step gave the same masks")
    mask_ms = cuda_time(lambda: augment.spec_augment_device(
        spec_d, valid_d, augment.step_generator(7, 0, "cuda")), 20)
    print(f"augmentation masks on {gpu_name} ({card}): (B, F, T) = {AUG_MASKS}, ragged valid "
          f"frames: bit for bit equal to the CPU's from the same uniforms ({zeroed} of "
          f"{spec.numel()} values zeroed); same (seed, step) equal, the next step differs; "
          f"spec_augment_device {mask_ms!r} ms a batch (seeding and draws included)")

    labels = list(DEFAULT_LABELS)
    runs, seen = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        train_path = write_manifest(tmp, "train", [TRAIN_SECONDS] * AUG_UTTS, seed=40)
        val_path = write_manifest(tmp, "val", list(rng.uniform(3.0, TRAIN_SECONDS,
                                                               AUG_VAL_UTTS)), seed=41)
        noise_dir = os.path.join(tmp, "noise")
        os.makedirs(noise_dir)
        for i, (sr, seconds) in enumerate(AUG_NOISE):
            save_wav(os.path.join(noise_dir, f"noise_{i}.wav"),
                     (0.2 * rng.standard_normal(int(sr * seconds))).astype(np.float32), sr)
        data_s = time.perf_counter() - t0
        base = [f"data.train_path={train_path}", f"data.val_path={val_path}",
                "model=unidirectional", "model.rnn_type=gru", "trainer.precision=16",
                f"data.batch_size={TRAIN_B}", "data.num_workers=4", "trainer.device=cuda",
                "trainer.devices=1", "trainer.max_epochs=1", "trainer.log_every_n_steps=1",
                "trainer.enable_checkpointing=false",
                f"checkpoint.dirpath={os.path.join(tmp, 'ckpt')}",
                "data.augmentation.speed_volume_perturb=true",
                f"data.augmentation.noise_dir={noise_dir}", "data.augmentation.noise_prob=1.0",
                "data.augmentation.spec_augment=true"]
        profiles = os.path.join(tmp, "profiles")
        routes = {"host": [], "device": [
            "data.device_features=true", "data.augmentation.spec_augment_device=true",
            "trainer.profile=true", "trainer.profile_start_step=0",
            "trainer.profile_num_steps=1", f"trainer.profile_dir={profiles}"]}
        for route, extra in routes.items():
            log_dir = os.path.join(tmp, f"logs_{route}")
            cfg = compose(TrainConfig, base + extra + [f"trainer.log_dir={log_dir}"])
            train_pipe = _pipelines(cfg, labels)[0]
            check(train_pipe.dataset.device_features == (route == "device"),
                  f"{route} route: device_features {train_pipe.dataset.device_features}")
            items = []
            reset_counts()
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught, path_scans(seen), \
                    loader_items(items):
                warnings.simplefilter("always")
                state = train(cfg)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            counts = read_counts()
            warned = any("time warp" in str(w.message) for w in caught)
            check(warned == (route == "device"), f"{route} route: time warp warning {warned}")
            layers = cfg.model.hidden_layers
            steps, val_forwards = -(-AUG_UTTS // TRAIN_B), -(-AUG_VAL_UTTS // TRAIN_B)
            launches = {k: counts[k] for k in ("gru_fwd", "gru_fwd_residuals", "gru_bwd")}
            check(state.step == steps, f"{route} route: {state.step} steps, expected {steps}")
            check(not state.model.bidirectional and all(
                len(m.reverse) == 1 for m in state.model.modules() if hasattr(m, "reverse")),
                f"{route} route: a layer runs two directions")
            check(launches == {"gru_fwd": layers * val_forwards,
                               "gru_fwd_residuals": layers * steps, "gru_bwd": layers * steps}
                  and sum(counts.values()) == sum(launches.values()) + counts["gru_steps"],
                  f"{route} route: launches {counts} for {steps} steps and {val_forwards} "
                  f"validation forwards of {layers} one-direction GRU layers")
            records = [json.loads(line) for line in open(os.path.join(log_dir, "metrics.jsonl"))]
            losses = [r["loss"] for r in records if "loss" in r]
            check(len(losses) == steps and all(np.isfinite(losses)), f"{route}: losses {losses}")
            # seconds from the loop's start to each step's end (StepTimer's
            # utt/s over all steps so far): the first waits for the loader
            loop_s = [(k + 1) * TRAIN_B / r["utt_per_sec"]
                      for k, r in enumerate(r for r in records if "loss" in r)]
            step_ms = [1e3 * (b2["time"] - a2["time"]) for a2, b2 in zip(records, records[1:])
                       if "loss" in a2 and "loss" in b2]
            trace = None
            if route == "device":
                names = os.listdir(profiles)
                check(len(names) == 1, f"device route: trace files {names}")
                trace = os.path.join(profiles, names[0])
                with open(trace) as f:
                    events = json.load(f)["traceEvents"]
                spans = sorted(e["name"] for e in events if e.get("cat") == "user_annotation"
                               and e["name"].startswith("train_step"))
                check(spans == ["train_step 0", "train_step 1"], f"trace spans {spans}")
                trace = (names[0], os.path.getsize(trace), spans,
                         sum(e.get("cat") == "kernel" for e in events))
            parts = {}
            batch = host_batch(train_pipe, parts)
            check((batch.inputs is None) == (route == "device"), f"{route}: batch kind")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")   # the time warp warning, checked above
                trainer = Trainer(cfg, labels)
            alone = step_alone_ms(torch, trainer, state, batch)
            check(len(items) == AUG_UTTS, f"{route}: {len(items)} augmented items loaded")
            runs[route] = {"launches": launches, "losses": losses, "step_ms": step_ms,
                           "loop_s": loop_s, "items": items,
                           "alone_ms": alone, "parts": parts, "train_s": train_s,
                           "trace": trace}

    held = hold_path_scans(torch, np, seen)
    check(sorted(held) == ["gru_bwd", "gru_fwd", "gru_fwd_residuals"],
          f"the augmented path ran GRU kernels {sorted(held)}")
    for name, (err, shapes) in sorted(held.items()):
        print(f"kernel {name} at the augmented path's shapes (D, T, B, H, dtype) {shapes}, seeded "
              f"inputs, the path's masks: max_abs_err {err!r} against its plain version")
    model = (f"{cfg.model.hidden_layers}x GRU-{cfg.model.hidden_size} + Lookahead "
             f"{cfg.model.lookahead_context}, bf16")
    for route, r in runs.items():
        parts = r["parts"]
        item_ms = 1e3 * parts["item"]
        split = ", ".join(f"{k} {1e3 * v!r} ms" for k, v in parts.items()
                          if k not in ("item", "item_cpu"))
        rest = item_ms - 1e3 * sum(v for k, v in parts.items() if k not in ("item", "item_cpu"))
        per_thread = {}
        for thread, wall, cpu in r["items"]:
            per_thread.setdefault(thread, []).append((wall, cpu))
        loader = "; ".join(
            f"{len(v)} items, wall {1e3 * statistics.mean(w for w, _ in v)!r} ms and CPU "
            f"{1e3 * statistics.mean(c for _, c in v)!r} ms an item"
            for v in per_thread.values())
        print(f"augmented training, {route} route on {gpu_name} ({card}): {model}, "
              f"B={TRAIN_B} x {TRAIN_SECONDS} s before tempo, "
              f"{len(r['losses'])} steps: step median {statistics.median(r['step_ms'])!r} ms "
              f"of {r['step_ms']} (between loss syncs, loader waits included"
              f"{', under the profiler' if r['trace'] else ''}); the loop's start to each "
              f"step's end {r['loop_s']} s, {r['loop_s'][-1] / len(r['loop_s'])!r} s a step "
              f"over the loop; the step alone on a loaded "
              f"batch {r['alone_ms']!r} ms (median of {AUG_STEP_REPS}); losses {r['losses']}; "
              f"launches {r['launches']}; run {r['train_s']!r} s; host work of one batch of "
              f"{TRAIN_B} items, serially through __getitem__: {item_ms!r} ms ({split}, "
              f"loading and the rest {rest!r} ms; the thread's CPU "
              f"{1e3 * parts['item_cpu']!r} ms), {item_ms / r['alone_ms']!r} x the step alone; "
              f"the run's loader threads, each item through __getitem__: {loader}"
              + (f"; trace {r['trace'][0]} ({r['trace'][1]} bytes, spans {r['trace'][2]}, "
                 f"{r['trace'][3]} kernel events)" if r["trace"] else ""))
    print(f"phase 22: corpus and noise written in {data_s!r} s; phase wall "
          f"{time.perf_counter() - t_phase!r} s")
    return {route: r["launches"] for route, r in runs.items()}, held


# phase 23: the DDP path. (a) one NCCL rank in this process at phase 8's
# size; (b) torchrun's entry point at phase 9's; (c) two gloo ranks on the
# one card at phase 9's, held against the union batch (tests/torch_ddp_worker.py)
DDP_HIDDEN = 256
TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT")
DDP_LOSS_RTOL = 1e-5          # phase 9's loss tolerance (card against CPU)
DDP_STATS_TOL = (1e-5, 1e-4)  # (atol, rtol) tests/test_torch_train.py's running stats
# (a): the bf16 step's gradients are not repeatable on the card
# (F.ctc_loss's CUDA backward accumulates with atomics, and the bf16
# backward rounds what it is handed), so the DDP run's gradients and losses
# are held to the plain runs' own spread: every DDP run within GRAD_SPREAD
# (gradients) or LOSS_SPREAD (the epoch's losses) x the largest distance
# between two plain runs of its nearest plain run (bit for bit where the
# plain runs repeat bit for bit). The distances between gradient vectors of
# millions of entries concentrate; those between two later losses do not,
# so the losses take more plain runs and a wider factor, lest the check
# fail by chance
DDP_GRAD_RUNS, GRAD_SPREAD = 3, 2.0
DDP_PLAIN_EPOCHS, LOSS_SPREAD = 5, 3.0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def torchrun_environment(**env):
    """torchrun's variables set in this process for the block, restored after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def without_torchrun_env():
    return {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}


def metrics_steps(np, path):
    """(losses, step ms between consecutive loss syncs of an epoch) of a
    metrics.jsonl."""
    records = [json.loads(line) for line in open(path)]
    losses = [r["loss"] for r in records if "loss" in r]
    step_ms = [1e3 * (b["time"] - a["time"]) for a, b in zip(records, records[1:])
               if "loss" in a and "loss" in b and a["epoch"] == b["epoch"]]
    check(len(losses) > 0 and all(np.isfinite(losses)), f"losses {losses} in {path}")
    return losses, step_ms


def phase_ddp_one_rank(torch, np, gpu_name, card, tmp):
    """23(a): workflows.train under torchrun's environment for one NCCL rank,
    in this process (so the launch counters see it): the flagship in bf16 at
    B=64, T=1024, one epoch of 3 steps with validation and a checkpoint,
    after one plain single-process run of the same batches and before
    DDP_PLAIN_EPOCHS - 1 more."""
    from dsjax_torch import workflows
    from dsjax_torch.config import TrainConfig, compose
    from dsjax_torch.inference import load_model
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.train.checkpoint import CheckpointHandler
    from dsjax_torch.train.loop import Trainer
    from tests.synthetic_manifest import write_manifest

    rng = np.random.default_rng(3)
    train_path = write_manifest(tmp, "train", [TRAIN_SECONDS] * TRAIN_UTTS, seed=4)
    val_path = write_manifest(tmp, "val", list(rng.uniform(3.0, TRAIN_SECONDS, VAL_UTTS)),
                              seed=5)
    base = [f"data.train_path={train_path}", f"data.val_path={val_path}",
            "data.device_features=false", f"data.batch_size={TRAIN_B}", "data.num_workers=4",
            "trainer.precision=16", "trainer.device=cuda", "trainer.devices=1",
            "trainer.max_epochs=1", "trainer.log_every_n_steps=1"]
    runs = {}

    def plain(name):
        log_dir = os.path.join(tmp, f"logs_{name}")
        workflows.train(compose(TrainConfig, base + [
            f"trainer.log_dir={log_dir}", "trainer.limit_val_batches=0",
            "trainer.enable_checkpointing=false",
            f"checkpoint.dirpath={os.path.join(tmp, 'ckpt_' + name)}"]))
        torch.cuda.synchronize()
        runs[name] = metrics_steps(np, os.path.join(log_dir, "metrics.jsonl"))

    seen = {}

    class Recording(Trainer):
        def fit(self, *args, **kwargs):
            seen.update(backend=torch.distributed.get_backend(),
                        world=torch.distributed.get_world_size(), device=str(self.device))
            state = super().fit(*args, **kwargs)
            seen.update(wrapper=type(self._ddp).__name__,
                        wraps_the_state_model=self._ddp.module is state.model)
            return state

    plain("plain_0")
    ckpt = os.path.join(tmp, "ckpt_ddp")
    cfg = compose(TrainConfig, base + [f"trainer.log_dir={os.path.join(tmp, 'logs_ddp')}",
                                       f"checkpoint.dirpath={ckpt}"])
    workflows.Trainer = Recording
    try:
        with torchrun_environment(WORLD_SIZE=1, RANK=0, LOCAL_RANK=0, LOCAL_WORLD_SIZE=1,
                                  MASTER_ADDR="127.0.0.1", MASTER_PORT=free_port()):
            reset_counts()
            t0 = time.perf_counter()
            state = workflows.train(cfg)
            torch.cuda.synchronize()
            ddp_s = time.perf_counter() - t0
            counts = read_counts()
    finally:
        workflows.Trainer = Trainer
    check(not torch.distributed.is_initialized(), "workflows.train left its group open")
    runs["ddp"] = metrics_steps(np, os.path.join(tmp, "logs_ddp", "metrics.jsonl"))
    for i in range(1, DDP_PLAIN_EPOCHS):
        plain(f"plain_{i}")
    check(seen == {"backend": "nccl", "world": 1, "device": "cuda:0",
                   "wrapper": "DistributedDataParallel", "wraps_the_state_model": True},
          f"the DDP run: {seen}")
    layers, steps = cfg.model.hidden_layers, -(-TRAIN_UTTS // TRAIN_B)
    val_forwards = -(-VAL_UTTS // TRAIN_B)
    launches = {k: counts[k] for k in ("lstm_fwd", "lstm_fwd_residuals", "lstm_bwd")}
    # phase 8's counts for one epoch: a launch a layer a step and a layer a
    # validation forward
    check(state.step == steps and launches == {
        "lstm_fwd": layers * val_forwards, "lstm_fwd_residuals": layers * steps,
        "lstm_bwd": layers * steps}
        and sum(counts.values()) == sum(launches.values()) + counts["lstm_steps"],
        f"DDP run: {state.step} steps, launches {counts}")

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    ld, msd = runs.pop("ddp")
    plain_losses = [l for l, _ in runs.values()]
    check(all(len(l) == steps for l in plain_losses + [ld]), f"losses {plain_losses} {ld}")
    # the first step's loss is the forward of the same weights and batch
    check(all(l[0] == ld[0] for l in plain_losses),
          f"first-step losses {ld[0]}, {[l[0] for l in plain_losses]}")
    loss_spread = max(rel(a, b) for i, a in enumerate(plain_losses)
                      for b in plain_losses[i + 1:])
    loss_nearest = min(rel(ld, l) for l in plain_losses)
    check(loss_nearest <= LOSS_SPREAD * loss_spread,
          f"DDP losses {ld} {loss_nearest} from the nearest plain run's; plain runs "
          f"{plain_losses} up to {loss_spread} apart")
    grads = ddp_gradient_spread(torch, cfg, list(DEFAULT_LABELS))

    trainer = Trainer(cfg, list(DEFAULT_LABELS))
    batch = next(iter(workflows._pipelines(cfg, list(DEFAULT_LABELS))[1]))
    want, want_lens = trainer.eval_step(state, batch)
    path = CheckpointHandler(ckpt).path()
    got, got_lens, _ = load_model(path, precision=16, device="cuda:0").forward(
        batch.inputs, batch.input_lengths)
    torch.cuda.synchronize()
    check(torch.equal(got_lens, want_lens), "out_lens of the DDP checkpoint differ")
    load_err = (got - want).abs().max().item()
    check(load_err <= 1e-6, f"the DDP checkpoint's posteriors differ by {load_err}")
    plain_ms_runs = [ms for _, ms in runs.values()]
    ddp_ms, plain_ms = statistics.median(msd), statistics.median(sum(plain_ms_runs, []))
    print(f"DDP, one NCCL rank on {gpu_name} ({card}): {seen}; 5x BiLSTM-1024 bf16, "
          f"B={TRAIN_B} x {TRAIN_SECONDS} s, {steps} steps: step median {ddp_ms!r} ms of "
          f"{msd} against the plain process's {plain_ms!r} ms of {plain_ms_runs} "
          f"({ddp_ms / plain_ms!r} x; metrics.jsonl, between loss syncs); losses {ld} against "
          f"{plain_losses}: the first step's bit for bit, then {loss_nearest!r} from the "
          f"nearest plain run (largest relative step difference; <= {LOSS_SPREAD} x "
          f"{loss_spread!r}, the plain runs' largest distance; Adam's first step, about "
          f"lr x sign(g), magnifies the gradients' run-to-run spread); "
          f"{grads}; launches {launches}; run {ddp_s!r} s; checkpoint loaded with load_model: "
          f"posteriors max_abs_err {load_err!r} (<= 1e-6)")
    return launches


def ddp_gradient_spread(torch, cfg, labels):
    """grad_step on the first training batch from the seeded weights,
    DDP_GRAD_RUNS times in one process and as many as one NCCL rank; every
    DDP run's gradients within GRAD_SPREAD x the largest distance between two
    plain runs of the nearest plain run's (relative L2 over all parameters),
    and every loss bit for bit equal. Returns what it saw."""
    from dsjax_torch import workflows
    from dsjax_torch.parallel import distributed
    from dsjax_torch.train.loop import Trainer

    batch = next(iter(workflows._pipelines(cfg, labels)[0]))

    def run(ddp):
        env = dict(WORLD_SIZE=1, RANK=0, LOCAL_RANK=0, LOCAL_WORLD_SIZE=1,
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=free_port()) if ddp else {}
        with torchrun_environment(**env):
            joined = distributed.initialize("cuda") if ddp else False
            try:
                trainer = Trainer(cfg, labels)
                grads, loss = trainer.grad_step(trainer.init_state(), batch)
                check(ddp == (trainer._ddp is not None), f"DDP wrapper {trainer._ddp}")
                flat = torch.cat([g.float().flatten() for g in grads.values()])
                torch.cuda.synchronize()
            finally:
                if joined:
                    distributed.destroy()
        return flat, float(loss)

    plain = [run(False) for _ in range(DDP_GRAD_RUNS)]
    ddp = [run(True) for _ in range(DDP_GRAD_RUNS)]

    def dist(a, b):
        return float((a[0] - b[0]).norm() / b[0].norm())

    def spread(runs):
        return max(dist(a, b) for i, a in enumerate(runs) for b in runs[i + 1:])

    within = spread(plain)
    nearest = [min(dist(d, p) for p in plain) for d in ddp]
    losses = {r[1] for r in plain + ddp}
    check(len(losses) == 1, f"grad_step losses {sorted(losses)}")
    check(max(nearest) <= GRAD_SPREAD * within,
          f"DDP gradients {nearest} from the nearest plain run's; plain runs up to "
          f"{within} apart")
    return (f"gradients of the first batch, {DDP_GRAD_RUNS} plain and {DDP_GRAD_RUNS} DDP "
            f"runs: plain runs up to {within!r} apart, DDP runs {spread(ddp)!r} "
            f"(relative L2), each DDP run {nearest} from its nearest plain run (<= "
            f"{GRAD_SPREAD} x {within!r}); loss {losses.pop()!r} in all")


def phase_ddp_torchrun(np, gpu_name, card, tmp):
    """23(b): ``python -m torch.distributed.run --standalone --nproc_per_node 1
    -m dsjax_torch.train`` at phase 9's size trains an epoch and writes a
    checkpoint."""
    from dsjax_torch.train.checkpoint import CheckpointHandler
    from tests.synthetic_manifest import write_manifest

    path = write_manifest(tmp, "small", [2.0, 3.1, 2.6, 1.4, 3.5, 2.2, 0.8, 2.9] * 2, seed=6)
    ckpt = os.path.join(tmp, "ckpt_torchrun")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
         "-m", "dsjax_torch.train", f"data.train_path={path}", f"data.val_path={path}",
         "data.batch_size=8", "data.device_features=false", f"model.hidden_size={DDP_HIDDEN}",
         "model.hidden_layers=2", "trainer.precision=32", "trainer.device=cuda",
         "trainer.max_epochs=1", "trainer.log_every_n_steps=1", f"checkpoint.dirpath={ckpt}",
         f"trainer.log_dir={os.path.join(tmp, 'logs_torchrun')}"],
        cwd=ROOT, env=without_torchrun_env(), capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"torchrun: rc {out.returncode}\n{out.stdout[-2000:]}\n"
                               f"{out.stderr[-4000:]}")
    ends = re.findall(r"^epoch 0: loss (\S+) wer (\S+) cer (\S+)", out.stdout, re.M)
    check(len(ends) == 1 and np.isfinite(float(ends[0][0])), f"torchrun output:\n{out.stdout}")
    handler = CheckpointHandler(ckpt)
    check(handler.latest_step() == 2, f"torchrun checkpoint at step {handler.latest_step()}")
    print(f"DDP through torchrun on {gpu_name} ({card}), one rank, H={DDP_HIDDEN} x 2 layers "
          f"f32, B=8: 2 steps, epoch loss/wer/cer {ends[0]}, checkpoint "
          f"{os.path.relpath(handler.path(), tmp)}; {wall!r} s with the launcher's start")


def phase_ddp_two_ranks(torch, np, gpu_name, card, tmp):
    """23(c): two gloo ranks sharing the card (NCCL refuses two ranks on one
    device), each with LOCAL_RANK=0, H=256 x 2 layers f32, B=4 a rank with
    rank 0's rows padded to 64 frames and rank 1's to 48, TF32 off: against
    one process on the union batch on the card."""
    from dsjax_torch.config import TrainConfig, compose
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.train.loop import Trainer
    from tests import torch_ddp_worker as worker

    argv = worker.cfg_argv(DDP_HIDDEN, "cuda")
    weights = Trainer(compose(TrainConfig, worker.cfg_argv(DDP_HIDDEN, "cpu")),
                      list(DEFAULT_LABELS)).init_state(seed=0).model.state_dict()
    weights_path = os.path.join(tmp, "ddp_weights.pt")
    torch.save(weights, weights_path)
    port = free_port()
    procs = []
    t0 = time.perf_counter()
    for r in range(2):
        env = dict(without_torchrun_env(), WORLD_SIZE="2", RANK=str(r), LOCAL_RANK="0",
                   LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_ddp_worker.py"),
             "--weights", weights_path, "--out", os.path.join(tmp, f"rank{r}.pt"),
             "--device", "cuda", "--backend", "gloo", "--hidden", str(DDP_HIDDEN), "--fp32"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0 and "DONE" in log, f"rank {r}: rc {p.returncode}\n{log[-4000:]}")
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    ref = worker.reference(argv, weights)
    errs = {}
    for out in ranks:
        check((out["world"], out["backend"], out["device"], out["ddp_wrapped"])
              == (2, "gloo", "cuda:0", "DistributedDataParallel"), f"rank {out['rank']}: {out}")
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(
            [out["grad"]["loss"]] + out["losses"], [ref["grad"]["loss"]] + ref["losses"]))
        check(loss_err <= DDP_LOSS_RTOL, f"rank {out['rank']}: losses {out['losses']} against "
                                         f"{ref['losses']}")
        # gradients and the SGD steps' updates, each within STEP_TOL x its
        # largest magnitude (phase 9's, cuDNN's algorithms differ by batch)
        for what, got, want in (
                ("gradient", out["grad"]["grads"], ref["grad"]["grads"]),
                ("update", {k: v - weights[k] for k, v in out["params"].items()},
                 {k: v - weights[k] for k, v in ref["params"].items()})):
            for k, w in want.items():
                e = float((got[k] - w).abs().max() / max(float(w.abs().max()), 1e-30))
                check(e <= STEP_TOL, f"rank {out['rank']}: {what} {k} {e} x its largest")
                errs[what] = max(errs.get(what, 0.0), e)
        for k, w in ref["buffers"].items():
            check(bool(torch.allclose(out["buffers"][k], w, atol=DDP_STATS_TOL[0],
                                      rtol=DDP_STATS_TOL[1])), f"running stat {k}")
            errs["stats"] = max(errs.get("stats", 0.0),
                                float((out["buffers"][k] - w).abs().max()))
        check(torch.equal(out["masks"], ref["masks"][out["rank"] * worker.ROWS:
                                                     (out["rank"] + 1) * worker.ROWS]),
              "device masks")
        errs["loss"] = max(errs.get("loss", 0.0), loss_err)
    check(all(torch.equal(ranks[0]["buffers"][k], ranks[1]["buffers"][k])
              for k in ranks[0]["buffers"]), "running stats differ across the ranks")
    print(f"DDP, two gloo ranks sharing {gpu_name} ({card}), H={DDP_HIDDEN} x 2 layers f32, "
          f"B=4 a rank (64 and 48 frames), TF32 off, against one process on the union batch: "
          f"losses {ranks[0]['losses']} ({ref['losses']}), max relative {errs['loss']!r} "
          f"(<= {DDP_LOSS_RTOL}); gradients {errs['gradient']!r} and SGD updates "
          f"{errs['update']!r} x their largest (<= {STEP_TOL}); running stats max_abs_err "
          f"{errs['stats']!r} (atol {DDP_STATS_TOL[0]}, rtol {DDP_STATS_TOL[1]}), equal across "
          f"the ranks; WER/CER {[r['wer_cer'] for r in ranks]} ({ref['wer_cer']}); device "
          f"SpecAugment masks equal to the union batch's rows; {wall!r} s for both "
          f"processes (a correctness run, not a scaling number: gloo stages every CUDA "
          f"collective through the host)")


def phase_ddp_training(torch, np, gpu_name, card, full_fp32, defaults_back):
    """23: the DDP path, (a) and (b) at PyTorch's defaults, (c) with TF32
    off; returns (a)'s {kernel: launches}."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_ddp_one_rank(torch, np, gpu_name, card, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        phase_ddp_torchrun(np, gpu_name, card, tmp)
        full_fp32()
        try:
            phase_ddp_two_ranks(torch, np, gpu_name, card, tmp)
        finally:
            defaults_back()
    print(f"phase 23: wall {time.perf_counter() - t0!r} s")
    return launches


# phase 24: data-parallel inference in one process. Every visible card when
# there are two or more, else two replicas sharing cuda:0 (their launches run
# in turn on its current stream: the path is driven, not scaled)
DP_UTTS, DP_SECONDS = EVAL_BATCH, (9.5, 10.5)   # evaluation's batch of ~10 s utterances
DP_EVAL_UTTS = 24                               # two evaluation batches, the second padded
DP_TIME_REPS = 5


def dp_audio(np, spect_cfg, seconds, rng):
    """(B, L_pad) int16 audio of synthetic utterances and their frame counts,
    padded to the longest, as evaluation's raw-audio batches."""
    from dsjax_torch.audio.features import pad_audio_for_device

    ys = [synth(rng, np, s) for s in seconds]
    n_valid = np.array([pad_audio_for_device(y, spect_cfg)[1] for y in ys], np.int32)
    items = [pad_audio_for_device(y, spect_cfg, int(n_valid.max())) for y in ys]
    return (np.stack([np.clip(np.rint(yp * 32768.0), -32768, 32767).astype(np.int16)
                      for yp, _ in items]), n_valid)


def dp_strings(torch, decoder, probs, lens):
    """Top strings of one decode, with the launch counts it made."""
    reset_counts()
    strings = [s[0] for s in decoder.decode(probs, lens, n_best=1)[0]]
    torch.cuda.synchronize()
    return strings, read_counts()


def dp_batch_ms(torch, bundles, audio, n_valid, decoder):
    """For each bundle, CUDA-event ms (the longest span over its cards) and
    wall ms of one evaluation batch: the raw-audio forward and
    ``decoder``'s decode to strings; medians of DP_TIME_REPS after a
    warm-up, the bundles timed in turns (in reverse order every other rep)
    so that drift in the host's speed falls on both."""
    times = [([], []) for _ in bundles]
    for rep in range(DP_TIME_REPS + 1):
        order = list(enumerate(bundles))
        for i, bundle in order if rep % 2 else order[::-1]:
            devs = list(dict.fromkeys(bundle.devices))
            torch.cuda.synchronize()
            marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                     for _ in devs]
            t0 = time.perf_counter()
            for d, (start, _) in zip(devs, marks):
                start.record(torch.cuda.current_stream(d))
            probs, out_lens, _ = bundle.forward(audio, n_valid)
            decoder.decode(probs, out_lens, n_best=1)
            for d, (_, end) in zip(devs, marks):
                end.record(torch.cuda.current_stream(d))
            torch.cuda.synchronize()
            if rep:
                times[i][1].append((time.perf_counter() - t0) * 1000.0)
                times[i][0].append(max(s.elapsed_time(e) for s, e in marks))
    return [(statistics.median(ev), statistics.median(wall)) for ev, wall in times]


def dp_k1_ms(torch, np, t_dim, rows):
    """K1's CUDA-event median ms, f32, two directions, every row at full
    length, at T = t_dim and B = rows: a shard's scan beside the batch's."""
    from dsjax_torch.ops import lstm

    rng = np.random.default_rng(rows)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to("cuda")
    xp = dev(rng.standard_normal((2, t_dim, rows, 4 * H)) * 0.3)
    w = dev(rng.standard_normal((2, 4 * H, H)) * 0.03)
    b = dev(rng.standard_normal((2, 4 * H)) * 0.1)
    h0 = torch.zeros((2, rows, H), device="cuda")
    mask = torch.ones((t_dim, rows), device="cuda")
    return cuda_time(lambda: lstm.lstm_scan(xp, mask, w, b, h0, h0, (False, True)), 10)


def dp_server(torch, np, path, spec, ys):
    """8 concurrent /transcribe requests to the server on ``spec``'s
    devices, twice: (transcripts, launch counts and latencies of the second
    round; the first pays each card's first use of the requests' shapes)."""
    from dsjax_torch.config import ServerConfig, compose
    from dsjax_torch.server import serve, shutdown

    cfg = compose(ServerConfig, [f"model.model_path={path}", "host=127.0.0.1", "port=0",
                                 f"device={spec}", "max_batch=8", "batch_timeout_ms=2000",
                                 "warmup_seconds=2"])
    server, worker = serve(cfg)
    try:
        port = server.server_address[1]
        results = [None] * len(ys)

        def client(i):
            results[i] = post(port, "/transcribe", ys[i])

        for _ in range(2):
            torch.cuda.synchronize()
            reset_counts()
            threads = [threading.Thread(target=client, args=(i,)) for i in range(len(ys))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
                check(not t.is_alive(), f"a /transcribe request to the server on {spec} hung")
            torch.cuda.synchronize()
            counts = read_counts()
        shards = worker.bundle.shards(len(ys))
    finally:
        shutdown(server, worker)
    for status, payload, _ in results:
        check(status == 200, f"/transcribe on {spec} -> {status} {payload}")
    return ([r[1]["output"][0]["transcription"] for r in results], counts, shards,
            sorted(r[2] for r in results))


def dp_evaluate(torch, path, manifest, spec):
    from dsjax_torch.config import EvalConfig, compose
    from dsjax_torch.workflows import evaluate

    cfg = compose(EvalConfig, [f"model.model_path={path}", f"test_path={manifest}",
                               f"batch_size={EVAL_BATCH}", "num_workers=4", f"device={spec}"])
    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        wer, cer = evaluate(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    hyps = [line for line in lines if line.startswith("Hyp:")]
    check(len(hyps) == DP_EVAL_UTTS, f"evaluate on {spec} printed {len(hyps)} hypotheses")
    return dict(wer=wer, cer=cer, hyps=hyps, counts=read_counts(), wall=wall)


def phase_data_parallel(torch, np, state, model_cfg, gpu_name, card):
    """24: the flagship over the bundle's replicas against one card, TF32
    off: the forward of an evaluation batch, each decoder, the server and
    ``workflows.evaluate``; exact launch counts; the batch's times."""
    from dsjax_torch.config import SpectConfig
    from dsjax_torch.decode.beam_device import DeviceBeamDecoder
    from dsjax_torch.decode.greedy import GreedyDecoder
    from dsjax_torch.decode.native_beam import build_lm_binary
    from dsjax_torch.inference import load_model
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.model.convert import from_reference_state_dict, save_checkpoint
    from tests.synthetic_lm import letter_trigram, write_arpa
    from tests.synthetic_manifest import write_manifest

    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    spec = "cuda" if count >= 2 else "cuda:0,cuda:0"
    layers = model_cfg.hidden_layers
    rng = np.random.default_rng(24)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flagship.pt")
        save_checkpoint(path, from_reference_state_dict(state), model_cfg, SpectConfig(),
                        DEFAULT_LABELS)
        one = load_model(path, 32, "cuda:0")
        dp = load_model(path, 32, spec)
        n = len(dp.devices)
        print(f"data parallel: {count} visible card(s): {n} replicas on "
              f"{[str(d) for d in dp.devices]} ("
              f"{'every visible card' if count >= 2 else 'two replicas sharing one card'})")
        check(n >= 2 and len(one.devices) == 1, f"replicas {dp.devices} and {one.devices}")
        b_dim = -(-DP_UTTS // n) * n
        audio, n_valid = dp_audio(np, dp.spect_cfg, rng.uniform(*DP_SECONDS, b_dim), rng)

        reset_counts()
        probs, out_lens, _ = dp.forward(audio, n_valid)
        torch.cuda.synchronize()
        dp_counts = read_counts()
        reset_counts()
        want, want_lens, _ = one.forward(audio, n_valid)
        torch.cuda.synchronize()
        one_counts = read_counts()
        check(probs.device == out_lens.device == torch.device("cuda:0"),
              f"the data-parallel forward gathered its posteriors on {probs.device}, "
              f"not cuda:0")
        check(dp_counts["lstm_fwd"] == n * layers and one_counts["lstm_fwd"] == layers,
              f"K1 launches {dp_counts['lstm_fwd']} over {n} shards and {one_counts['lstm_fwd']} "
              f"on one card, expected {n * layers} and {layers}")
        check(torch.equal(out_lens, want_lens), "out_lens differ")
        atol, rtol = TOLERANCE["float32"]
        err, ok = within(probs, want, atol, rtol)
        check(ok, f"data-parallel posteriors differ from one card's by {err}")
        t_dim = want.shape[1]
        print(f"data parallel forward on {gpu_name} ({card}): flagship f32 TF32 off, {b_dim} "
              f"utterances of {DP_SECONDS} s (T'={t_dim}) as {n} shards of {b_dim // n}: "
              f"max_abs_err {err!r} against one card (atol {atol}, rtol {rtol}), out_lens "
              f"equal; K1 launches {dp_counts['lstm_fwd']} ({layers} a shard)")

        # the decoders on both forwards' posteriors, each decoded once on cuda:0
        arpa = write_arpa(os.path.join(tmp, "letters.arpa"), letter_trigram(seed=21))
        binary = os.path.join(tmp, "letters.bin")
        build_lm_binary(arpa, binary)
        decoders = {
            "greedy": (GreedyDecoder(DEFAULT_LABELS), "0", (0, 0, 0)),
            "beam, scan with K6": (DeviceBeamDecoder(DEFAULT_LABELS, beam_width=EVAL_WIDTH),
                                   "0", (t_dim + 1, 0, 1)),
            "beam, K7": (DeviceBeamDecoder(DEFAULT_LABELS, beam_width=EVAL_WIDTH), "1",
                         (0, 1, 1)),
            "device LM beam": (DeviceBeamDecoder(DEFAULT_LABELS, beam_width=EVAL_WIDTH,
                                                 lm_path=binary, alpha=LM_ALPHA, beta=LM_BETA),
                               "1", (t_dim + 1, 0, 1)),
        }
        decode_counts = {}
        for name, (decoder, fused, expected) in decoders.items():
            os.environ["DSJAX_FUSED_BEAM"] = fused
            try:
                got, got_counts = dp_strings(torch, decoder, probs, out_lens)
                ref, ref_counts = dp_strings(torch, decoder, want, want_lens)
            finally:
                os.environ.pop("DSJAX_FUSED_BEAM")
            flips = [i for i, (a, b) in enumerate(zip(got, ref)) if a != b]
            check(not flips, f"{name}: the data-parallel strings differ from one card's in rows "
                             f"{flips}: {[(got[i], ref[i]) for i in flips]}")
            for counts in (got_counts, ref_counts):
                have = (counts["topk"], counts["beam_scan"], counts["beam_backtrack"])
                check(have == expected, f"{name}: topk, beam_scan and beam_backtrack launches "
                                        f"{have}, expected {expected}")
            decode_counts[name] = got_counts
            print(f"data parallel {name}: {b_dim} strings identical to one card's; launches "
                  f"(topk, beam_scan, beam_backtrack) {expected}")

        # the server, 8 concurrent requests, against the one-card server
        ys = [synth(rng, np, s) for s in rng.uniform(1.0, 8.0, 8)]
        got, srv_counts, srv_shards, srv_lat = dp_server(torch, np, path, spec, ys)
        ref, _, _, ref_lat = dp_server(torch, np, path, "cuda:0", ys)
        check(got == ref, f"the data-parallel server's transcripts differ from one card's:\n"
                          f"{got}\n{ref}")
        check(srv_counts["lstm_fwd"] == srv_shards * layers,
              f"the server's batch of 8: {srv_counts['lstm_fwd']} K1 launches, expected "
              f"{layers} a shard over {srv_shards}")
        print(f"data parallel server: 8 concurrent /transcribe identical to the one-card "
              f"server's; a batch of 8 in {srv_shards} shards, K1 launches "
              f"{srv_counts['lstm_fwd']}; p50 of a second round {statistics.median(srv_lat)!r} "
              f"ms (one card {statistics.median(ref_lat)!r} ms)")

        # workflows.evaluate, the entry point of python -m dsjax_torch.evaluate
        manifest = write_manifest(tmp, "dp", [round(float(s), 2) for s in
                                              rng.uniform(2.0, 10.0, DP_EVAL_UTTS)], seed=25)
        dp_eval = dp_evaluate(torch, path, manifest, spec)
        one_eval = dp_evaluate(torch, path, manifest, "cuda:0")
        check((dp_eval["wer"], dp_eval["cer"]) == (one_eval["wer"], one_eval["cer"])
              and dp_eval["hyps"] == one_eval["hyps"],
              f"evaluate over {n} replicas: WER/CER {dp_eval['wer'], dp_eval['cer']}, one card "
              f"{one_eval['wer'], one_eval['cer']}")
        batches = -(-DP_EVAL_UTTS // EVAL_BATCH)
        check(dp_eval["counts"]["lstm_fwd"] == batches * n * layers,
              f"evaluate over {n} replicas: {dp_eval['counts']['lstm_fwd']} K1 launches for "
              f"{batches} batches")
        print(f"data parallel evaluate: {DP_EVAL_UTTS} utterances of 2-10 s, batch {EVAL_BATCH} "
              f"padded to {-(-EVAL_BATCH // n) * n}: WER {dp_eval['wer']!r} CER "
              f"{dp_eval['cer']!r} and hypotheses identical to one card's; wall "
              f"{dp_eval['wall']!r} s (one card {one_eval['wall']!r} s); K1 launches "
              f"{dp_eval['counts']['lstm_fwd']}")

        batch_ms = {}
        for name in ("greedy", "beam, scan with K6"):
            decoder = decoders[name][0]
            batch_ms[name] = dict(zip(("one card", "data parallel"),
                                      dp_batch_ms(torch, (one, dp), audio, n_valid, decoder)))
    k1_ms = {rows: dp_k1_ms(torch, np, t_dim, rows) for rows in (b_dim // n, b_dim)}
    wall = time.perf_counter() - t_phase
    for name, ms in batch_ms.items():
        (one_ev, one_wall), (dp_ev, dp_wall) = ms["one card"], ms["data parallel"]
        print(f"data parallel times on {gpu_name} ({card}), one evaluation batch ({b_dim} x "
              f"{DP_SECONDS} s, raw audio, forward and {name} decode, TF32 off), medians of "
              f"{DP_TIME_REPS}: one card {one_ev!r} ms CUDA events, {one_wall!r} ms wall; {n} "
              f"replicas on {[str(d) for d in dp.devices]} {dp_ev!r} ms CUDA events (the "
              f"longest card's span), {dp_wall!r} ms wall"
              + ("; the replicas share one card, so these record the overhead of the "
                 "data-parallel path, not scaling" if count < 2 else ""))
    print(f"data parallel: K1 alone (f32, 2 directions, T={t_dim}, median of 10): "
          + ", ".join(f"B={rows} {ms!r} ms" for rows, ms in k1_ms.items()))
    print(f"phase 24: wall {wall!r} s")
    return {"devices": [str(d) for d in dp.devices], "visible_cards": count,
            "forward": {"lstm_fwd": dp_counts["lstm_fwd"], "max_abs_err": err},
            "decoders": decode_counts, "server_lstm_fwd": srv_counts["lstm_fwd"],
            "evaluate_lstm_fwd": dp_eval["counts"]["lstm_fwd"],
            "batch_ms": {name: {form: {"cuda_events": ev, "wall": wall_ms}
                                for form, (ev, wall_ms) in ms.items()}
                         for name, ms in batch_ms.items()},
            "k1_ms": {f"B={rows}": ms for rows, ms in k1_ms.items()}}


# phase 25: continuing a dsjax run on the card. The trainer's own mid-epoch
# file F (phase 8's flagship and corpus, 2 of an epoch's 3 steps), F's state
# mapped to dsjax's tree layout (tests/dsjax_layout.py) and written back by
# from_dsjax_state, as tools/dsjax_checkpoint_to_torch.py writes a dsjax
# step (F'), then workflows.train resuming each to the end of the epoch
RESUME_SAVED = 2


def resume_run(torch, base, ckpt, name):
    """workflows.train with load_auto_checkpoint over ``ckpt``, counted;
    returns (final step, launch counts, losses, seconds)."""
    from dsjax_torch.config import TrainConfig, compose
    from dsjax_torch.workflows import train

    log_dir = os.path.join(os.path.dirname(ckpt), f"logs_{name}")
    cfg = compose(TrainConfig, base + [f"checkpoint.dirpath={ckpt}", "load_auto_checkpoint=true",
                                       f"trainer.log_dir={log_dir}"])
    reset_counts()
    t0 = time.perf_counter()
    step = train(cfg).step
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    torch.cuda.empty_cache()
    records = [json.loads(line) for line in open(os.path.join(log_dir, "metrics.jsonl"))]
    return step, counts, [r["loss"] for r in records if "loss" in r], seconds


def same_files(torch, f, g):
    """F' against F: every entry, the weights and running stats, the
    optimizer's param groups and each parameter's step, exp_avg and
    exp_avg_sq (values, dtype and device) equal."""
    check(set(f) == set(g), f"F' holds {sorted(g)}, F {sorted(f)}")
    for key in ("step", "epoch", "metrics", "extra", "hyper_parameters"):
        check(f[key] == g[key], f"F' {key} {g[key]} against F's {f[key]}")
    check(f["state_dict"].keys() == g["state_dict"].keys()
          and all(torch.equal(v, g["state_dict"][k]) for k, v in f["state_dict"].items()),
          "F' weights or running stats differ from F's")
    fo, go = f["optimizer"], g["optimizer"]
    check(fo["param_groups"] == go["param_groups"],
          f"param groups {go['param_groups']} against {fo['param_groups']}")
    check(fo["state"].keys() == go["state"].keys(), "F' optimizer state covers other parameters")
    for i, a in fo["state"].items():
        b = go["state"][i]
        check(a.keys() == b.keys() == {"step", "exp_avg", "exp_avg_sq"}
              and all(torch.equal(a[k], b[k]) and a[k].dtype == b[k].dtype
                      and a[k].device == b[k].device for k in a),
              f"F' optimizer state of parameter {i} differs from F's")


def phase_resume(torch, np, gpu_name, card):
    """25: (a) train 2 steps and save mid-epoch (last_only, start_index,
    epoch) as F; (b) F's state to dsjax's layout and back through
    from_dsjax_state as F', equal to F tensor for tensor; (c) workflows.train
    with load_auto_checkpoint over F and over F', each finishing the epoch:
    exact K2/K3/K1 counts, finite losses, the two runs' losses equal (or
    within the spread of two resumes of F). Returns the resume of F's
    launches."""
    from dsjax_torch.config import TrainConfig, compose
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.model.convert import load_checkpoint
    from dsjax_torch.train.checkpoint import (CheckpointHandler, from_dsjax_state,
                                              restore_file)
    from dsjax_torch.train.loop import Trainer
    from dsjax_torch.workflows import _pipelines
    from tests.dsjax_layout import to_dsjax_state
    from tests.synthetic_manifest import write_manifest

    t_phase = time.perf_counter()
    labels = list(DEFAULT_LABELS)
    rng = np.random.default_rng(3)
    prime = "F'"
    with tempfile.TemporaryDirectory() as tmp:
        train_path = write_manifest(tmp, "train", [TRAIN_SECONDS] * TRAIN_UTTS, seed=4)
        val_path = write_manifest(tmp, "val", list(rng.uniform(3.0, TRAIN_SECONDS, VAL_UTTS)),
                                  seed=5)
        data = [f"data.train_path={train_path}", f"data.val_path={val_path}",
                "data.device_features=false", f"data.batch_size={TRAIN_B}",
                "data.num_workers=4", "trainer.precision=16", "trainer.max_epochs=1",
                "trainer.log_every_n_steps=1"]
        base = data + ["trainer.device=cuda", "trainer.devices=1"]
        cfg = compose(TrainConfig, base)
        steps = -(-TRAIN_UTTS // TRAIN_B)
        left, layers = steps - RESUME_SAVED, cfg.model.hidden_layers
        val_forwards = -(-VAL_UTTS // TRAIN_B)

        # (a) the trainer's mid-epoch save, as Trainer.fit makes it
        trainer = Trainer(cfg, labels)
        state = trainer.init_state()
        train_pipe = _pipelines(cfg, labels)[0]
        train_pipe.sampler.set_epoch(0)
        for i, batch in enumerate(train_pipe):
            if i == RESUME_SAVED:
                break
            state, loss = trainer.train_step(state, batch)
        dir_f, dir_g = os.path.join(tmp, "ckpt_f"), os.path.join(tmp, "ckpt_g")
        handler = CheckpointHandler(dir_f, cfg=cfg, labels=labels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handler.save(state, {"loss": float(loss)},
                     extra={"start_index": RESUME_SAVED, "epoch": 0}, last_only=True)
        save_s = time.perf_counter() - t0
        path_f = handler.path()
        size_gb = os.path.getsize(path_f) / 1e9
        t0 = time.perf_counter()
        restore_file(path_f, trainer.init_state())
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del state, trainer
        torch.cuda.empty_cache()

        # (b) F -> dsjax's layout -> F'
        cpu_state = Trainer(compose(TrainConfig, data + ["trainer.device=cpu"]),
                            labels).init_state()
        saved, extra = restore_file(path_f, cpu_state)
        t0 = time.perf_counter()
        tree = to_dsjax_state(saved)
        map_s = time.perf_counter() - t0
        path_g = os.path.join(dir_g, "last", os.path.basename(path_f))
        os.makedirs(os.path.dirname(path_g))
        f = load_checkpoint(path_f)
        t0 = time.perf_counter()
        from_dsjax_state(path_g, cfg, labels, tree["params"], tree["batch_stats"],
                         tree["moments"], tree["step"], tree["epoch"], f["metrics"], extra)
        convert_s = time.perf_counter() - t0
        check(f["extra"] == {"start_index": RESUME_SAVED, "epoch": 0}, f"F's extra {f['extra']}")
        check(tree["moments"]["count"] == RESUME_SAVED, f"Adam's count {tree['moments']}")
        same_files(torch, f, load_checkpoint(path_g))
        del saved, cpu_state, tree, f

        # (c) workflows.train resuming F and F'
        want = {"lstm_fwd": layers * val_forwards, "lstm_fwd_residuals": layers * left,
                "lstm_bwd": layers * left}
        runs = {}
        for name, ckpt in (("F", dir_f), (prime, dir_g)):
            step, counts, losses, seconds = resume_run(torch, base, ckpt, name)
            launches = {k: counts[k] for k in want}
            check(step == steps and launches == want
                  and sum(counts.values()) == sum(launches.values()) + counts["lstm_steps"],
                  f"resume of {name}: {step} steps, launches {counts}, expected {want}")
            check(len(losses) == left and all(np.isfinite(losses)),
                  f"resume of {name}: losses {losses}")
            runs[name] = (launches, losses, seconds)
        spread = None
        if runs["F"][1] != runs[prime][1]:
            # not bit for bit: hold F' to the spread of a second resume of F
            dir_f2 = os.path.join(tmp, "ckpt_f2")
            os.makedirs(os.path.join(dir_f2, "last"))
            shutil.copy(path_f, os.path.join(dir_f2, "last"))
            again = resume_run(torch, base, dir_f2, "F2")[2]
            spread = max(abs(a - b) for a, b in zip(again, runs["F"][1]))
            gap = max(abs(a - b) for a, b in zip(runs[prime][1], runs["F"][1]))
            check(gap <= spread, f"resumes of F' {runs[prime][1]} and of F {runs['F'][1]} "
                                 f"{gap} apart; two resumes of F {spread}")
    print(f"resume on {gpu_name} ({card}): 5x BiLSTM-1024 bf16, B={TRAIN_B} x {TRAIN_SECONDS} "
          f"s, F saved after {RESUME_SAVED} of {steps} steps (start_index {RESUME_SAVED}) in "
          f"{save_s!r} s ({size_gb!r} GB), restored onto the card in {restore_s!r} s; F's state "
          f"mapped to dsjax's layout in {map_s!r} s and written back as F' by from_dsjax_state "
          f"in {convert_s!r} s, equal to F tensor for tensor (weights, running stats, Adam "
          f"step, exp_avg, exp_avg_sq, param groups, step, epoch, start_index); "
          f"workflows.train resuming F: losses {runs['F'][1]}, launches {runs['F'][0]}, "
          f"{runs['F'][2]!r} s; resuming F': losses {runs[prime][1]}, launches "
          f"{runs[prime][0]}, {runs[prime][2]!r} s; the two "
          + ("equal bit for bit" if spread is None else f"within two resumes of F's {spread!r}"))
    print(f"phase 25: wall {time.perf_counter() - t_phase!r} s")
    return runs["F"][0]


AN4_UTTS = {"train": 24, "val": 8, "test": 8}   # and a 0.5 s utterance in train and in test
AN4_SEED = 26
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "dsjax")


def blocked_path(tmp):
    """A directory of stand-ins for jax, its companions and dsjax that raise
    ImportError, to put first on a subprocess's PYTHONPATH."""
    root = os.path.join(tmp, "blocked")
    for name in BLOCKED:
        os.makedirs(os.path.join(root, name))
        with open(os.path.join(root, name, "__init__.py"), "w") as f:
            f.write(f"raise ImportError('{name} is not importable here')\n")
    return root


def phase_quick_start(torch, np, gpu_name, card):
    """26: the README's quick start in the port: a synthetic AN4 archive
    prepared by ``python -m dsjax_torch.datasets.an4`` with jax and dsjax
    unimportable, its manifests checked and verified, one epoch of the
    flagship from ``+configs=an4`` on the card, and ``workflows.evaluate`` of
    the last checkpoint on the test manifest, greedy; exact K2/K3/K1 counts.
    Returns {kernel: launches} of the training and evaluation runs."""
    from dsjax_torch.audio.io import duration
    from dsjax_torch.config import EvalConfig, TrainConfig, compose
    from dsjax_torch.train.checkpoint import CheckpointHandler
    from dsjax_torch.workflows import evaluate, train
    from tests.synthetic_corpora import write_an4_archive

    t_phase = time.perf_counter()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        written = write_an4_archive(os.path.join(tmp, "an4.tar.gz"), AN4_SEED,
                                    n_train=AN4_UTTS["train"], n_val=AN4_UTTS["val"],
                                    n_test=AN4_UTTS["test"])
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([blocked_path(tmp), ROOT]))
        t0 = time.perf_counter()
        prep = subprocess.run([sys.executable, "-m", "dsjax_torch.datasets.an4", "--target-dir",
                               "an4_dataset", "--manifest-dir", "data/"], cwd=tmp, env=env,
                              capture_output=True, text=True, timeout=300)
        prep_s = time.perf_counter() - t0
        check(prep.returncode == 0 and prep.stdout == "Creating manifests...\n",
              f"python -m dsjax_torch.datasets.an4 exited {prep.returncode}: {prep.stdout}"
              f"{prep.stderr[-3000:]}")
        manifests, seconds = {}, {}
        for split, items in written.items():
            path = os.path.join("data", f"an4_{split}_manifest.json")
            doc = json.load(open(os.path.join(tmp, path)))
            names = [os.path.basename(s["wav_path"])[:-4] for s in doc["samples"]]
            lengths = [duration(os.path.join(doc["root_path"], s["wav_path"]))
                       for s in doc["samples"]]
            # --min-duration 1 prunes the 0.5 s train utterance; dsjax prunes
            # train and val only, so the 0.5 s test one stays
            want = sorted(n for n, _ in items if split != "train" or n != "an4_train_short")
            check(sorted(names) == want and lengths == sorted(lengths),
                  f"an4_{split}_manifest.json lists {names} of durations {lengths}; "
                  f"expected {want}, sorted by duration")
            manifests[split], seconds[split] = path, sum(lengths)
        verify = subprocess.run([sys.executable, "-m", "dsjax_torch.data.verify_manifest",
                                 *manifests.values()], cwd=tmp, env=env, capture_output=True,
                                text=True, timeout=120)
        check(verify.returncode == 0 and verify.stdout.count(": OK\n") == 3,
              f"verify_manifest exited {verify.returncode}: {verify.stdout}{verify.stderr}")

        os.chdir(tmp)
        try:
            cfg = compose(TrainConfig, ["+configs=an4", "trainer.max_epochs=1",
                                        "trainer.log_every_n_steps=1"])
            check(cfg.data.train_path == manifests["train"]
                  and cfg.data.val_path == manifests["val"] and cfg.data.batch_size == 8
                  and cfg.trainer.precision == 16 and cfg.model.hidden_size == H
                  and cfg.model.hidden_layers == 5 and cfg.trainer.device == "cuda",
                  f"+configs=an4 composed {cfg}")
            reset_counts()
            t0 = time.perf_counter()
            state = train(cfg)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            train_counts = read_counts()
            del state
            torch.cuda.empty_cache()
            records = [json.loads(line) for line in open(os.path.join("logs", "metrics.jsonl"))]
            last = CheckpointHandler(os.path.join(tmp, "checkpoints")).path()

            ecfg = compose(EvalConfig, [f"model.model_path={last}",
                                        f"test_path={manifests['test']}", "device=cuda:0",
                                        f"batch_size={EVAL_BATCH}"])
            out = io.StringIO()
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                wer, cer = evaluate(ecfg)
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t0
            eval_counts = read_counts()
        finally:
            os.chdir(cwd)
    layers = cfg.model.hidden_layers
    steps = -(-AN4_UTTS["train"] // cfg.data.batch_size)
    val_batches = -(-AN4_UTTS["val"] // cfg.data.batch_size)
    want = {"lstm_fwd": layers * val_batches, "lstm_fwd_residuals": layers * steps,
            "lstm_bwd": layers * steps}
    launches = {k: train_counts[k] for k in want}
    check(launches == want
          and sum(train_counts.values()) == sum(want.values()) + train_counts["lstm_steps"],
          f"one AN4 epoch launched {train_counts}, expected {want} ({steps} steps, "
          f"{val_batches} validation batch of {layers} layers)")
    losses = [r["loss"] for r in records if "loss" in r]
    val = [r for r in records if "wer" in r and "mean_loss" in r]
    check(len(losses) == steps and all(np.isfinite(losses)), f"AN4 losses {losses}")
    check(len(val) == 1 and np.isfinite(val[0]["mean_loss"]), f"AN4 validation {val}")
    n_test = len(written["test"])
    eval_batches = -(-n_test // EVAL_BATCH)
    lines = out.getvalue().splitlines()
    hyps = [line for line in lines if line.startswith("Hyp:")]
    summary = [line.strip() for line in lines if line.startswith("Test Summary")]
    check(eval_counts["lstm_fwd"] == layers * eval_batches
          and sum(eval_counts.values()) == eval_counts["lstm_fwd"] + eval_counts["lstm_steps"],
          f"AN4 evaluation launched {eval_counts}, expected {layers * eval_batches} lstm_fwd")
    check(len(hyps) == n_test and len(summary) == 1 and np.isfinite(wer) and np.isfinite(cer),
          f"AN4 evaluation: {len(hyps)} hypotheses of {n_test}, summary {summary}, "
          f"WER {wer}, CER {cer}")
    print(f"AN4 quick start on {gpu_name} ({card}): python -m dsjax_torch.datasets.an4 "
          f"(jax and dsjax unimportable) prepared {len(written['train'])}/{len(written['val'])}/"
          f"{n_test} train/val/test utterances ({seconds['train']!r}, {seconds['val']!r}, "
          f"{seconds['test']!r} s listed; the 0.5 s train one pruned) in {prep_s!r} s; one epoch "
          f"of +configs=an4 (5x BiLSTM-1024 bf16, B={cfg.data.batch_size}): {steps} steps, "
          f"losses {losses}, validation wer/cer {(val[0]['wer'], val[0]['cer'])}, launches "
          f"{launches}, {train_s!r} s with the checkpoint; evaluate of {os.path.basename(last)} "
          f"on the test manifest (greedy, batch {EVAL_BATCH}): {summary[0]!r}, lstm_fwd "
          f"{eval_counts['lstm_fwd']}, {eval_s!r} s")
    print(f"phase 26: wall {time.perf_counter() - t_phase!r} s")
    return {"train": launches, "evaluate": {"lstm_fwd": eval_counts["lstm_fwd"]}}


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
    launches, steps = phase_serving(torch, np, state, model_cfg, gpu_name)
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
    backtrack_res = phase_backtrack(torch, np)
    defaults_back()
    print("evaluation and beam serving phases: PyTorch defaults (the posterior comparison with "
          "TF32 off)")
    eval_runs = phase_evaluation(torch, np, state, model_cfg, gpu_name, full_fp32, defaults_back)
    phase_beam_serving(torch, np, state, model_cfg, gpu_name)
    full_fp32()
    print("GRU kernel and parity phases: TF32 off")
    gru_kernel = phase_gru_kernel(torch, np)
    gru_train_kernels = phase_gru_train_kernels(torch, np)
    phase_gru_gradients(torch, np)
    with tempfile.TemporaryDirectory() as tmp:
        paths = phase_gru_parity(torch, np, tmp)
        defaults_back()
        print("GRU serving and training phases: PyTorch defaults")
        gru_serving = phase_gru_serving(torch, np, paths, gpu_name)
    gru_train_launches = phase_training(torch, np, gpu_name, card, rnn="gru", epochs=1)
    full_fp32()
    k8 = phase_mm_chain(torch, np)
    defaults_back()
    print("LM phase: PyTorch defaults")
    lm = phase_lm(torch, np, state, model_cfg, gpu_name)
    full_fp32()
    print("data-parallel phase: TF32 off")
    data_parallel = phase_data_parallel(torch, np, state, model_cfg, gpu_name, card)
    defaults_back()
    del state
    print("augmented training phase: PyTorch defaults")
    aug_launches, aug_held = phase_augmented_training(torch, np, gpu_name, card)
    print("multi-device training phase: PyTorch defaults (the two-rank comparison with TF32 "
          "off)")
    ddp_launches = phase_ddp_training(torch, np, gpu_name, card, full_fp32, defaults_back)
    print("resume phase: PyTorch defaults")
    resume_launches = phase_resume(torch, np, gpu_name, card)
    print("quick start phase: PyTorch defaults")
    quick_start = phase_quick_start(torch, np, gpu_name, card)

    def row(name, source, replaces, launches, res, **extra):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, **{k: res[k] for k in keys}, **extra}

    def bf16_extra(res):
        return {"bf16_max_abs_err": res["max_abs_err"], "bf16_ms": res["ms"],
                "bf16_plain_ms": res["plain_ms"], "bf16_bound_ms": res["bound_ms"],
                "bf16_library_ms": res["library_ms"]}

    def persistent_extra(f32, bf16):
        # a serving scan: its one-direction times and, for each dtype and
        # direction count, its plan and kernel as built
        return {"one_direction_ms": f32["one_direction_ms"],
                "bf16_one_direction_ms": bf16["one_direction_ms"],
                "plans": {"float32": f32["plans"], "bfloat16": bf16["plans"]}}

    def pair_extra(key, f32, bf16):
        # a backward row: its kernel pair (forward with residuals, then the
        # backward) as one call, and cuDNN's forward plus backward
        if key == "fwd":
            return {}
        return {"with_forward_ms": f32["with_forward_ms"],
                "with_forward_library_ms": f32["with_forward_library_ms"],
                "bf16_with_forward_ms": bf16["with_forward_ms"],
                "bf16_with_forward_library_ms": bf16["with_forward_library_ms"]}

    def augmented(name):
        # phase 22: config #4's counts on each augmentation route, and the
        # kernel held against its plain version at that path's shapes
        return {"launches_in_augmented_training": {route: counts[name] for route, counts
                                                   in aug_launches.items()},
                "augmented_training_max_abs_err": aug_held[name][0],
                "augmented_training_shapes": aug_held[name][1]}

    def attributes(key, res):
        # a training scan's step kernel as built: registers, shared memory
        # and units a CTA
        return {"kernel_attributes": {n: res[(key, n)]["kernel_attributes"]
                                      for n in ("float32", "bfloat16")}}

    rows = [row("lstm_fwd", "dsjax_torch/csrc/lstm_fwd.cu", "dsjax/ops/lstm_pallas.py:62",
                launches, kernel["float32"], steps=steps,
                launches_in_training=train_launches["lstm_fwd"],
                launches_in_ddp_training=ddp_launches["lstm_fwd"],
                launches_in_resume=resume_launches["lstm_fwd"],
                launches_in_quick_start=quick_start["train"]["lstm_fwd"]
                + quick_start["evaluate"]["lstm_fwd"],
                launches_in_evaluation=eval_runs["greedy"]["counts"]["lstm_fwd"],
                launches_in_data_parallel=data_parallel["forward"]["lstm_fwd"],
                data_parallel=data_parallel,
                **bf16_extra(kernel["bfloat16"]),
                **persistent_extra(kernel["float32"], kernel["bfloat16"]))]
    for key, name, source, replaces in (
            ("fwd", "lstm_fwd_residuals", "dsjax_torch/csrc/lstm_fwd.cu",
             "dsjax/ops/lstm_pallas.py:381"),
            ("bwd", "lstm_bwd", "dsjax_torch/csrc/lstm_bwd.cu",
             "dsjax/ops/lstm_pallas.py:225")):
        rows.append(row(name, source, replaces, train_launches[name],
                        train_kernels[(key, "float32")],
                        launches_in_ddp_training=ddp_launches[name],
                        launches_in_resume=resume_launches[name],
                        launches_in_quick_start=quick_start["train"][name],
                        **bf16_extra(train_kernels[(key, "bfloat16")]),
                        **pair_extra(key, train_kernels[(key, "float32")],
                                     train_kernels[(key, "bfloat16")]),
                        **attributes(key, train_kernels)))
    first_topk, first_beam = TOPK_SHAPES[0], BEAM_SHAPES[0]
    dp_decoders = data_parallel["decoders"]
    lm_device_counts = lm["evaluation"]["device LM beam"]["counts"]
    rows.append(row("topk", "dsjax_torch/csrc/topk.cu", "dsjax/ops/topk_pallas.py:139",
                    eval_runs["beam, scan with K6"]["counts"]["topk"],
                    topk_res[f"({first_topk[0]}, {first_topk[1]}) -> {first_topk[2]}"],
                    device_ms=topk_res[f"({first_topk[0]}, {first_topk[1]}) -> {first_topk[2]}"]
                    ["device_ms"], shapes=topk_res,
                    launches_on_the_lm_path=lm_device_counts["topk"], lm_scans=lm["scan"],
                    launches_in_data_parallel=dp_decoders["beam, scan with K6"]["topk"]))
    b, t, w, c = first_beam
    rows.append(row("beam_scan", "dsjax_torch/csrc/beam_scan.cu", "dsjax/ops/beam_pallas.py:121",
                    eval_runs["beam, K7"]["counts"]["beam_scan"],
                    beam_res[f"B={b} T={t} W={w} C={c}"], shapes=beam_res,
                    launches_in_data_parallel=dp_decoders["beam, K7"]["beam_scan"]))
    # not a Pallas kernel: dsjax runs the backtrack as a lax.scan
    rows.append(row("beam_backtrack", "dsjax_torch/csrc/beam_scan.cu",
                    "dsjax/decode/beam_device.py:450", eval_runs["beam, K7"]["counts"]
                    ["beam_backtrack"], backtrack_res, device_ms=backtrack_res["device_ms"],
                    launches_on_the_scan_route=eval_runs["beam, scan with K6"]["counts"]
                    ["beam_backtrack"], shape=backtrack_res["shape"],
                    launches_on_the_lm_path=lm_device_counts["beam_backtrack"],
                    launches_in_data_parallel=dp_decoders["beam, K7"]["beam_backtrack"]))
    rows.append(row("gru_fwd", "dsjax_torch/csrc/gru_fwd.cu", "dsjax/ops/gru_pallas.py:40",
                    gru_serving["gru_fwd"], gru_kernel["float32"],
                    steps=gru_serving["gru_steps"],
                    launches_in_training=gru_train_launches["gru_fwd"],
                    **augmented("gru_fwd"),
                    **bf16_extra(gru_kernel["bfloat16"]),
                    **persistent_extra(gru_kernel["float32"], gru_kernel["bfloat16"])))
    for key, name, source, replaces in (
            ("fwd", "gru_fwd_residuals", "dsjax_torch/csrc/gru_fwd.cu",
             "dsjax/ops/gru_pallas.py:293"),
            ("bwd", "gru_bwd", "dsjax_torch/csrc/gru_bwd.cu", "dsjax/ops/gru_pallas.py:161")):
        rows.append(row(name, source, replaces,
                        gru_train_launches[name], gru_train_kernels[(key, "float32")],
                        **augmented(name),
                        **bf16_extra(gru_train_kernels[(key, "bfloat16")]),
                        **pair_extra(key, gru_train_kernels[(key, "float32")],
                                     gru_train_kernels[(key, "bfloat16")]),
                        **attributes(key, gru_train_kernels)))
    rows.append(row("mm_chain", "dsjax_torch/csrc/mm_chain.cu", "tools/lstm_microbench.py:100",
                    k8["launches"], k8, library_call=k8["library_call"],
                    library_max_abs_err=k8["library_max_abs_err"],
                    bf16_peak_share=k8["bf16_peak_share"],
                    kernel_attributes=k8["kernel_attributes"], microbench=k8["microbench"]))
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
