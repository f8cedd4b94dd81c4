"""Evaluation window: ``workflows.evaluate``'s loop body over a sorted
corpus in batches, cycled.

Each batch is staged on a copy stream by a ``DevicePrefetcher`` thread
(raw int16 audio and frame counts), run through ``ModelBundle.forward``
(the STFT on the card, then the model), and the previous batch is decoded
by ``DeviceBeamDecoder.decode(n_best=1)`` and scored into WER/CER, as
``evaluate`` does. Set-up passes once over the corpus, so every shape is
used before the window. The window ends with the first pass over the
corpus that finishes past ``seconds``, once its last batch is decoded: it
holds whole passes only, so where it ends in the sorted corpus (short
batches run at a lower rate than long ones) does not move the rate.

The comparison takes a sample of the batches, drawn from the seed and
holding the longest: the reference computes their posteriors from the raw
audio and the same weights, and runs its own beam search over its own
posteriors; the program's transcripts are scored under the reference's
posteriors against the reference's best, end to end.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import check, counts, harness, traffic, weights
from portbench.reference import beam as ref_beam
from portbench.reference import ds2 as ref_ds2


def port_batches(utts: List[traffic.Utterance], batch: int, spect) -> List:
    """Consecutive groups of ``batch`` utterances as evaluate collates them
    (``SpectrogramDataset`` with device features, ``collate_audio`` with
    buckets of 64); within a batch the rows run longest first, the order
    ``collate_audio`` gives them."""
    from dsjax_torch.audio.features import pad_audio_for_device, stft_params
    from dsjax_torch.data.dataset import collate_audio

    hop = stft_params(spect)[1]
    out = []
    for i in range(0, len(utts), batch):
        items = []
        for u in sorted(utts[i:i + batch], key=lambda u: -len(u.samples)):
            yp, n = pad_audio_for_device(u.samples.astype(np.float32) / 32768.0, spect)
            yp = np.clip(np.rint(yp * 32768.0), -32768, 32767).astype(np.int16)
            items.append((yp, n, u.transcript.tolist()))
        out.append(collate_audio(items, hop, 64, 64, pad_to_batch=batch))
    return out


def sample_batches(n_batches: int, k: int, seed: int) -> List[int]:
    """k batch indices drawn from the seed, the last (longest) among them."""
    rng = np.random.default_rng([int(seed), 1])
    rest = rng.choice(n_batches - 1, size=min(k, n_batches) - 1, replace=False)
    return sorted(int(i) for i in rest) + [n_batches - 1]


def run(cell: harness.Cell) -> harness.Outcome:
    from dsjax_torch.config import EvalConfig, SpectConfig, compose
    from dsjax_torch.data.loader import DevicePrefetcher, stage
    from dsjax_torch.inference import ModelBundle, load_decoder
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.model.convert import from_reference_state_dict, infer_architecture
    from dsjax_torch.model.ds2 import DeepSpeech2
    from dsjax_torch.train.metrics import CharErrorRate, WordErrorRate, update_batch

    arch, tr, dev = cell.config, cell.traffic, cell.device
    stages = {"imports": time.perf_counter() - cell.started}
    cfg = compose(EvalConfig, list(tr["port"]) + [f"device={dev}"])
    os.environ.update(tr.get("env", {}))
    labels = list(DEFAULT_LABELS)
    t0 = time.perf_counter()
    utts = traffic.generate(tr, cell.seed)
    stages["inputs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    w0 = weights.make(arch, cell.seed, dev, tr.get("head_scale", 1.0))
    host_state = {k: v.cpu() for k, v in w0.items()}
    del w0
    model_cfg, n_classes = infer_architecture(host_state)
    model = DeepSpeech2(n_classes, SpectConfig(), model_cfg,
                        dtype=torch.bfloat16 if cfg.model.precision == 16 else torch.float32)
    model.load_state_dict(from_reference_state_dict(host_state))
    bundle = ModelBundle(model, labels, SpectConfig(), cfg.device)
    decoder = load_decoder(labels, cfg.lm)
    target_decoder = load_decoder(labels, type(cfg.lm)())
    stages["program"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    batches = port_batches(utts, cfg.batch_size, bundle.spect_cfg)
    stages["batches"] = time.perf_counter() - t0
    sample = sample_batches(len(batches), int(tr["checked_batches"]), cell.seed)
    copy_stream = torch.cuda.Stream(bundle.device) if bundle.device.type == "cuda" else None
    wer, cer = WordErrorRate(), CharErrorRate()
    kept: Dict[int, tuple] = {}
    decode_s: List[float] = []
    finite: List[torch.Tensor] = []

    def finish(pending) -> None:
        probs, out_lens, idx = pending
        b = batches[idx]
        n_real = int(b.valid_mask.sum()) or b.size
        t0 = time.perf_counter()
        decoded, _ = decoder.decode(probs, out_lens, n_best=1)
        decode_s.append(time.perf_counter() - t0)
        refs = target_decoder.convert_to_strings(
            [b.targets[r, :b.target_lengths[r]] for r in range(n_real)])
        transcripts = [d[0] for d in decoded[:n_real]]
        update_batch(wer, cer, transcripts, [r[0] for r in refs])
        if idx in sample and idx not in kept:
            kept[idx] = (probs, out_lens, transcripts)

    def stage_batch(item):
        b = batches[item]
        return stage((b.audio, b.input_lengths.astype(np.int32)), bundle.device, copy_stream)

    def loop(order, deadline=None) -> List[int]:
        """Run evaluate's loop over batch indices from ``order``; stop after
        the first pass's last batch that starts past ``deadline``. Returns
        the indices decoded."""
        done, pending = [], None
        stop = [False]
        source = (i for i in order if not stop[0])
        prefetcher = DevicePrefetcher(source, stage_batch)
        items = iter(prefetcher)
        try:
            for idx, staged in items:
                x, lens = staged.wait(bundle.device)
                probs, out_lens, _ = bundle.forward(x, lens)
                finite.append(torch.isfinite(probs).all())
                if pending is not None:
                    finish(pending)
                    done.append(pending[2])
                pending = (probs, out_lens, idx)
                if (deadline is not None and idx == len(batches) - 1
                        and time.perf_counter() >= deadline):
                    break
            if pending is not None:
                finish(pending)
                done.append(pending[2])
        finally:
            stop[0] = True
            items.close()
            prefetcher._thread.join(timeout=60)
        return done

    n = len(batches)
    t0 = time.perf_counter()
    loop(range(n))                                     # every shape once
    harness.sync(dev)
    stages["warm_up"] = time.perf_counter() - t0
    kept.clear()
    decode_s.clear()
    started = time.perf_counter()
    done = loop(itertools.cycle(range(n)), deadline=started + cell.seconds)
    harness.sync(dev)
    window_s = time.perf_counter() - started
    setup_s = started - cell.started

    utt_frames = [[counts.frames_of(len(u.samples)) for u in utts[i:i + cfg.batch_size]]
                  for i in range(0, len(utts), cfg.batch_size)]
    audio_s = sum(len(utts[i * cfg.batch_size + r].samples) for i in done
                  for r in range(len(utt_frames[i]))) / counts.SAMPLE_RATE
    flops = sum(counts.forward_flops(arch, counts.frames_after_convs(f))
                for i in done for f in utt_frames[i])
    dtype = "bfloat16" if cfg.model.precision == 16 else "float32"
    layer: Dict = {"window": {"seconds": window_s, "batches": len(done), "flops": flops,
                              "dtype": dtype,
                              "decode_s": sum(decode_s[-len(done):]) / len(done)}}
    result_breakdown = None
    if cell.trace:
        before = harness.counters()
        layer["span"] = harness.trace_span(lambda: loop(range(n)), dev)
        layer["span"]["batches"] = n
        layer["counters"] = harness.delta(before, harness.counters())
        calls: Dict[str, list] = {}
        for b, frames in zip(batches, utt_frames):
            # collate_audio pads to (frames + 1) * hop samples
            n_t = counts.frames_after_convs(b.audio.shape[1] // counts.HOP - 1)
            valid = sum(counts.frames_after_convs(f) for f in frames)
            for k, c in counts.scan_calls(arch, False, n_t, cfg.batch_size, dtype,
                                          valid).items():
                calls.setdefault(k, []).extend(c)
            if cfg.lm.decoder_type == "beam":       # K7 runs on the fused route
                calls.setdefault("K7", []).append(
                    (cfg.batch_size, n_t, cfg.lm.beam_width, n_classes, valid))
        layer["calls"] = calls
        result_breakdown = harness.breakdown(layer["span"])
    peak = harness.peak_memory(dev)
    failed = int((~torch.stack(finite)).sum()) if finite else 0

    t_ref = time.perf_counter()
    numbers = compare(cell, kept, utts, cfg.batch_size, n_classes, cfg.lm.beam_width)
    notes = {"reference_s": time.perf_counter() - t_ref, "checked_batches": sorted(kept),
             "wer": wer.compute(), "cer": cer.compute(), "setup_stages": stages}
    return harness.Outcome(
        attempted=sum(len(utt_frames[i]) for i in done), failed=failed,
        end_to_end={"eval_audio_s_per_s": audio_s / window_s},
        setup_s=setup_s, memory_peak_bytes=peak, numbers=numbers, layer=layer,
        breakdown=result_breakdown, notes=notes)


def compare(cell: harness.Cell, kept: Dict[int, tuple], utts: List[traffic.Utterance],
            batch: int, n_classes: int, width: int) -> Dict[str, float]:
    """probs_gap, beam_gap and beam_miss_share over the kept batches
    (``check``): the beam numbers score the program's transcript and the
    reference beam search's best under the reference's posteriors."""
    arch, dev = cell.config, cell.device
    labels = cell.config["labels"]
    w0 = weights.make(arch, cell.seed, dev, cell.traffic.get("head_scale", 1.0))
    probs_gap, beam_gap, misses, answers = 0.0, 0.0, 0, 0
    for idx, (probs, out_lens, transcripts) in sorted(kept.items()):
        group = sorted(utts[idx * batch:(idx + 1) * batch], key=lambda u: -len(u.samples))
        longest = max(len(u.samples) for u in group)
        audio = np.zeros((len(group), longest), np.int16)
        for r, u in enumerate(group):
            audio[r, :len(u.samples)] = u.samples
        with torch.no_grad(), ref_ds2.strict_f32():
            feats, n_frames = ref_ds2.spectrogram(torch.from_numpy(audio).to(dev),
                                                  [len(u.samples) for u in group])
            p_ref, len_ref = ref_ds2.forward(w0, arch, feats, n_frames, train=False)
        p_prog = probs.float()
        lens = out_lens.to(torch.int64).cpu()
        if not torch.equal(lens, len_ref.cpu()):
            return {"probs_gap": float("inf"), "beam_gap": float("inf"),
                    "beam_miss_share": 1.0}
        logp = torch.log(torch.clamp_min(p_ref.double(), 1e-30)).cpu().numpy()
        for r in range(len(group)):
            n = int(lens[r])
            gap = (p_prog[r, :n] - p_ref[r, :n]).abs().max()
            probs_gap = max(probs_gap, float(gap))
            best = ref_beam.beam_search(logp[r, :n], width)
            got = [labels.index(ch) for ch in transcripts[r]]
            shortfall = (ref_beam.log_likelihood(logp[r, :n], best)
                         - ref_beam.log_likelihood(logp[r, :n], got))
            beam_gap = max(beam_gap, shortfall)
            misses += shortfall > check.MISS_NATS
            answers += 1
    return {"probs_gap": probs_gap, "beam_gap": beam_gap,
            "beam_miss_share": misses / max(1, answers)}
