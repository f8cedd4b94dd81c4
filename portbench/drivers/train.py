"""Training window: ``Trainer.put_batch`` then ``Trainer.train_step``, one
optimizer step a batch, over a few distinct batches made in set-up and
cycled.

Set-up builds one ``Trainer`` and its ``TrainState`` from the cell's
config, loads the seeded weights through the port's converter for the
published layout, and drives that state through ``checked_steps`` steps on
distinct batches with the window's own calls, reading what the comparison
needs: each step's loss, every leaf's step-1 gradient from AdamW's first
moment (m_1 = (1 - beta1) g), and every leaf's change after the steps. One
more step on the last batch warms it; the window then cycles the batches,
keeping two steps in flight, and ends at the first step boundary past
``seconds`` once the card has finished. With ``trace`` a few more steps
run under the profiler. After that the state is freed and the reference
takes the same steps from the same weights.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List

import numpy as np
import torch

from portbench import check, counts, harness, traffic, weights
from portbench.reference import train as ref_train

def port_config(cell: harness.Cell, batch: int):
    from dsjax_torch.config import TrainConfig, compose

    overrides = (list(cell.config["port"]) + list(cell.traffic["port"])
                 + [f"trainer.device={cell.device}", "trainer.devices=1",
                    f"data.batch_size={batch}", f"seed={cell.seed % 2 ** 31}"])
    return compose(TrainConfig, overrides)


def optim_settings(cfg) -> Dict:
    """The optimizer and clip settings the reference takes, from the port's
    config."""
    return {"lr": cfg.optim.learning_rate, "weight_decay": cfg.optim.weight_decay,
            "eps": cfg.optim.eps, "betas": tuple(cfg.optim.betas),
            "clip": cfg.trainer.gradient_clip_val}


def port_batches(utts: List[traffic.Utterance], batch: int, cfg) -> List:
    """The utterances as the port's device-feature batches: reflect-padded
    and stored as int16 (``SpectrogramDataset``), collated (``collate_audio``)."""
    from dsjax_torch.audio.features import pad_audio_for_device, stft_params
    from dsjax_torch.data.dataset import collate_audio

    hop = stft_params(cfg.data.spect)[1]
    out = []
    for i in range(0, len(utts), batch):
        items = []
        for u in utts[i:i + batch]:
            yp, n = pad_audio_for_device(u.samples.astype(np.float32) / 32768.0, cfg.data.spect)
            yp = np.clip(np.rint(yp * 32768.0), -32768, 32767).astype(np.int16)
            items.append((yp, n, u.transcript.tolist()))
        out.append(collate_audio(items, hop, cfg.data.bucket_frames, cfg.data.bucket_labels,
                                 pad_to_batch=batch))
    return out


def ref_batches(utts: List[traffic.Utterance], batch: int, n: int, device) -> List:
    out = []
    for i in range(0, n * batch, batch):
        group = utts[i:i + batch]
        longest = max(len(u.samples) for u in group)
        audio = np.zeros((len(group), longest), np.int16)
        targets = np.zeros((len(group), max(len(u.transcript) for u in group)), np.int64)
        for r, u in enumerate(group):
            audio[r, :len(u.samples)] = u.samples
            targets[r, :len(u.transcript)] = u.transcript
        out.append(ref_train.RefBatch(
            torch.from_numpy(audio).to(device), [len(u.samples) for u in group],
            torch.from_numpy(targets).to(device),
            torch.tensor([len(u.transcript) for u in group], device=device)))
    return out


def ref_leaves(tensors: Dict[str, torch.Tensor], bidirectional: bool) -> Dict[str, torch.Tensor]:
    """The port's per-parameter tensors (its parameters, or a state per
    parameter) under the published layout's names, directions split."""
    conv = {"conv1": "conv.seq_module.0", "bn1": "conv.seq_module.1",
            "conv2": "conv.seq_module.3", "bn2": "conv.seq_module.4"}
    rnn = {"weight_ih": "weight_ih_l0", "weight_hh": "weight_hh_l0",
           "bias_ih": "bias_ih_l0", "bias_hh": "bias_hh_l0"}
    sfx = ("", "_reverse") if bidirectional else ("",)
    out = {}
    for name, t in tensors.items():
        part = name.split(".")
        if part[0] == "conv":
            out[f"{conv[part[1]]}.{part[2]}"] = t
        elif part[0] == "rnns":
            for d, s in enumerate(sfx):
                out[f"rnns.{part[1]}.rnn.{rnn[part[2]]}{s}"] = t[d]
        elif part[0] == "rnn_bns":
            out[f"rnns.{int(part[1]) + 1}.batch_norm.module.{part[2]}"] = t
        elif part[0] == "lookahead":
            out["lookahead.0.conv.weight"] = t[:, None, :]
        elif part[0] == "fc_bn":
            out[f"fc.0.module.0.{part[1]}"] = t
        elif part[0] == "fc":
            out["fc.0.module.1.weight"] = t
        else:
            raise KeyError(f"no published name for the port's {name}")
    return out


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def run(cell: harness.Cell) -> harness.Outcome:
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.model.convert import from_reference_state_dict
    from dsjax_torch.train.loop import Trainer

    arch, tr, dev = cell.config, cell.traffic, cell.device
    stages = {"imports": time.perf_counter() - cell.started}
    batch, n_checked = int(tr["batch"]), int(tr["checked_steps"])
    t0 = time.perf_counter()
    utts = traffic.generate(tr, cell.seed)
    stages["inputs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = port_config(cell, batch)
    trainer = Trainer(cfg, list(DEFAULT_LABELS))
    state = trainer.init_state()
    w0 = weights.make(arch, cell.seed, dev, tr.get("head_scale", 1.0))
    state.model.load_state_dict(from_reference_state_dict({k: v.cpu() for k, v in w0.items()}))
    stages["program"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    batches = port_batches(utts, batch, cfg)
    stages["batches"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if len(batches) <= n_checked:
        raise ValueError(f"{cell.name}: {len(batches)} batches leave none past the "
                         f"{n_checked} checked steps")
    named = dict(state.model.named_parameters())
    beta1 = state.optimizer.param_groups[0]["betas"][0]

    def step(b):
        return trainer.train_step(state, b, staged=trainer.put_batch(b))[1]

    losses, grad_norms, grads = [], {}, {}
    for i in range(n_checked):
        losses.append(float(step(batches[i])))
        if i == 0:
            # a step that never reached the optimizer leaves no moment: 0
            first = ref_leaves({
                n: state.optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                / (1 - beta1) for n, p in named.items()}, arch["bidirectional"])
            grad_norms = norms(first)
            grads = {k: v.cpu() for k, v in first.items()}      # held off the card
            del first
    moved = ref_leaves({n: p.detach() for n, p in named.items()}, arch["bidirectional"])
    change_norms = {k: float(torch.linalg.vector_norm((moved[k] - w0[k]).double()))
                    for k in moved}
    program = ref_train.Readings(losses, grad_norms, change_norms, grads)
    del moved, w0
    step(batches[-1])                     # the last batch's first use, outside the window
    harness.sync(dev)
    stages["checked_steps"] = time.perf_counter() - t0

    # the window
    window_losses = []
    in_flight: deque = deque()
    started = time.perf_counter()
    deadline = started + cell.seconds
    n_steps = 0
    while True:
        window_losses.append(step(batches[n_steps % len(batches)]))
        n_steps += 1
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            in_flight.append(done)
            if len(in_flight) > 2:
                in_flight.popleft().synchronize()
        if time.perf_counter() >= deadline:
            break
    harness.sync(dev)
    window_s = time.perf_counter() - started
    setup_s = started - cell.started
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())

    audio_s = float(sum(len(u.samples) for u in utts[:batch])) / counts.SAMPLE_RATE
    frames = counts.frames_of(len(utts[0].samples))
    dtype = "bfloat16" if cfg.trainer.precision == 16 else "float32"
    layer: Dict = {"window": {"seconds": window_s, "steps": n_steps, "dtype": dtype,
                              "flops": n_steps * batch * counts.train_flops(arch, frames)}}
    result_breakdown = None
    if cell.trace:
        n_span = int(tr["traced_steps"])
        before = harness.counters()

        def span():
            for i in range(n_span):
                step(batches[i % len(batches)])

        layer["span"] = harness.trace_span(span, dev)
        layer["span"]["steps"] = n_span
        layer["counters"] = harness.delta(before, harness.counters())
        steps_t = counts.frames_after_convs(frames)
        layer["calls"] = {k: calls * n_span for k, calls in counts.scan_calls(
            arch, True, steps_t, batch, dtype, steps_t * batch).items()}
        result_breakdown = harness.breakdown(layer["span"])
    peak = harness.peak_memory(dev)

    del state, trainer, named, window_losses, batches
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    w0 = weights.make(arch, cell.seed, dev, tr.get("head_scale", 1.0))
    t_ref = time.perf_counter()
    reference = ref_train.train_steps(w0, arch, ref_batches(utts, batch, n_checked, dev),
                                      optim_settings(cfg))
    notes = {"reference_s": time.perf_counter() - t_ref, "program_losses": program.losses,
             "reference_losses": reference.losses, "setup_stages": stages,
             **check.worst_leaves(program, reference)}
    numbers = check.train_numbers(program, reference)
    return harness.Outcome(
        attempted=n_steps, failed=failed,
        end_to_end={"train_audio_s_per_s": n_steps * audio_s / window_s},
        setup_s=setup_s, memory_peak_bytes=peak, numbers=numbers, layer=layer,
        breakdown=result_breakdown, notes=notes)
