"""Training window of the Conformer (``model=conformer``): the ``train``
driver's window and checks (``drivers/train.py``) on a model whose weights
keep the reference's names.

Set-up composes the port's config first (a port without ``model=conformer``
raises there, before any work), builds one ``Trainer`` and its
``TrainState``, loads the seeded weights (``conformer_weights.py``) and
drives that state through ``checked_steps`` steps on distinct batches with
the window's own calls, reading each step's loss, every leaf's step-1
gradient from AdamW's first moment and every leaf's change. One more step
warms the last batch; the window cycles the batches, keeping two steps in
flight. With ``trace`` a few more steps run under the profiler, and each
kernel's device time is given to the Conformer's span that launched it
(``attribution.py``). After that the state is freed and the reference
(``reference/conformer.py``, each block recomputed in its backward) takes
the same steps from the same weights.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict

import torch

from portbench import attribution, check, conformer_counts, conformer_weights, counts, harness
from portbench import traffic
from portbench.drivers.train import norms, optim_settings, port_batches, port_config, ref_batches
from portbench.reference import conformer as ref_conformer
from portbench.reference.train import Readings

SPANS = ("conformer.subsample", "conformer.ffn", "conformer.attention", "conformer.conv")


def per_step(arch: Dict) -> Dict[str, int]:
    """Each span's calls in one training step."""
    n = arch["n_layers"]
    return {"conformer.subsample": 1, "conformer.ffn": 2 * n, "conformer.attention": n,
            "conformer.conv": n}


def run(cell: harness.Cell) -> harness.Outcome:
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.train.loop import Trainer

    arch, tr, dev = cell.config, cell.traffic, cell.device
    batch, n_checked = int(tr["batch"]), int(tr["checked_steps"])
    stages = {"imports": time.perf_counter() - cell.started}
    cfg = port_config(cell, batch)
    t0 = time.perf_counter()
    utts = traffic.generate(tr, cell.seed)
    stages["inputs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer = Trainer(cfg, list(DEFAULT_LABELS))
    state = trainer.init_state()
    w0 = conformer_weights.make(arch, cell.seed, dev)
    state.model.load_state_dict(w0)
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
            first = {n: state.optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                     / (1 - beta1) for n, p in named.items()}
            grad_norms = norms(first)
            grads = {k: v.cpu() for k, v in first.items()}      # held off the card
            del first
    change_norms = {n: float(torch.linalg.vector_norm((p.detach() - w0[n]).double()))
                    for n, p in named.items()}
    program = Readings(losses, grad_norms, change_norms, grads)
    del w0
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
                              "flops": n_steps * conformer_counts.train_flops(arch, frames,
                                                                              batch)}}
    result_breakdown = None
    notes: Dict = {}
    if cell.trace:
        n_span = int(tr["traced_steps"])

        def span():
            for i in range(n_span):
                step(batches[i % len(batches)])

        layer["span"], events = attribution.trace_span(span, dev)
        layer["span"]["steps"] = n_span
        seconds = attribution.attribute(events, SPANS)
        del events
        layer["attribution"] = {"seconds": seconds, "per_step": per_step(arch)}
        notes["attributed_ms_a_step"] = {str(k): 1e3 * v / n_span for k, v in seconds.items()}
        result_breakdown = harness.breakdown(layer["span"])
    peak = harness.peak_memory(dev)

    del state, trainer, named, window_losses, batches
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    w0 = conformer_weights.make(arch, cell.seed, dev)
    t_ref = time.perf_counter()
    reference = ref_conformer.train_steps(w0, arch, ref_batches(utts, batch, n_checked, dev),
                                          optim_settings(cfg))
    notes.update({"reference_s": time.perf_counter() - t_ref, "program_losses": program.losses,
                  "reference_losses": reference.losses, "setup_stages": stages,
                  **check.worst_leaves(program, reference)})
    numbers = check.train_numbers(program, reference)
    return harness.Outcome(
        attempted=n_steps, failed=failed,
        end_to_end={"train_audio_s_per_s": n_steps * audio_s / window_s},
        setup_s=setup_s, memory_peak_bytes=peak, numbers=numbers, layer=layer,
        breakdown=result_breakdown, notes=notes)
