"""Data-parallel training window: ``Trainer.put_batch`` then
``Trainer.train_step`` under DDP, one rank a card (``run.py`` starts the
ranks, ``ranks.py``), one optimizer step a global batch, over a few
distinct global batches made in set-up and cycled.

Set-up on every rank: join the process group (NCCL on cards, gloo on the
CPU), make the mix's utterances from the seed (each global batch is G =
batch x world rows; rank r takes rows [r batch, (r + 1) batch) of each),
build one ``Trainer`` and its ``TrainState`` from the cell's config (at
``trainer.mesh_model=1`` every rank holds the whole model; DDP averages the
gradients over the ranks, BatchNorm takes the global batch's moments), load
the seeded weights through the port's converter, and drive that state
through ``checked_steps`` steps with the window's own calls, rank 0 reading
what the comparison needs as the one-card driver does (``drivers/train.py``).
One more step warms the last batch.

The window cycles the global batches with two steps in flight on every
rank. Rank 0 decides, after each step it issues, whether the window has
passed ``seconds`` and tells the others over the host group, so every rank
takes the same steps. With ``trace`` every rank profiles ``traced_steps``
more; rank 0's trace is the layer's, its busy seconds the mean of the
ranks'. Then the ranks' parameters and running statistics are compared
(``rank_gap``), rank 0 takes the largest of the ranks' memory peaks, and
every rank frees its state. Rank 0 runs the reference on the checked global
batches (the rows' loss summed over all G rows and divided by the world, as
DDP's average and dsjax's ``loss / dp``; BatchNorm over all G rows) while
the others wait for it, so that no rank leaves the group before another.
Rank 0 returns the ``Outcome``; the others return None. The rate,
``ddp_train_audio_s_per_s``, is the audio of every rank's rows over the
window: a metric of its own, since the ranks' hosts, each within a few
percent of its card's pace and held in step by the host collectives, make
it spread far wider than one card's.
"""

from __future__ import annotations

import statistics
import time
from collections import deque
from typing import Dict, List

import torch
import torch.distributed as dist

from portbench import check, counts, harness, traffic, weights
from portbench.drivers import train
from portbench.reference import train as ref_train


def port_config(cell: harness.Cell, batch: int):
    from dsjax_torch.config import TrainConfig, compose

    overrides = (list(cell.config["port"]) + list(cell.traffic["port"])
                 + [f"trainer.device={cell.device}", "trainer.devices=-1",
                    f"data.batch_size={batch}", f"seed={cell.seed % 2 ** 31}"])
    return compose(TrainConfig, overrides)


def rows_of(utts: List[traffic.Utterance], batch: int, world: int, rank: int
            ) -> List[traffic.Utterance]:
    """This rank's rows of every whole global batch, in order."""
    g = batch * world
    return [u for i in range(len(utts) // g)
            for u in utts[i * g + rank * batch:i * g + (rank + 1) * batch]]


def rank_gap(model: torch.nn.Module, world: int) -> float:
    """The largest difference of any parameter or running statistic between
    two ranks: an element's maximum over the ranks less its minimum."""
    if world == 1:
        return 0.0
    flat = torch.cat([t.detach().float().reshape(-1) for t in model.state_dict().values()])
    hi, lo = flat.clone(), flat
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return float((hi - lo).max())


def gathered(value, world: int) -> list:
    """Every rank's ``value``, by rank (the host group)."""
    if world == 1:
        return [value]
    from dsjax_torch.parallel import distributed

    out = [None] * world
    dist.all_gather_object(out, value, group=distributed.host_group())
    return out


def run(cell: harness.Cell):
    from dsjax_torch.parallel import distributed

    joined = distributed.initialize(cell.device.type)
    try:
        return _run(cell)
    finally:
        if joined:
            distributed.destroy()


def _run(cell: harness.Cell):
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.model.convert import from_reference_state_dict
    from dsjax_torch.parallel import distributed
    from dsjax_torch.train.loop import Trainer

    arch, tr, dev = cell.config, cell.traffic, cell.device
    world, rank = distributed.world_size(), distributed.rank()
    stages = {"imports": time.perf_counter() - cell.started}
    batch, n_checked = int(tr["batch"]), int(tr["checked_steps"])
    t0 = time.perf_counter()
    utts = traffic.generate(tr, cell.seed)
    mine = rows_of(utts, batch, world, rank)
    stages["inputs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = port_config(cell, batch)
    trainer = Trainer(cfg, list(DEFAULT_LABELS))
    state = trainer.init_state()
    w0 = weights.make(arch, cell.seed, dev, tr.get("head_scale", 1.0))
    state.model.load_state_dict(from_reference_state_dict({k: v.cpu() for k, v in w0.items()}))
    stages["program"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    batches = train.port_batches(mine, batch, cfg)
    stages["batches"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if len(batches) <= n_checked:
        raise ValueError(f"{cell.name}: {len(batches)} global batches leave none past the "
                         f"{n_checked} checked steps")
    named = dict(state.model.named_parameters())
    beta1 = state.optimizer.param_groups[0]["betas"][0]

    def step(b):
        return trainer.train_step(state, b, staged=trainer.put_batch(b))[1]

    losses, program = [], None
    grad_norms, grads = {}, {}
    for i in range(n_checked):
        losses.append(float(step(batches[i])))
        if i == 0 and rank == 0:
            first = train.ref_leaves({
                n: state.optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                / (1 - beta1) for n, p in named.items()}, arch["bidirectional"])
            grad_norms = train.norms(first)
            grads = {k: v.cpu() for k, v in first.items()}
            del first
    if rank == 0:
        moved = train.ref_leaves({n: p.detach() for n, p in named.items()},
                                 arch["bidirectional"])
        change_norms = {k: float(torch.linalg.vector_norm((moved[k] - w0[k]).double()))
                        for k in moved}
        program = ref_train.Readings(losses, grad_norms, change_norms, grads)
        del moved
    del w0
    step(batches[-1])
    harness.sync(dev)
    stages["checked_steps"] = time.perf_counter() - t0

    # the window: every rank ends it after the step at which rank 0 saw the deadline
    host = distributed.host_group() if world > 1 else None
    stop = torch.zeros(1, dtype=torch.int64)
    window_losses = []
    in_flight: deque = deque()
    distributed.barrier()
    harness.sync(dev)
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
        stop[0] = int(time.perf_counter() >= deadline)
        if host is not None:
            dist.broadcast(stop, src=0, group=host)
        if stop[0]:
            break
    harness.sync(dev)
    window_s = time.perf_counter() - started
    setup_s = started - cell.started
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())

    rows = batch * world
    audio_s = float(sum(len(u.samples) for u in utts[:rows])) / counts.SAMPLE_RATE
    frames = counts.frames_of(len(utts[0].samples))
    dtype = "bfloat16" if cfg.trainer.precision == 16 else "float32"
    layer: Dict = {"window": {"seconds": window_s, "steps": n_steps, "dtype": dtype,
                              "flops": n_steps * batch * counts.train_flops(arch, frames)}}
    result_breakdown = None
    notes: Dict = {}
    if cell.trace:
        n_span = int(tr["traced_steps"])
        before = harness.counters()

        def span():
            for i in range(n_span):
                step(batches[i % len(batches)])

        traced = harness.trace_span(span, dev)
        busy = gathered(traced["busy_s"], world)
        traced.update(steps=n_span, busy_s=statistics.fmean(busy))
        layer["span"] = traced
        layer["counters"] = harness.delta(before, harness.counters())
        steps_t = counts.frames_after_convs(frames)
        layer["calls"] = {k: calls * n_span for k, calls in counts.scan_calls(
            arch, True, steps_t, batch, dtype, steps_t * batch).items()}
        result_breakdown = harness.breakdown(traced)
        notes["busy_s_by_rank"] = busy
    peaks = gathered(harness.peak_memory(dev), world)
    gap = rank_gap(state.model, world)

    del state, trainer, named, window_losses, batches
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if rank != 0:
        distributed.barrier()            # until rank 0's reference has run
        return None
    w0 = weights.make(arch, cell.seed, dev, tr.get("head_scale", 1.0))
    t_ref = time.perf_counter()
    reference = ref_train.train_steps(
        w0, arch, train.ref_batches(utts, rows, n_checked, dev),
        train.optim_settings(cfg), divisor=world)
    del w0
    distributed.barrier()
    notes.update({"reference_s": time.perf_counter() - t_ref, "world": world,
                  "memory_peak_bytes_by_rank": peaks, "program_losses": program.losses,
                  "reference_losses": reference.losses, "setup_stages": stages,
                  **check.worst_leaves(program, reference)})
    numbers = dict(check.train_numbers(program, reference), rank_gap=gap)
    return harness.Outcome(
        attempted=n_steps, failed=failed,
        end_to_end={"ddp_train_audio_s_per_s": n_steps * audio_s / window_s},
        setup_s=setup_s, memory_peak_bytes=max(peaks), numbers=numbers, layer=layer,
        breakdown=result_breakdown, notes=notes)
