"""One rank of the port's tensor-parallel runs (``trainer.mesh_model`` = M).

    WORLD_SIZE=<w> RANK=<r> LOCAL_RANK=<r> LOCAL_WORLD_SIZE=<w> MASTER_ADDR=127.0.0.1 \\
        MASTER_PORT=<port> python tests/torch_tp_worker.py --weights W.pt --out OUT_r.pt \\
        --mesh-model M [--model-argv JSON] [--hidden 32] [--optim adam|sgd] [--clip C] \\
        [--rows 4] [--frames 64] [--device cpu|cuda] [--backend gloo] [--fp32] \\
        [--jobs grad,steps,clip,accum,samplers,memory] [--ckpt DIR] [--resume FILE] \\
        [--manifest PATH]

tests/test_torch_tensor_parallel.py launches 2 or 4 on the CPU (gloo);
chip_smoke.py phase 27 launches two sharing one card over gloo (NCCL refuses
two ranks on one device), each then with LOCAL_RANK=0 and
LOCAL_WORLD_SIZE=1. Each rank joins the group (60 s timeout, 600 s on a
card), loads the whole weights and takes its blocks of them, takes its data
index's row block of ``global_batch`` (the last block's rows trimmed to 3/4
of the frames, so ``agree_shapes`` pads them), and saves to --out:

  shapes      its parameters' and (after the steps) their moments' shapes;
  grad        ``grad_step``: the logged loss and the gradients, gathered
              whole (``parallel.tensor.gather_named``);
  steps       ``train_step`` twice from the weights: the losses (with
              ``clip``, the gradients each step clipped, gathered whole as
              the clip got them, and the norm it returned), the parameters gathered
              whole, the replicated ones as held, the BatchNorm running
              stats and ``validate`` on its rows (and the WER/CER counts it
              summed over the ranks); with
              --ckpt the state is saved through ``CheckpointHandler`` and
              one more step taken (``step3``: its loss and parameters);
  resume      with --resume, that file restored (``restore_file``) and one
              step taken from it: the loss and the parameters;
  accum       ``train_step_accum`` of 2 micro-batches from the weights
              (accumulate_grad_batches=2), and the summed step (two
              ``grad_step``s, their sum through ``apply_grads``): the
              loss, the parameters and the running stats of each;
  samplers    the bins ``workflows._pipelines`` gives this rank over
              --manifest, train and validation, epoch 0 and 1;
  counts      on a card, the kernels' launches in the grad step, the two
              train steps and the validation, each counted from 0;
  memory      on a card: the bytes of the parameters and the optimizer
              state (the tensors' own, and ``torch.cuda.memory_allocated``
              over making them), a train step's ``max_memory_allocated``
              above the state, and the ms of 3 train steps after it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from dsjax_torch.config import TrainConfig, compose  # noqa: E402
from dsjax_torch.data.dataset import Batch  # noqa: E402
from dsjax_torch.labels import DEFAULT_LABELS  # noqa: E402


def cfg_argv(hidden: int, device: str, mesh_model: int, model_argv=(), optim: str = "adam",
             clip: float = 5.0, rows: int = 4, layers: int = 2, precision: int = 32
             ) -> List[str]:
    """The runs' configuration; ``clip`` low enough that the global-norm
    clip engages at these widths."""
    return [f"model.hidden_size={hidden}", f"model.hidden_layers={layers}",
            f"trainer.precision={precision}", f"data.batch_size={rows}",
            "data.device_features=false", f"optim={optim}", "seed=7",
            f"trainer.gradient_clip_val={clip}", f"trainer.mesh_model={mesh_model}",
            f"trainer.device={device}", *model_argv]


def global_batch(dp: int, rows: int, frames: int, seed: int = 0) -> Batch:
    """dp x rows rows of (161, frames) features; odd rows half as long, the
    last data index's rows at most 3/4 of ``frames`` long and zero beyond."""
    b = dp * rows
    rng = np.random.default_rng(seed)
    inputs = rng.standard_normal((b, 161, frames)).astype(np.float32)
    lengths = np.full((b,), frames, np.int32)
    lengths[1::2] = frames // 2
    if dp > 1:
        lengths[-rows:] = np.minimum(lengths[-rows:], frames * 3 // 4)
    for i in range(b):
        inputs[i, :, lengths[i]:] = 0.0
    targets = rng.integers(1, len(DEFAULT_LABELS), size=(b, 8)).astype(np.int32)
    return Batch(inputs, lengths, targets, np.full((b,), 8, np.int32),
                 lengths.astype(np.float32) / frames, valid=np.ones((b,), bool))


def local_rows(batch: Batch, dp: int, index: int) -> Batch:
    rows = batch.size // dp
    lo, hi = index * rows, (index + 1) * rows
    t = int(batch.input_lengths[lo:hi].max())
    return Batch(batch.inputs[lo:hi, :, :t], batch.input_lengths[lo:hi], batch.targets[lo:hi],
                 batch.target_lengths[lo:hi], batch.input_percentages[lo:hi],
                 valid=batch.valid[lo:hi])


def fresh(trainer, weights):
    """A state from the whole ``weights``, each rank holding its blocks."""
    from dsjax_torch.parallel import tensor

    state = trainer.init_state(seed=0)
    state.model.load_state_dict(tensor.own_blocks(state.model, weights))
    return state


def whole_params(state) -> Dict[str, torch.Tensor]:
    from dsjax_torch.parallel import tensor

    named = {k: p.detach() for k, p in state.model.named_parameters()}
    return {k: v.cpu().clone() for k, v in tensor.gather_named(state.model, named).items()}


def buffers(state) -> Dict[str, torch.Tensor]:
    return {k: b.detach().cpu().clone() for k, b in state.model.named_buffers()}


def _counted(fn, device):
    """fn's result and the kernels' launches it made (on a card)."""
    if device.type != "cuda":
        return fn(), {}
    from dsjax_torch.ops import gru, lstm

    for scan in (lstm, gru):
        scan.LAUNCHES = scan.STEPS = scan.RESIDUAL_LAUNCHES = scan.BWD_LAUNCHES = 0
    out = fn()
    torch.cuda.synchronize(device)
    return out, {"lstm_fwd": lstm.LAUNCHES, "lstm_fwd_residuals": lstm.RESIDUAL_LAUNCHES,
                 "lstm_bwd": lstm.BWD_LAUNCHES, "gru_fwd": gru.LAUNCHES,
                 "gru_fwd_residuals": gru.RESIDUAL_LAUNCHES, "gru_bwd": gru.BWD_LAUNCHES}


def _samplers(cfg, manifest: str) -> Dict[str, List]:
    from dsjax_torch import workflows

    cfg = compose(TrainConfig, cfg + [f"data.train_path={manifest}",
                                      f"data.val_path={manifest}", "data.num_workers=1"])
    train, val = workflows._pipelines(cfg, list(DEFAULT_LABELS))
    out = {}
    for epoch in (0, 1):
        train.sampler.set_epoch(epoch)
        out[f"train {epoch}"] = [list(b) for b in train.sampler]
    out["val"] = [list(b) for b in val.sampler]
    return out


def _memory(trainer, weights, batch) -> Dict:
    """The allocator's bytes of the parameters and the optimizer state (the
    moments made by one optimizer step on zero gradients, which are then
    dropped), beside the tensors' own bytes; then a train step's peak and
    the ms of 3 train steps after it."""
    device = trainer.device
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    state = fresh(trainer, weights)
    for p in state.model.parameters():
        p.grad = torch.zeros_like(p)
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    torch.cuda.synchronize(device)
    allocated = torch.cuda.memory_allocated(device) - base
    params = sum(p.numel() * p.element_size() for p in state.model.parameters())
    moments = sum(t.numel() * t.element_size() for s in state.optimizer.state.values()
                  for t in s.values() if torch.is_tensor(t) and t.is_cuda)
    state = fresh(trainer, weights)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    state, _ = trainer.train_step(state, batch)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    ms = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, loss = trainer.train_step(state, batch)
        end.record()
        end.synchronize()
        ms.append({"cuda_events": start.elapsed_time(end),
                   "wall": 1e3 * (time.perf_counter() - t0), "loss": float(loss)})
    return {"param_bytes": params, "optimizer_bytes": moments, "allocated_bytes": allocated,
            "step_peak_bytes": peak, "step_ms": ms}


def _recording_clip(state_of, record):
    """``clip_by_global_norm`` that first records the gradients it is given,
    gathered whole, and then the norm it returns."""
    from dsjax_torch.parallel import tensor
    from dsjax_torch.train import loop

    clip = loop.clip_by_global_norm

    def recording(grads, max_norm, *rest):
        grads = list(grads)
        model = state_of().model
        named = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
        assert [g.data_ptr() for g in grads] == [g.data_ptr() for g in named.values()]
        whole = tensor.gather_named(model, {n: g.detach().clone() for n, g in named.items()})
        norm = clip(grads, max_norm, *rest)
        record.append({"grads": {n: g.cpu() for n, g in whole.items()}, "norm": float(norm)})
        return norm

    loop.clip_by_global_norm = recording
    return clip


def run_rank(args) -> Dict:
    from dsjax_torch.parallel import distributed, tensor
    from dsjax_torch.train import loop
    from dsjax_torch.train.checkpoint import CheckpointHandler, restore_file
    from dsjax_torch.train.loop import Trainer

    if args.fp32:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(args.device, backend=args.backend,
                           timeout_s=600.0 if args.device == "cuda" else 60.0)
    argv = cfg_argv(args.hidden, args.device, args.mesh_model, json.loads(args.model_argv),
                    args.optim, args.clip, args.rows, args.layers, args.precision)
    trainer = Trainer(compose(TrainConfig, argv), list(DEFAULT_LABELS))
    g = trainer.groups
    jobs = set(args.jobs.split(","))
    weights = torch.load(args.weights, map_location="cpu")
    a = local_rows(global_batch(g.data_size, args.rows, args.frames, 0), g.data_size,
                   g.data_index)
    b = local_rows(global_batch(g.data_size, args.rows, args.frames, 1), g.data_size,
                   g.data_index)
    out: Dict = {"rank": distributed.rank(), "world": distributed.world_size(),
                 "backend": torch.distributed.get_backend(), "device": str(trainer.device),
                 "model_index": g.model_index, "data_index": g.data_index}
    counts = {}
    out["sharded"] = tensor.sharded_dims(fresh(trainer, weights).model)
    if "grad" in jobs:
        state = fresh(trainer, weights)
        (grads, loss), counts["grad"] = _counted(lambda: trainer.grad_step(state, a),
                                                 trainer.device)
        out["grad"] = {"loss": float(loss), "grads": {
            k: v.cpu() for k, v in tensor.gather_named(state.model, grads).items()}}
    if "steps" in jobs:
        state = fresh(trainer, weights)
        out["shapes"] = {"params": {k: tuple(p.shape) for k, p in
                                    state.model.named_parameters()}}

        def two_steps():
            nonlocal state
            losses = []
            for _ in range(2):
                state, loss = trainer.train_step(state, a)
                losses.append(float(loss))
            return losses

        clipped = []
        plain_clip = _recording_clip(lambda: state, clipped) if "clip" in jobs else None
        try:
            out["losses"], counts["steps"] = _counted(two_steps, trainer.device)
        finally:
            if plain_clip is not None:
                loop.clip_by_global_norm = plain_clip
        out["clipped"] = clipped
        names = {id(p): n for n, p in state.model.named_parameters()}
        out["shapes"]["moments"] = {names[id(p)]: {k: tuple(t.shape) for k, t in s.items()
                                                   if torch.is_tensor(t) and t.dim()}
                                    for p, s in state.optimizer.state.items()}
        out["params"] = whole_params(state)
        out["held"] = {k: p.detach().cpu().clone() for k, p in state.model.named_parameters()
                       if k not in out["sharded"]}
        out["buffers"] = buffers(state)
        totals = []
        plain_sum = loop.sum_ints
        loop.sum_ints = lambda values: totals.append(plain_sum(values)) or totals[-1]
        try:
            out["wer_cer"], counts["validate"] = _counted(lambda: trainer.validate(state, [a]),
                                                          trainer.device)
        finally:
            loop.sum_ints = plain_sum
        out["wer_counts"] = totals[-1]
        if args.ckpt:
            handler = CheckpointHandler(args.ckpt, cfg=trainer.cfg, labels=list(DEFAULT_LABELS))
            written = []
            write = handler._write
            handler._write = lambda path, *rest: (written.append(path), write(path, *rest))
            handler.save(state, {"wer": out["wer_cer"][0]})
            out["written"] = written
            state, loss = trainer.train_step(state, a)
            out["step3"] = {"loss": float(loss), "params": whole_params(state)}
    if args.resume:
        state, _ = restore_file(args.resume, trainer.init_state(seed=1))
        step_before = state.step
        state, loss = trainer.train_step(state, a)
        out["resume"] = {"loss": float(loss), "params": whole_params(state),
                         "steps": (step_before, state.step)}
    if "accum" in jobs:
        state = fresh(trainer, weights)
        state, loss = trainer.train_step_accum(state, [a, b], n_accum=2)
        out["accum"] = {"loss": float(loss), "params": whole_params(state),
                        "buffers": buffers(state)}
        state = fresh(trainer, weights)
        ga, _ = trainer.grad_step(state, a)
        gb, loss = trainer.grad_step(state, b)
        state = trainer.apply_grads(state, {k: ga[k] + gb[k] for k in ga}, 2)
        out["summed"] = {"loss": float(loss), "params": whole_params(state),
                         "buffers": buffers(state)}
    if "samplers" in jobs:
        out["samplers"] = _samplers(argv, args.manifest)
    if "memory" in jobs:
        out["memory"] = _memory(trainer, weights, a)
    out["counts"] = counts
    distributed.destroy()
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--weights", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--mesh-model", type=int, default=2)
    parser.add_argument("--model-argv", default="[]", help="JSON list of model overrides")
    parser.add_argument("--hidden", type=int, default=32)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--precision", type=int, default=32)
    parser.add_argument("--optim", default="adam")
    parser.add_argument("--clip", type=float, default=5.0)
    parser.add_argument("--rows", type=int, default=4)
    parser.add_argument("--frames", type=int, default=64)
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--backend", default=None)
    parser.add_argument("--fp32", action="store_true", help="TF32 off (cuDNN and matmuls)")
    parser.add_argument("--jobs", default="grad,steps,accum")
    parser.add_argument("--ckpt", default="")
    parser.add_argument("--resume", default="")
    parser.add_argument("--manifest", default="")
    args = parser.parse_args()
    torch.save(run_rank(args), args.out)
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
