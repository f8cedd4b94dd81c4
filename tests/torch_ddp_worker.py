"""One rank of the port's two-rank data-parallel runs, and the one-process
reference they are held against.

    WORLD_SIZE=2 RANK=<r> LOCAL_RANK=<r> LOCAL_WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 \\
        MASTER_PORT=<port> python tests/torch_ddp_worker.py --weights W.pt --out OUT_r.pt \\
        [--device cpu|cuda] [--backend gloo] [--hidden 32] [--ckpt DIR] [--fp32]

tests/test_torch_distributed.py launches two on the CPU (gloo);
chip_smoke.py phase 23 launches two sharing one card over gloo (NCCL
refuses two ranks on one device), each then with LOCAL_RANK=0 and
LOCAL_WORLD_SIZE=1. Each rank joins the group
(``parallel.distributed.initialize``, 60 s timeout), loads the weights,
takes its row block of ``global_batch()`` (rank 0's rows padded to 64
frames, rank 1's trimmed to 48, so ``agree_shapes`` has to pad them) and
saves to --out:

  grad           ``grad_step``: the logged loss and the averaged gradients;
  losses         2 ``train_step``s from the weights again (SGD), then
  params, buffers, wer_cer   the parameters, the BatchNorm running stats
                 and ``validate`` on its rows;
  accum          ``train_step_accum`` of 2 micro-batches from the weights
                 (accumulate_grad_batches=2): the loss and the parameters;
  masks          the device SpecAugment masks of its rows at step 5;
  agreed         ``agree_shapes`` of arrays whose trailing dims differ by rank;
  moments        ``global_moments`` of ``moments_inputs()``, whose row
                 counts differ by rank, and the gradient of its input;
  spans          one ``train_step`` under a CPU profiler: each span's
                 parents by name (``dsjax_torch.trace``), the host
                 collectives' ``ddp.agree`` and ``ddp.reduce`` among them;
  errors         what ``agree_shapes`` on differing batch sizes,
                 ``train_step_accum`` with 2 sub-batches on rank 0 and 1 on
                 rank 1, and ``fit`` at ragged_split=2 over a last bin too
                 short to split raised (each must raise on both ranks);
  written        with --ckpt, the files this rank wrote when the state after
                 the 2 steps was saved through ``CheckpointHandler``.

``reference`` computes the same quantities in one process on the union
batch, where dsjax's ``loss / dp`` becomes the summed gradient divided by
the world size (``apply_grads(..., n_accum=world)``).
"""

from __future__ import annotations

import argparse
import os
import sys
import warnings
from typing import Dict, List

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from dsjax_torch.config import TrainConfig, compose  # noqa: E402
from dsjax_torch.data.dataset import Batch  # noqa: E402
from dsjax_torch.labels import DEFAULT_LABELS  # noqa: E402

WORLD, ROWS, FRAMES, RANK1_FRAMES, MASK_STEP = 2, 4, 64, 48, 5


def cfg_argv(hidden: int, device: str) -> List[str]:
    """The runs' configuration: SGD, whose update is linear in the gradient
    (Adam's first step is about lr * sign(g) and magnifies noise in
    near-zero gradients, tests/test_torch_train.py)."""
    return [f"model.hidden_size={hidden}", "model.hidden_layers=2", "trainer.precision=32",
            f"data.batch_size={ROWS}", "data.device_features=false", "optim=sgd", "seed=7",
            f"trainer.device={device}"]


def mask_argv() -> List[str]:
    return ["data.augmentation.spec_augment=true", "data.augmentation.spec_augment_device=true"]


def global_batch(seed: int = 0) -> Batch:
    """WORLD x ROWS rows of (161, FRAMES) features; odd rows half as long,
    rank 1's rows at most RANK1_FRAMES long and zero beyond, as
    tests/multiproc_common.py builds dsjax's."""
    b = WORLD * ROWS
    rng = np.random.default_rng(seed)
    inputs = rng.standard_normal((b, 161, FRAMES)).astype(np.float32)
    lengths = np.full((b,), FRAMES, np.int32)
    lengths[1::2] = FRAMES // 2
    lengths[ROWS:] = np.minimum(lengths[ROWS:], RANK1_FRAMES)
    for i in range(b):
        inputs[i, :, lengths[i]:] = 0.0
    targets = rng.integers(1, len(DEFAULT_LABELS), size=(b, 8)).astype(np.int32)
    return Batch(inputs, lengths, targets, np.full((b,), 8, np.int32),
                 lengths.astype(np.float32) / FRAMES, valid=np.ones((b,), bool))


def local_rows(batch: Batch, rank: int) -> Batch:
    lo, hi = rank * ROWS, (rank + 1) * ROWS
    t = RANK1_FRAMES if rank == 1 else FRAMES
    return Batch(batch.inputs[lo:hi, :, :t], batch.input_lengths[lo:hi], batch.targets[lo:hi],
                 batch.target_lengths[lo:hi], batch.input_percentages[lo:hi],
                 valid=batch.valid[lo:hi])


def agree_inputs(rank: int):
    return (np.full((2, 3 + rank), rank + 1, np.int32),
            np.full((2, 5 - 3 * rank, 1 + 5 * rank), 0.5, np.float32))


def moments_inputs() -> List[torch.Tensor]:
    """Each rank's (rows, 5) input to ``global_moments``: 3 rows, then 7."""
    rng = np.random.default_rng(11)
    return [torch.from_numpy(rng.standard_normal((3 + 4 * r, 5)).astype(np.float32))
            for r in range(WORLD)]


def moments_weights() -> torch.Tensor:
    """(2, 5): the loss sum(w[0] * mean + w[1] * var) each rank takes."""
    return torch.from_numpy(np.random.default_rng(12).standard_normal((2, 5)).astype(np.float32))


def _moments(rank: int) -> Dict[str, torch.Tensor]:
    from dsjax_torch.model.ds2 import global_moments

    x = moments_inputs()[rank].requires_grad_()
    mean, var, unbias = global_moments(x, (0,))
    w = moments_weights()
    (w[0] * mean + w[1] * var).sum().backward()
    return {"mean": mean.detach(), "var": var.detach(), "unbias": unbias, "grad": x.grad}


def _fit_over_an_uneven_last_bin(argv: List[str], out_dir: str, rank: int) -> str:
    """``fit`` on workflows' pipelines at ragged_split=2, batch 4, over 6
    utterances: one rank's bin of 4 comes as 2 sub-batches, the other's
    bin of 2 (fewer than 2 x 2) as one batch. What it raised."""
    from dsjax_torch import workflows
    from dsjax_torch.train.loop import Trainer
    from tests.synthetic_manifest import write_manifest

    path = write_manifest(os.path.join(out_dir, f"ragged_rank{rank}"), "train",
                          [0.6, 0.5, 0.7, 0.4, 0.8, 0.5], seed=3)
    cfg = compose(TrainConfig, argv + [f"data.train_path={path}", f"data.val_path={path}",
                                       "data.ragged_split=2", "data.num_workers=1",
                                       "trainer.max_epochs=1"])
    train, val = workflows._pipelines(cfg, list(DEFAULT_LABELS))
    try:
        Trainer(cfg, list(DEFAULT_LABELS)).fit(train, val, log_fn=lambda line: None)
    except RuntimeError as e:
        return str(e)
    return ""


def _fresh(trainer, weights):
    state = trainer.init_state(seed=0)
    state.model.load_state_dict(weights)
    return state


def _snapshot(state) -> Dict[str, Dict[str, torch.Tensor]]:
    return {"params": {k: p.detach().cpu().clone() for k, p in state.model.named_parameters()},
            "buffers": {k: b.detach().cpu().clone() for k, b in state.model.named_buffers()}}


def _masks(argv: List[str], batch: Batch, device) -> torch.Tensor:
    from dsjax_torch.train.loop import Trainer

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # spec_augment_device's time-warp warning
        trainer = Trainer(compose(TrainConfig, argv + mask_argv()), list(DEFAULT_LABELS))
    ones = torch.ones((batch.size, 161, FRAMES), device=device)
    lens = torch.as_tensor(batch.input_lengths, device=device)
    return trainer._device_augment(ones, lens, MASK_STEP).cpu()


def _spans(trainer, weights, batch: Batch) -> Dict[str, Dict]:
    from dsjax_torch import trace

    trace.reset()
    state = _fresh(trainer, weights)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        trainer.train_step(state, batch)
    return {name: row["parents"] for name, row in trace.summary().items()}


def run_rank(args) -> Dict:
    from dsjax_torch.parallel import distributed
    from dsjax_torch.parallel.multihost import agree_shapes
    from dsjax_torch.train.checkpoint import CheckpointHandler
    from dsjax_torch.train.loop import Trainer

    if args.fp32:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(args.device, backend=args.backend, timeout_s=60.0)
    rank = distributed.rank()
    argv = cfg_argv(args.hidden, args.device)
    trainer = Trainer(compose(TrainConfig, argv), list(DEFAULT_LABELS))
    weights = torch.load(args.weights, map_location="cpu")
    a, b = local_rows(global_batch(0), rank), local_rows(global_batch(1), rank)
    out: Dict = {"rank": rank, "world": distributed.world_size(),
                 "backend": torch.distributed.get_backend(), "device": str(trainer.device)}

    state = _fresh(trainer, weights)
    grads, loss = trainer.grad_step(state, a)
    out["grad"] = {"loss": float(loss), "grads": {k: g.cpu() for k, g in grads.items()}}

    state = _fresh(trainer, weights)
    losses = []
    for _ in range(2):
        state, loss = trainer.train_step(state, a)
        losses.append(float(loss))
    out["losses"] = losses
    out.update(_snapshot(state))
    out["wer_cer"] = trainer.validate(state, [a])
    out["ddp_wrapped"] = type(trainer._ddp).__name__
    if args.ckpt:
        handler = CheckpointHandler(args.ckpt, cfg=trainer.cfg, labels=list(DEFAULT_LABELS))
        written = []
        write = handler._write
        handler._write = lambda path, *rest: (written.append(path), write(path, *rest))
        handler.save(state, {"wer": out["wer_cer"][0]})
        out["written"] = written

    state = _fresh(trainer, weights)
    state, loss = trainer.train_step_accum(state, [a, b], n_accum=2)
    out["accum"] = {"loss": float(loss), **_snapshot(state)}

    out["masks"] = _masks(argv, a, trainer.device)
    out["agreed"] = agree_shapes(agree_inputs(rank))
    out["moments"] = _moments(rank)
    out["spans"] = _spans(trainer, weights, a)

    errors = {}
    try:
        agree_shapes((np.zeros((2 + rank, 3), np.float32),))
    except ValueError as e:
        errors["agree_shapes"] = str(e)
    try:
        trainer.train_step_accum(_fresh(trainer, weights), [a, b] if rank == 0 else [a],
                                 n_accum=1)
    except RuntimeError as e:
        errors["ragged"] = str(e)
    errors["fit_ragged"] = _fit_over_an_uneven_last_bin(
        argv, os.path.dirname(os.path.abspath(args.out)), rank)
    out["errors"] = errors
    distributed.destroy()
    return out


def reference(argv: List[str], weights: Dict[str, torch.Tensor], world: int = WORLD) -> Dict:
    """The same quantities in one process on the union batch (padded to
    FRAMES): the per-rank gradient average is the summed gradient over the
    world size. The masks are the union batch's; the loss is the sum over
    the world size, as the ranks log it."""
    from dsjax_torch.train.loop import Trainer

    trainer = Trainer(compose(TrainConfig, argv), list(DEFAULT_LABELS))
    a, b = global_batch(0), global_batch(1)
    out: Dict = {}
    state = _fresh(trainer, weights)
    grads, loss = trainer.grad_step(state, a)
    out["grad"] = {"loss": float(loss) / world,
                   "grads": {k: g.cpu() / world for k, g in grads.items()}}

    state = _fresh(trainer, weights)
    losses = []
    for _ in range(2):
        grads, loss = trainer.grad_step(state, a)
        state = trainer.apply_grads(state, grads, world)
        losses.append(float(loss) / world)
    out["losses"] = losses
    out.update(_snapshot(state))
    out["wer_cer"] = trainer.validate(state, [a])

    state = _fresh(trainer, weights)
    ga, _ = trainer.grad_step(state, a)
    gb, loss = trainer.grad_step(state, b)
    state = trainer.apply_grads(state, {k: ga[k] + gb[k] for k in ga}, 2 * world)
    out["accum"] = {"loss": float(loss) / world, **_snapshot(state)}
    out["masks"] = _masks(argv, a, trainer.device)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--weights", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--backend", default=None)
    parser.add_argument("--hidden", type=int, default=32)
    parser.add_argument("--ckpt", default="")
    parser.add_argument("--fp32", action="store_true", help="TF32 off (cuDNN and matmuls)")
    args = parser.parse_args()
    torch.save(run_rank(args), args.out)
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
