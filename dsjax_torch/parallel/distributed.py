"""Multi-process bootstrap for data-parallel training: the counterpart of
dsjax/parallel/distributed.py.

dsjax joins a ``jax.distributed`` cluster and lets GSPMD insert the
collectives. The port runs one process a card, launched by torchrun
(``python -m torch.distributed.run``, the reference's TorchElastic
launcher), and joins a ``torch.distributed`` process group from
torchrun's environment: ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``.
``initialize`` makes two groups over the same ranks:

  * the default group, NCCL for ``cuda`` and gloo for ``cpu``: DDP's
    gradient all-reduce, the BatchNorm statistics
    (``model/ds2.py:TorchBatchNorm``) and the logged loss, or with
    ``trainer.mesh_model`` > 1 the model and data groups made from it
    (``parallel/mesh.py``);
  * a gloo group for host-side collectives (agreed shapes, sub-batch
    counts, WER/CER sums), which need no device synchronisation.

All carry a timeout, so a collective that never completes raises.

Elastic recovery is the reference's: torchrun restarts every rank
(``--max-restarts``, ``--rdzv_backend c10d`` across nodes) and, with
``load_auto_checkpoint=true``, every rank restores the newest checkpoint,
which rank 0 alone writes (``train/checkpoint.py``). A rank that fails
takes the job down: there is no fallback to a single process.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

_host_group = None  # the gloo group of the running job, while one exists
_timeout = None     # the groups' collective timeout, while a job runs


def launched() -> bool:
    """True under torchrun's environment; raises if only part of it is set."""
    present = [k for k in ENV if k in os.environ]
    if present and len(present) != len(ENV):
        missing = [k for k in ENV if k not in os.environ]
        raise ValueError(f"torchrun's environment is incomplete: {missing} unset "
                         f"({present} set)")
    return bool(present)


def active() -> bool:
    """True inside a process group."""
    return dist.is_available() and dist.is_initialized()


def initialize(device: str = "cuda", backend: Optional[str] = None,
               timeout_s: float = 600.0) -> bool:
    """Join the process group torchrun's environment describes, at any world
    size including 1; without that environment do nothing. Returns True if
    this call joined (the caller then ``destroy``s). ``backend`` defaults to
    nccl for a ``cuda`` device and gloo otherwise; a failed join raises."""
    global _host_group, _timeout
    if active() or not launched():
        return False
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    local_rank, local_world = int(os.environ["LOCAL_RANK"]), int(os.environ["LOCAL_WORLD_SIZE"])
    if not (0 <= rank < world and 0 <= local_rank < local_world <= world):
        raise ValueError(f"RANK={rank}, WORLD_SIZE={world}, LOCAL_RANK={local_rank}, "
                         f"LOCAL_WORLD_SIZE={local_world} do not describe a job")
    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK={local_rank} but {torch.cuda.device_count()} "
                               f"CUDA cards are visible: one process a card")
        torch.cuda.set_device(local_rank)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend or ("nccl" if is_cuda else "gloo"), init_method="env://",
                            world_size=world, rank=rank, timeout=timeout)
    _host_group = dist.new_group(backend="gloo", timeout=timeout)
    _timeout = timeout
    return True


def host_group():
    """The gloo group for host-side collectives."""
    if _host_group is None:
        raise RuntimeError("no process group: call dsjax_torch.parallel.distributed.initialize()")
    return _host_group


def timeout() -> datetime.timedelta:
    """The collective timeout the job's groups were made with."""
    if _timeout is None:
        raise RuntimeError("no process group: call dsjax_torch.parallel.distributed.initialize()")
    return _timeout


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def local_rank() -> int:
    return int(os.environ["LOCAL_RANK"]) if active() else 0


def is_main_process() -> bool:
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (on the host group); a no-op outside a group."""
    if active():
        dist.barrier(group=host_group())


def destroy() -> None:
    """Leave the process group (and every group made from it)."""
    global _host_group, _timeout
    if active():
        dist.destroy_process_group()
    _host_group = _timeout = None


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of a group; the backward sums the gradients the
    same way, since every rank's loss depends on every rank's input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (the default group when
    None), differentiable."""
    return _AllReduceSum.apply(x, group)
