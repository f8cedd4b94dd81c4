"""Train state and optimizer: the counterpart of dsjax/train/state.py.

Optimizer parity with the reference (model.py:273-297) and with dsjax's
optax chain: AdamW (decoupled weight decay scaled by the learning rate,
betas, eps) or SGD (nesterov, momentum, L2 weight decay added to the
gradient before momentum), both with the per-epoch exponential learning
rate base * anneal^epoch, and a global-norm gradient clip applied before
the optimizer. ``torch.optim.AdamW`` equals ``optax.adamw`` and
``torch.optim.SGD(nesterov=True, weight_decay=...)`` equals
``optax.add_decayed_weights`` + ``optax.sgd(nesterov=True)``;
tests/test_torch_train.py holds both against optax.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import torch
import torch.distributed as dist

from dsjax_torch.config import AdamConfig, OptimConfig, SGDConfig


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), the optimizer and
    its moments, and the step and epoch counters (the epoch drives the
    learning rate)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    epoch: int = 0


def make_optimizer(params: Iterable[torch.nn.Parameter], optim_cfg: OptimConfig
                   ) -> torch.optim.Optimizer:
    """SGD for an SGDConfig, AdamW otherwise (an OptimConfig takes
    AdamConfig's eps and betas), at the base learning rate."""
    lr = optim_cfg.learning_rate
    if isinstance(optim_cfg, SGDConfig):
        return torch.optim.SGD(params, lr=lr, momentum=optim_cfg.momentum, nesterov=True,
                               weight_decay=optim_cfg.weight_decay)
    adam = optim_cfg if isinstance(optim_cfg, AdamConfig) else AdamConfig()
    return torch.optim.AdamW(params, lr=lr, betas=tuple(adam.betas), eps=adam.eps,
                             weight_decay=adam.weight_decay)


def epoch_lr(optim_cfg: OptimConfig, epoch: int) -> float:
    return optim_cfg.learning_rate * optim_cfg.learning_anneal ** epoch


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


@torch.no_grad()
def clip_by_global_norm(grads: Iterable[torch.Tensor], max_norm: float,
                        sharded: Sequence[bool] = (), group=None) -> torch.Tensor:
    """optax.clip_by_global_norm, in place: when the global norm of all
    gradients reaches ``max_norm``, scale each by max_norm / norm (torch's
    clip_grad_norm_ divides by norm + 1e-6 and clips below it). Returns the
    norm before clipping.

    Under tensor parallelism ``sharded`` flags the gradients of which this
    rank holds a block: the norm's square is then their squares summed over
    the model ``group`` plus the replicated gradients' squares counted once,
    the whole tree's norm that optax clips by."""
    grads = list(grads)
    norms = torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    if any(sharded):
        flags = torch.tensor(list(sharded), device=norms.device)
        sq = norms * norms
        shard_sq = torch.where(flags, sq, torch.zeros_like(sq)).sum()
        dist.all_reduce(shard_sq, group=group)
        norm = torch.sqrt(shard_sq + torch.where(flags, torch.zeros_like(sq), sq).sum())
    else:
        norm = torch.linalg.vector_norm(norms)
    # no host sync: where the norm is below the limit both factors are 1
    clipped = norm >= max_norm
    div = torch.where(clipped, norm, torch.ones_like(norm))
    mul = torch.where(clipped, torch.full_like(norm, max_norm), torch.ones_like(norm))
    # one launch a list, not two a gradient, each as exact as the tensor's own
    # div_ and mul_: a model of hundreds of tensors would spend its host time here
    torch._foreach_div_(grads, div)
    torch._foreach_mul_(grads, mul)
    return norm
