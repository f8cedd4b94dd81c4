"""Tensor parallelism over a model group: the counterpart of dsjax's
``trainer.mesh_model`` > 1 (dsjax/parallel/mesh.py ``_param_spec``,
``param_shardings``).

dsjax shards each recurrent layer's w_ih and w_hh (in, G * H) and its b_ih
and b_hh (G * H,) over the model axis in contiguous blocks of G * H / M,
all gates concatenated (at M = 2 an LSTM's card 0 holds i and f, card 1 g
and o), and the head's (H, C) kernel over H. Everything else is
replicated, and so is its optax state. ``shard_model`` does the same on the
port's layout (``mesh.sharding_rules``): each rank keeps only its block of
those parameters, and the optimizer made from ``model.parameters()`` keeps
its AdamW ``exp_avg``/``exp_avg_sq`` (or SGD's momentum) on those blocks.
dsjax replicates its optimizer state; sharding it here changes no number,
since AdamW and SGD update each element from that element's gradient,
moments and value alone.

The step. dsjax's Pallas scans cannot be partitioned (jax lowers a Mosaic
call under a multi-device jit only inside ``shard_map``, which dsjax does
not use), so its tensor-parallel step runs the whole model's ``lax.scan``
with the per-step products split by XLA. The port gathers each layer's
weight blocks over the model group (``whole``; about 8 MB a direction at
H = 1024 in bf16) and runs the input projection and the whole recurrence on
every rank through the scan kernels (K2/K3, K4r/K5 in training, K1/K4 in
evaluation): the same function. It gathers weights and not dsjax's
column-sharded projections xp, which would be T x B x G x H a direction
(512 MB at T = 1024, B = 64, H = 1024) and would leave the recurrence
needing h from every rank at every step. The head's weight is gathered the
same way rather than run row-parallel (partial logits all-reduced, their
input's gradient all-reduced back): it is C x H, 29 x 1024, and one gather
and one product compute it as the whole model does.

Every rank of a model group runs the same computation on the same rows, so
the gradient reaching a gathered tensor is the same on each of them: the
backward of the gather takes the rank's own block of it. A reduce-scatter
would make every sharded gradient M times too large. DDP then averages each
block's gradient over the data group (the ranks holding the same block);
the replicated parameters' gradients, equal within a model group on the
CPU, are made equal bit for bit by a broadcast from its first rank
(``agree_replicated``), so that a device's run-to-run rounding (atomics)
cannot part the replicas.

Checkpoints stay in the unsharded layout: ``whole_state_dicts`` gathers
every sharded parameter and optimizer moment over the model group (a
collective of every rank), and ``own_blocks`` / ``own_optimizer_blocks``
take a rank's blocks of a whole file, so a run saved at one M resumes at
any other, as dsjax's orbax restore reshards.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from dsjax_torch.config import ConformerConfig
from dsjax_torch.parallel.mesh import Groups, sharding_rules

Tensor = torch.Tensor


def _gather(x: Tensor, dim: int, groups: Groups) -> Tensor:
    """The model group's blocks of ``x`` concatenated along ``dim``."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(groups.model_size)]
    dist.all_gather(parts, x, group=groups.model)
    return torch.cat(parts, dim)


class _GatherBlocks(torch.autograd.Function):
    """``_gather``, whose backward takes this rank's block of the (identical
    on every rank) gradient."""

    @staticmethod
    def forward(ctx, x, dim, groups):
        ctx.dim, ctx.groups, ctx.block = dim, groups, x.shape[dim]
        return _gather(x, dim, groups)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.groups.model_index * ctx.block
        return grad.narrow(ctx.dim, start, ctx.block).contiguous(), None, None


def whole(module: nn.Module, name: str, dtype: torch.dtype) -> Tensor:
    """Parameter ``name`` of ``module`` cast to ``dtype`` (the cast before
    the gather halves its bytes in bf16), whole: gathered over the model
    group if ``shard_model`` sharded it, else the parameter itself."""
    x = getattr(module, name).to(dtype)
    dim = getattr(module, "tp_dims", {}).get(name)
    return x if dim is None else _GatherBlocks.apply(x, dim, module.tp_groups)


def _own(t: Tensor, dim: int, groups: Groups) -> Tensor:
    """This rank's block of a whole ``t`` along ``dim``, a tensor of its own."""
    block = t.shape[dim] // groups.model_size
    return t.narrow(dim, groups.model_index * block, block).clone()


def refuse_unsharded(model_cfg, mesh_model: int) -> None:
    """Raise for ``trainer.mesh_model`` > 1 with a model that has no
    sharding rules (``model=conformer``)."""
    if mesh_model > 1 and isinstance(model_cfg, ConformerConfig):
        raise NotImplementedError(
            f"trainer.mesh_model={mesh_model} shards DeepSpeech2's recurrent and head weights; "
            f"model=conformer has no tensor-parallel layout: set trainer.mesh_model=1 and "
            f"train it data-parallel under torchrun")


def shard_model(model: nn.Module, groups: Groups) -> None:
    """Keep only this rank's block of every parameter dsjax shards (at M > 1;
    at M = 1 nothing changes), and mark each owning module so that its
    forward gathers them (``whole``); every module that reduces statistics
    over rows (``stats_group``, the BatchNorms) does so over the data
    group. Build the optimizer afterwards."""
    if groups.model_size == 1:
        return
    for module in model.modules():
        if hasattr(module, "stats_group"):
            module.stats_group = groups.data
    for _, module, attr, dim in sharding_rules(model, groups.model_size):
        p = getattr(module, attr)
        p.data = _own(p.data, dim, groups)
        module.tp_dims = {**getattr(module, "tp_dims", {}), attr: dim}
        module.tp_groups = groups


def sharded_dims(model: nn.Module) -> Dict[str, int]:
    """{parameter name: the dimension it is sharded on} of a sharded model
    (empty for a whole one)."""
    return {f"{prefix}.{attr}" if prefix else attr: dim
            for prefix, module in model.named_modules()
            for attr, dim in getattr(module, "tp_dims", {}).items()}


def model_groups(model: nn.Module) -> Optional[Groups]:
    """The groups a sharded model gathers over (None for a whole one)."""
    for module in model.modules():
        if getattr(module, "tp_dims", None):
            return module.tp_groups
    return None


def whole_shapes(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """The model's state_dict shapes as the whole model has them."""
    dims, groups = sharded_dims(model), model_groups(model)
    shapes = {}
    for name, t in model.state_dict().items():
        shape = list(t.shape)
        if name in dims:
            shape[dims[name]] *= groups.model_size
        shapes[name] = tuple(shape)
    return shapes


def gather_named(model: nn.Module, named: Mapping[str, Tensor]) -> Dict[str, Tensor]:
    """Tensors by parameter name (the parameters, their gradients or one of
    their optimizer moments), each sharded one gathered whole over the model
    group: a collective of every rank of the group, in the same order."""
    dims, groups = sharded_dims(model), model_groups(model)
    return {name: _gather(t, dims[name], groups) if name in dims else t
            for name, t in named.items()}


def _param_names(model: nn.Module, optimizer: torch.optim.Optimizer) -> List[str]:
    """The parameter name of each index of ``optimizer.state_dict()``."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def whole_state_dicts(model: nn.Module, optimizer: torch.optim.Optimizer
                      ) -> Tuple[Dict[str, Tensor], dict]:
    """(model state_dict, optimizer state_dict) of the whole model: the
    model's own for a whole model; for a sharded one every sharded
    parameter and moment gathered over the model group (every rank of the
    group must call this)."""
    model_sd, optim_sd = model.state_dict(), optimizer.state_dict()
    dims, groups = sharded_dims(model), model_groups(model)
    if not dims:
        return model_sd, optim_sd
    names = _param_names(model, optimizer)
    state = {}
    for i, entry in sorted(optim_sd["state"].items()):
        dim = dims.get(names[i])
        state[i] = {k: _gather(v, dim, groups) if dim is not None and torch.is_tensor(v)
                    and v.dim() > 0 else v for k, v in entry.items()}
    return gather_named(model, model_sd), {"state": state,
                                           "param_groups": optim_sd["param_groups"]}


def own_blocks(model: nn.Module, weights: Mapping[str, Tensor]) -> Dict[str, Tensor]:
    """A whole model's state_dict cut to this rank's blocks of the sharded
    parameters (unchanged for a whole model)."""
    dims, groups = sharded_dims(model), model_groups(model)
    return {k: _own(v, dims[k], groups) if k in dims else v for k, v in weights.items()}


def own_optimizer_blocks(model: nn.Module, optimizer: torch.optim.Optimizer,
                         saved: dict) -> dict:
    """A whole model's optimizer state_dict cut to this rank's blocks."""
    dims, groups = sharded_dims(model), model_groups(model)
    if not dims:
        return saved
    names = _param_names(model, optimizer)
    state = {}
    for i, entry in saved["state"].items():
        dim = dims.get(names[int(i)])
        state[i] = {k: _own(v, dim, groups) if dim is not None and torch.is_tensor(v)
                    and v.dim() > 0 else v for k, v in entry.items()}
    return {**saved, "state": state}


def agree_replicated(model: nn.Module, groups: Groups) -> None:
    """Broadcast the replicated parameters' gradients from the first rank
    of the model group, as one flat tensor, so every rank of the group
    applies the same update to them (a no-op at M = 1)."""
    if groups.model_size == 1:
        return
    dims = sharded_dims(model)
    grads = [p.grad for n, p in model.named_parameters() if n not in dims and p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.broadcast(flat, src=dist.get_global_rank(groups.model, 0), group=groups.model)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
