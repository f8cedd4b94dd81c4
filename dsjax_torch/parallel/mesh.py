"""dsjax's mesh under torch.distributed: the counterpart of
dsjax/parallel/mesh.py.

dsjax builds a ('dcn', 'data', 'model') device mesh, model innermost
(``make_mesh`` reshapes the devices to (dcn, data, model)), shards the
batch over ('dcn', 'data') and, with ``trainer.mesh_model`` = M > 1, the
recurrent and head weights over 'model' (``_param_spec``). The port runs
one process a card, so the mesh becomes arithmetic on the rank and two
kinds of process group:

  * ``check_mesh``: M x mesh_dcn divides the world size and
    ``trainer.mesh_data`` is -1 or world / (M x mesh_dcn), else ValueError;
  * rank r has model index r % M and data index r // M; the dp = world / M
    data indices take the global batch's row blocks, and the M ranks of a
    model group (consecutive ranks) hold the same rows;
  * ``make_groups`` builds, on every rank (``dist.new_group`` is a
    collective), the model group of each data index and the data group of
    each model index. Every reduction over rows (DDP's gradient average,
    the BatchNorm moments, the logged loss) runs over the data group; the
    weight shards are gathered over the model group
    (``parallel/tensor.py``). At M = 1 both are None: the data group is
    the default group, every path is the data-parallel one, and the model
    group does not exist.

Host-side collectives need no group of their own: the agreed shapes and
micro-batch counts are agreed over the world (``multihost``), and
validation sums its WER/CER counts over the world with only model index 0
contributing. ``sharding_rules`` mirrors ``_param_spec`` on the port's
layout; a dimension M does not divide stays replicated, as dsjax's
``param_shardings`` falls back parameter by parameter.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch.distributed as dist
from torch import nn

from dsjax_torch.parallel import distributed


def check_mesh(mesh_data: int, mesh_model: int, mesh_dcn: int, world: int) -> None:
    """Raise ValueError unless the mesh settings describe ``world`` ranks,
    as dsjax's ``make_mesh`` asserts for its devices."""
    if mesh_model < 1 or mesh_dcn < 1 or world % (mesh_model * mesh_dcn):
        raise ValueError(f"trainer.mesh_model={mesh_model} x trainer.mesh_dcn={mesh_dcn} does "
                         f"not divide the world size {world}")
    data = world // (mesh_model * mesh_dcn)
    if mesh_data not in (-1, data):
        raise ValueError(f"trainer.mesh_data={mesh_data} does not match {world} ranks over "
                         f"mesh_model={mesh_model} and {mesh_dcn} node(s): leave it at -1 or "
                         f"set it to {data}")


def data_coords(mesh_model: int) -> Tuple[int, int]:
    """(dp, this rank's data index): the number of row blocks of the global
    batch, and which one this rank holds."""
    return distributed.world_size() // mesh_model, distributed.rank() // mesh_model


@dataclasses.dataclass(frozen=True)
class Groups:
    """This rank's place in the mesh and its two groups (None at M = 1)."""

    model_size: int
    model_index: int
    data_size: int
    data_index: int
    model: Optional[dist.ProcessGroup]
    data: Optional[dist.ProcessGroup]


def make_groups(mesh_model: int) -> Groups:
    """This rank's groups for ``mesh_model`` (checked by ``check_mesh``). At
    M > 1 a collective: every rank calls ``dist.new_group`` for every model
    group and every data group, in the same order; they live until the
    process group is destroyed."""
    world, rank = distributed.world_size(), distributed.rank()
    if mesh_model == 1:
        return Groups(1, 0, world, rank, None, None)
    dp, timeout = world // mesh_model, distributed.timeout()
    model_groups = [dist.new_group(list(range(d * mesh_model, (d + 1) * mesh_model)),
                                   timeout=timeout) for d in range(dp)]
    data_groups = [dist.new_group(list(range(m, world, mesh_model)), timeout=timeout)
                   for m in range(mesh_model)]
    m, d = rank % mesh_model, rank // mesh_model
    return Groups(mesh_model, m, dp, d, model_groups[d], data_groups[m])


# dsjax's _param_spec on the port's layout: (module type name, parameter,
# the dimension dsjax splits over 'model'). Each direction's (G * H, .)
# block of a recurrent weight is dsjax's (., G * H) column-sharded; the
# head's (C, H) weight is dsjax's (H, C) fc/kernel sharded over H
_RULES = {"RecurrentLayer": {"weight_ih": 1, "weight_hh": 1, "bias_ih": 1, "bias_hh": 1},
          "Linear": {"weight": 1}}


def sharding_rules(model: nn.Module, mesh_model: int) -> List[Tuple[str, nn.Module, str, int]]:
    """(parameter name, module, attribute, dimension) of every parameter
    dsjax shards over a model axis of ``mesh_model`` devices: those its
    ``_param_spec`` names whose dimension ``mesh_model`` divides."""
    out = []
    for prefix, module in model.named_modules():
        for attr, dim in _RULES.get(type(module).__name__, {}).items():
            if getattr(module, attr).shape[dim] % mesh_model == 0:
                out.append((f"{prefix}.{attr}" if prefix else attr, module, attr, dim))
    return out
