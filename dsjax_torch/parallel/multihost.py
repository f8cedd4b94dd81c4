"""Host-side agreement between ranks: the counterpart of
dsjax/parallel/multihost.py.

Each rank loads only its own batches (the rank-strided samplers of
``data/sampler.py``) and collates them to its own bucketed shapes. dsjax
then pads every host's arrays to the elementwise maximum over the hosts
(``agree_shapes``), because SPMD needs one program on every host; the
padded frames also enter its BatchNorm means. The port pads the same way,
so its global BatchNorm statistics are dsjax's. The collectives here run
on the gloo host group (``distributed.host_group``) and touch no device.
With more than one rank the all-gathers of ``agree_shapes`` and
``agree_count`` run in a ``ddp.agree`` span (``dsjax_torch.trace``): the
host's wait for the other ranks.

dsjax's ``make_global`` and ``host_local_rows`` have no counterpart: under
DDP a rank never holds another rank's rows, so there is no global array to
assemble or to slice.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dsjax_torch.parallel import distributed
from dsjax_torch.trace import span


def _gather(values: np.ndarray) -> np.ndarray:
    """(world, n) int64: every rank's ``values`` (n equal on every rank)."""
    t = torch.from_numpy(np.ascontiguousarray(values, dtype=np.int64))
    out = [torch.empty_like(t) for _ in range(distributed.world_size())]
    dist.all_gather(out, t, group=distributed.host_group())
    return torch.stack(out).numpy()


def agree_shapes(arrays: Sequence[np.ndarray]) -> Tuple[np.ndarray, ...]:
    """Zero-pad each array's trailing dimensions to the largest any rank
    holds, so every rank holds the same shapes: one all-gather of the
    concatenated shape vectors, as dsjax's does. The leading (batch)
    dimensions must already agree (the pipelines pad every batch to
    ``data.batch_size`` rows); where they differ every rank raises."""
    if distributed.world_size() == 1:
        return tuple(arrays)
    shapes = np.concatenate([np.asarray(a.shape, np.int64) for a in arrays])
    with span("ddp.agree"):
        gathered = _gather(shapes)
    mx = gathered.max(axis=0)
    out = []
    off = 0
    for i, a in enumerate(arrays):
        rows = gathered[:, off]
        if (rows != rows[0]).any():
            raise ValueError(f"the batch sizes of array {i} differ across ranks: "
                             f"{rows.tolist()}; the pipelines must pad every batch to "
                             f"data.batch_size rows")
        tgt = mx[off:off + a.ndim]
        off += a.ndim
        pad = [(0, int(t) - s) for t, s in zip(tgt, a.shape)]
        out.append(np.pad(a, pad) if any(p[1] for p in pad) else a)
    return tuple(out)


def agree_count(n: int, what: str) -> None:
    """Raise on every rank unless every rank passes the same ``n``: the
    ranks must issue the same collectives, and a count that differs would
    leave one waiting on another."""
    if distributed.world_size() == 1:
        return
    with span("ddp.agree"):
        counts = _gather(np.asarray([n]))[:, 0].tolist()
    if len(set(counts)) != 1:
        raise RuntimeError(f"the ranks disagree on {what}: {counts} (by rank)")


def sum_ints(values: Sequence[int]) -> List[int]:
    """Integer sums over the ranks (exact; the host group)."""
    if distributed.world_size() == 1:
        return [int(v) for v in values]
    return [int(v) for v in _gather(np.asarray(values)).sum(axis=0)]
