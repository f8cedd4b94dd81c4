"""The port's training state in dsjax's tree layout: the inverse of
``dsjax_torch.model.convert.from_dsjax_params`` and of what
``dsjax_torch.train.checkpoint.from_dsjax_state`` reads.

Used by the CPU tests and by chip_smoke.py (phase 25), to run a trainer's
file through the conversion and back; it imports only numpy and torch.
"""

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_LEAF = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value: np.ndarray) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def to_dsjax_trees(named: Mapping[str, torch.Tensor]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Tensors by the port's state_dict names (parameters, or an optimizer
    state by parameter name) -> (a tree in dsjax's ``params`` layout, one in
    its ``batch_stats`` layout), numpy, every value carried exactly."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for name, t in named.items():
        a = t.detach().cpu().numpy()
        parts = name.split(".")
        if parts[0] == "rnns":
            i, key = parts[1], parts[2]
            short = {"weight_ih": "w_ih", "weight_hh": "w_hh", "bias_ih": "b_ih",
                     "bias_hh": "b_hh"}[key]
            for d, direction in zip(range(a.shape[0]), ("fwd", "bwd")):
                _set(params, (f"rnn{i}", f"{direction}_{short}"),
                     a[d].T.copy() if key.startswith("weight") else a[d].copy())
            continue
        if parts[0] == "conv" and parts[1].startswith("conv"):
            # OIHW -> HWIO (kF, kT, I, O)
            _set(params, ("conv", parts[1], "kernel" if parts[2] == "weight" else "bias"),
                 a.transpose(2, 3, 1, 0).copy() if parts[2] == "weight" else a)
            continue
        if name == "fc.weight":
            _set(params, ("fc", "kernel"), a.T.copy())
            continue
        if name == "lookahead.weight":
            _set(params, ("lookahead", "weight"), a)
            continue
        prefix = {"conv": ("conv", parts[1]), "fc_bn": ("fc_bn",)}.get(parts[0])
        if parts[0] == "rnn_bns":
            prefix = (f"rnn{int(parts[1]) + 1}_bn",)
        leaf = parts[-1]
        _set(stats if leaf.startswith("running") else params, prefix + (_LEAF[leaf],), a)
    return params, stats


def to_dsjax_state(state) -> Dict[str, Any]:
    """A port TrainState (AdamW or SGD) -> the inputs of
    ``from_dsjax_state``: params, batch_stats, moments, step, epoch."""
    params, stats = to_dsjax_trees(state.model.state_dict())
    named = dict(state.model.named_parameters())
    per = {n: state.optimizer.state[p] for n, p in named.items()}
    if all("momentum_buffer" in s for s in per.values()):
        moments = {"trace": to_dsjax_trees({n: s["momentum_buffer"] for n, s in per.items()})[0]}
    else:
        counts = {float(s["step"]) for s in per.values()}
        assert len(counts) == 1, counts
        moments = {"count": int(counts.pop()),
                   "mu": to_dsjax_trees({n: s["exp_avg"] for n, s in per.items()})[0],
                   "nu": to_dsjax_trees({n: s["exp_avg_sq"] for n, s in per.items()})[0]}
    return {"params": params, "batch_stats": stats, "moments": moments,
            "step": state.step, "epoch": state.epoch}
