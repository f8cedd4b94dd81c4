"""Seeded weights of a configuration, made on the device.

One generator on the device, seeded with the run's seed, fills one normal
and one uniform buffer for the whole model in two calls; the leaves are
views of them, scaled, in float32 (the type the port keeps parameters in
at every precision). The layout is deepspeech.pytorch's ``state_dict``
(``model.py``): the port loads it through its own converter for that
layout, and the plain reference reads it as it stands.

Initial scales: convolutions LeCun normal, recurrent weights and biases
U(-1/sqrt(H), 1/sqrt(H)), the Lookahead He uniform, the head normal with
std ``head_scale / sqrt(H)``; every BatchNorm a little off identity
(weight 1 + 0.1 U(-1, 1), bias 0.05 N, running mean 0.1 N, running
variance 1 + 0.2 U(0, 1)), so the evaluation forward's running statistics
do work.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench import counts
from portbench.reference import cells

Tensor = torch.Tensor


def leaves(arch: Dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, kind, scale) of every tensor of the state_dict; kind is
    ``normal`` (scale x N), ``uniform`` (U(-scale, scale)), ``bn_weight``,
    ``bn_var`` or ``zero``."""
    h, g = arch["hidden_size"], cells.find(arch["rnn_type"]).GATES
    out: List[Tuple[str, Tuple[int, ...], str, float]] = []

    def bn(prefix: str, n: int) -> None:
        out.extend([(f"{prefix}.weight", (n,), "bn_weight", 0.1),
                    (f"{prefix}.bias", (n,), "normal", 0.05),
                    (f"{prefix}.running_mean", (n,), "normal", 0.1),
                    (f"{prefix}.running_var", (n,), "bn_var", 0.2)])

    c = counts.CONV_CHANNELS
    out.append(("conv.seq_module.0.weight", (c, 1) + counts.CONV1, "normal",
                (counts.CONV1[0] * counts.CONV1[1]) ** -0.5))
    out.append(("conv.seq_module.0.bias", (c,), "zero", 0.0))
    bn("conv.seq_module.1", c)
    out.append(("conv.seq_module.3.weight", (c, c) + counts.CONV2, "normal",
                (c * counts.CONV2[0] * counts.CONV2[1]) ** -0.5))
    out.append(("conv.seq_module.3.bias", (c,), "zero", 0.0))
    bn("conv.seq_module.4", c)
    d0 = counts.conv_out_freq()[1] * c
    sfx = ("", "_reverse") if arch["bidirectional"] else ("",)
    for i in range(arch["hidden_layers"]):
        if i > 0:
            bn(f"rnns.{i}.batch_norm.module", h)
        for s in sfx:
            p = f"rnns.{i}.rnn."
            d_in = d0 if i == 0 else h
            out.extend([(f"{p}weight_ih_l0{s}", (g * h, d_in), "uniform", h ** -0.5),
                        (f"{p}weight_hh_l0{s}", (g * h, h), "uniform", h ** -0.5),
                        (f"{p}bias_ih_l0{s}", (g * h,), "uniform", h ** -0.5),
                        (f"{p}bias_hh_l0{s}", (g * h,), "uniform", h ** -0.5)])
    if not arch["bidirectional"]:
        out.append(("lookahead.0.conv.weight", (h, 1, arch["lookahead_context"]), "uniform",
                    (6.0 / h) ** 0.5))
    bn("fc.0.module.0", h)
    out.append(("fc.0.module.1.weight", (arch["num_classes"], h), "normal", h ** -0.5))
    return out


def make(arch: Dict, seed: int, device, head_scale: float = 1.0) -> Dict[str, Tensor]:
    """The state_dict for ``seed`` on ``device``: the same seed gives the
    same tensors on the same kind of device."""
    spec = leaves(arch)
    n_normal = sum(_numel(s) for _, s, k, _ in spec if k == "normal")
    n_uniform = sum(_numel(s) for _, s, k, _ in spec if k in ("uniform", "bn_weight", "bn_var"))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    normal = torch.randn(n_normal, generator=gen, device=device, dtype=torch.float32)
    uniform = torch.rand(n_uniform, generator=gen, device=device, dtype=torch.float32)
    state: Dict[str, Tensor] = {}
    i_n = i_u = 0
    for name, shape, kind, scale in spec:
        n = _numel(shape)
        if kind == "zero":
            t = torch.zeros(shape, device=device)
        elif kind == "normal":
            t = normal[i_n:i_n + n].view(shape) * scale
            i_n += n
        else:
            u = uniform[i_u:i_u + n].view(shape)
            i_u += n
            if kind == "uniform":
                t = (2.0 * u - 1.0) * scale
            elif kind == "bn_weight":
                t = 1.0 + scale * (2.0 * u - 1.0)
            else:
                t = 1.0 + scale * u
        state[name] = t
    state["fc.0.module.1.weight"].mul_(head_scale)
    return state


def _numel(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
