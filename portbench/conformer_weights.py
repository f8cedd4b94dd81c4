"""Seeded Conformer weights in the reference's names (NeMo's, which the port
keeps), made on the device as ``weights.py`` makes DeepSpeech2's: one
normal and one uniform buffer for the whole model, in two calls.

Scales: every Linear and convolution weight and bias U(-1/sqrt(fan in),
1/sqrt(fan in)) (torch's default), LayerNorms and BatchNorms a little off
identity (weight 1 + 0.1 U(-1, 1), bias 0.05 N; BatchNorm's running mean
0.1 N and variance 1 + 0.2 U(0, 1)), the attention's biases u and v 0.05 N,
so that each takes part in the check.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench import conformer_counts, weights

Tensor = torch.Tensor


def leaves(arch: Dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, kind, scale) of every tensor, kinds as ``weights.leaves``."""
    d, h, k = arch["d_model"], arch["n_heads"], arch["conv_kernel_size"]
    c = d                     # subsampling_conv_channels -1: d_model channels
    ff = d * arch["ff_expansion_factor"]
    f2 = conformer_counts.shapes(arch, 5)[3]
    out: List[Tuple[str, Tuple[int, ...], str, float]] = []

    def dense(prefix: str, shape: Tuple[int, ...], bias: bool = True) -> None:
        fan_in = 1
        for s in shape[1:]:
            fan_in *= s
        out.append((f"{prefix}.weight", shape, "uniform", fan_in ** -0.5))
        if bias:
            out.append((f"{prefix}.bias", shape[:1], "uniform", fan_in ** -0.5))

    def norm(prefix: str, running: bool = False) -> None:
        out.extend([(f"{prefix}.weight", (d,), "bn_weight", 0.1),
                    (f"{prefix}.bias", (d,), "normal", 0.05)])
        if running:
            out.extend([(f"{prefix}.running_mean", (d,), "normal", 0.1),
                        (f"{prefix}.running_var", (d,), "bn_var", 0.2)])

    dense("encoder.pre_encode.conv.0", (c, 1, 3, 3))
    dense("encoder.pre_encode.conv.2", (c, c, 3, 3))
    dense("encoder.pre_encode.out", (d, c * f2))
    for i in range(arch["n_layers"]):
        p = f"encoder.layers.{i}"
        for ffn in ("1", "2"):
            norm(f"{p}.norm_feed_forward{ffn}")
            dense(f"{p}.feed_forward{ffn}.linear1", (ff, d))
            dense(f"{p}.feed_forward{ffn}.linear2", (d, ff))
        norm(f"{p}.norm_self_att")
        for name in ("q", "k", "v", "out"):
            dense(f"{p}.self_attn.linear_{name}", (d, d))
        dense(f"{p}.self_attn.linear_pos", (d, d), bias=False)
        out.extend([(f"{p}.self_attn.pos_bias_u", (h, d // h), "normal", 0.05),
                    (f"{p}.self_attn.pos_bias_v", (h, d // h), "normal", 0.05)])
        norm(f"{p}.norm_conv")
        dense(f"{p}.conv.pointwise_conv1", (2 * d, d, 1))
        dense(f"{p}.conv.depthwise_conv", (d, 1, k))
        norm(f"{p}.conv.batch_norm", running=True)
        dense(f"{p}.conv.pointwise_conv2", (d, d, 1))
        norm(f"{p}.norm_out")
    dense("decoder.decoder_layers.0", (arch["num_classes"], d, 1))
    return out


def make(arch: Dict, seed: int, device) -> Dict[str, Tensor]:
    """The weights for ``seed`` on ``device``: the same seed gives the same
    tensors on the same kind of device."""
    spec = leaves(arch)
    n_normal = sum(weights._numel(s) for _, s, k, _ in spec if k == "normal")
    n_uniform = sum(weights._numel(s) for _, s, k, _ in spec
                    if k in ("uniform", "bn_weight", "bn_var"))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    normal = torch.randn(n_normal, generator=gen, device=device, dtype=torch.float32)
    uniform = torch.rand(n_uniform, generator=gen, device=device, dtype=torch.float32)
    state: Dict[str, Tensor] = {}
    i_n = i_u = 0
    for name, shape, kind, scale in spec:
        n = weights._numel(shape)
        if kind == "normal":
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
    return state
