"""Conformer-CTC in PyTorch: Gulati et al. 2020 ("Conformer: Convolution-augmented
Transformer for Speech Recognition", arXiv:2005.08100, section 2) as NVIDIA
NeMo's ``ConformerEncoder`` builds it for ``conformer_ctc_char.yaml``, with a
character CTC head.

  * subsampling by 4 (NeMo's ``striding``): two Conv2d(3, stride 2, pad 1) +
    ReLU over (time, mel), each output zero past its lengths (L -> (L - 1)
    // 2 + 1), then a Linear over (channel, mel) at each step;
  * x * sqrt(d_model) (NeMo's ``xscaling``), and sinusoidal relative encodings P of
    the offsets T - 1 ... -(T - 1);
  * each block, with its pre-LayerNorms: x + FFN1(x) / 2, then + MHSA, then
    + the conv module, then + FFN2 / 2, then a LayerNorm;
  * FFN: Linear(d, 4d), Swish, Linear(4d, d);
  * MHSA (Transformer-XL's relative attention, Dai et al. 2019): q, k, v of
    ``n_heads`` heads, p = W_pos P (no bias), scores ((q + u) k^T +
    rel_shift((q + v) p^T)) / sqrt(d_k) with u, v per head and per layer,
    keys past each utterance's length masked, softmax, then v and the
    output projection;
  * conv module: pointwise Conv1d(d, 2d), GLU, padded steps set to 0,
    depthwise Conv1d(kernel, groups d), BatchNorm over every position
    (padded ones included, as NeMo's ``ConformerConvolution``), Swish,
    pointwise Conv1d(d, d);
  * head: Linear(d, C) with a bias (NeMo's ``ConvASRDecoder``, a kernel-1
    Conv1d).

The call is ``DeepSpeech2``'s: ``forward(x, lengths, carry=None)`` takes
(B, F, T) features and frame counts and returns (out (B, T', C), out_lengths
(B,), carry): raw logits in training, float32 softmax in evaluation. The
model carries no state between calls, so ``carry`` is always empty, and a
non-empty one raises (``/stream`` needs a recurrent model).

Parameters are float32 and keep NeMo's names and shapes (kernel-1 convs as
(out, in, 1)), under ``encoder.`` and ``decoder.``; ``dtype`` is the compute
type (bfloat16 under ``precision=16``), to which each layer casts its
weights where it uses them, as ``DeepSpeech2`` does. LayerNorm, the softmax
and BatchNorm's statistics run in float32. In training one dropout rate,
the config's ``dropout``, acts where NeMo puts its three (equal) rates:
after the subsampling, inside the FFNs, on the attention probabilities and
on each residual branch. Each module call is a span of ``dsjax_torch.trace``:
``conformer.subsample``, ``conformer.ffn`` (either half-step FFN),
``conformer.attention`` and ``conformer.conv``, each with its pre-LayerNorm.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dsjax_torch.audio.features import stft_params
from dsjax_torch.config import ConformerConfig, SpectConfig
from dsjax_torch.model.ds2 import TorchBatchNorm
from dsjax_torch.trace import span

Tensor = torch.Tensor


def subsampled_lengths(lengths: Tensor) -> Tensor:
    """Lengths after one stride-2 stage (kernel 3, pad 1): (L - 1) // 2 + 1."""
    return torch.div(lengths - 1, 2, rounding_mode="floor") + 1


def relative_positions(n_t: int, d_model: int, device) -> Tensor:
    """(2 n_t - 1, d_model) float32 sinusoids of the offsets n_t - 1 down to
    -(n_t - 1): sin in the even columns, cos in the odd ones."""
    pos = torch.arange(n_t - 1, -n_t, -1, device=device, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, device=device, dtype=torch.float32)
                    * (-math.log(10000.0) / d_model))
    pe = torch.zeros((2 * n_t - 1, d_model), device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def rel_shift(x: Tensor) -> Tensor:
    """(B, H, T, 2T - 1) scores against the offsets T - 1 ... -(T - 1) ->
    (B, H, T, T), entry (i, j) the one of offset i - j (Transformer-XL's
    pad-and-reshape)."""
    b, h, t, n = x.shape
    x = F.pad(x, (1, 0)).view(b, h, n + 1, t)[:, :, 1:].reshape(b, h, t, n)
    return x[..., :t]


def _linear(x: Tensor, layer: nn.Module) -> Tensor:
    """A Linear or kernel-1 Conv1d over the last axis of ``x``, in ``x``'s dtype."""
    weight = layer.weight.to(x.dtype)
    weight = weight[..., 0] if weight.dim() == 3 else weight      # a kernel-1 Conv1d
    return F.linear(x, weight, layer.bias.to(x.dtype) if layer.bias is not None else None)


def _layer_norm(x: Tensor, norm: nn.LayerNorm, dtype: torch.dtype) -> Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                        norm.eps).to(dtype)


class FeedForward(nn.Module):
    """Linear(d, 4d), Swish, dropout, Linear(4d, d) (NeMo's
    ``ConformerFeedForward``)."""

    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)


class RelPositionAttention(nn.Module):
    """NeMo's ``RelPositionMultiHeadAttention``'s parameters: q, k, v and
    output projections with biases, the positional projection without one,
    and the per-head biases u and v."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.h, self.d_k = n_heads, d_model // n_heads
        self.linear_q = nn.Linear(d_model, d_model)
        self.linear_k = nn.Linear(d_model, d_model)
        self.linear_v = nn.Linear(d_model, d_model)
        self.linear_out = nn.Linear(d_model, d_model)
        self.linear_pos = nn.Linear(d_model, d_model, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(n_heads, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_heads, self.d_k))


class ConvModule(nn.Module):
    """NeMo's ``ConformerConvolution``'s parameters; the BatchNorm is the
    port's ``TorchBatchNorm`` over (B, T), so it takes the global batch's
    statistics under DDP."""

    def __init__(self, d_model: int, kernel: int, dtype: torch.dtype):
        super().__init__()
        self.pointwise_conv1 = nn.Conv1d(d_model, 2 * d_model, 1)
        self.depthwise_conv = nn.Conv1d(d_model, d_model, kernel, padding=kernel // 2,
                                        groups=d_model)
        self.batch_norm = TorchBatchNorm(d_model, axes=(0, 1), dtype=dtype)
        self.pointwise_conv2 = nn.Conv1d(d_model, d_model, 1)


class ConformerBlock(nn.Module):
    def __init__(self, cfg: ConformerConfig, dtype: torch.dtype):
        super().__init__()
        d = cfg.d_model
        self.cfg, self.dtype = cfg, dtype
        self.fc_factor = 0.5
        self.norm_feed_forward1 = nn.LayerNorm(d)
        self.feed_forward1 = FeedForward(d, d * cfg.ff_expansion_factor)
        self.norm_self_att = nn.LayerNorm(d)
        self.self_attn = RelPositionAttention(d, cfg.n_heads)
        self.norm_conv = nn.LayerNorm(d)
        self.conv = ConvModule(d, cfg.conv_kernel_size, dtype)
        self.norm_feed_forward2 = nn.LayerNorm(d)
        self.feed_forward2 = FeedForward(d, d * cfg.ff_expansion_factor)
        self.norm_out = nn.LayerNorm(d)

    def _drop(self, x: Tensor) -> Tensor:
        p = self.cfg.dropout
        return F.dropout(x, p, self.training) if p > 0 else x

    def ffn(self, x: Tensor, norm: nn.LayerNorm, ff: FeedForward) -> Tensor:
        with span("conformer.ffn"):
            y = F.silu(_linear(_layer_norm(x, norm, self.dtype), ff.linear1))
            return _linear(self._drop(y), ff.linear2)

    def attention(self, x: Tensor, pos: Tensor, key_mask: Tensor) -> Tensor:
        """The pre-LayerNorm and MHSA of (B, T, d) ``x`` with the (2T - 1, d)
        encodings ``pos``; ``key_mask`` (B, T) is True at valid steps."""
        att = self.self_attn
        b, t, _ = x.shape
        with span("conformer.attention"):
            xn = _layer_norm(x, self.norm_self_att, self.dtype)
            q = _linear(xn, att.linear_q).view(b, t, att.h, att.d_k)
            k = _linear(xn, att.linear_k).view(b, t, att.h, att.d_k).transpose(1, 2)
            v = _linear(xn, att.linear_v).view(b, t, att.h, att.d_k).transpose(1, 2)
            p = _linear(pos, att.linear_pos).view(-1, att.h, att.d_k).transpose(0, 1)
            q_u = (q + att.pos_bias_u.to(self.dtype)).transpose(1, 2)        # (B, H, T, d_k)
            q_v = (q + att.pos_bias_v.to(self.dtype)).transpose(1, 2)
            scores = q_u @ k.transpose(-2, -1) + rel_shift(q_v @ p.transpose(-2, -1))
            scores = scores.float() * (1.0 / math.sqrt(att.d_k))
            scores = scores.masked_fill(~key_mask[:, None, None, :], float("-inf"))
            probs = self._drop(torch.softmax(scores, dim=-1).to(self.dtype))
            out = (probs @ v).transpose(1, 2).reshape(b, t, -1)
            return _linear(out, att.linear_out)

    def conv_module(self, x: Tensor, step_mask: Tensor) -> Tensor:
        """The pre-LayerNorm and conv module of (B, T, d) ``x``;
        ``step_mask`` (B, T, 1) is 1 at valid steps."""
        mod = self.conv
        with span("conformer.conv"):
            y = F.glu(_linear(_layer_norm(x, self.norm_conv, self.dtype), mod.pointwise_conv1),
                      dim=-1) * step_mask
            dw = mod.depthwise_conv
            y = F.conv1d(y.transpose(1, 2), dw.weight.to(self.dtype), dw.bias.to(self.dtype),
                         padding=dw.padding, groups=dw.groups).transpose(1, 2)
            y = F.silu(mod.batch_norm(y))
            return _linear(y, mod.pointwise_conv2)

    def forward(self, x: Tensor, pos: Tensor, key_mask: Tensor, step_mask: Tensor) -> Tensor:
        x = x + self.fc_factor * self._drop(
            self.ffn(x, self.norm_feed_forward1, self.feed_forward1))
        x = x + self._drop(self.attention(x, pos, key_mask))
        x = x + self._drop(self.conv_module(x, step_mask))
        x = x + self.fc_factor * self._drop(
            self.ffn(x, self.norm_feed_forward2, self.feed_forward2))
        return _layer_norm(x, self.norm_out, self.dtype)


class ConvSubsampling(nn.Module):
    """NeMo's ``ConvSubsampling`` (``striding``, factor 4, d_model channels):
    ``conv.0`` and ``conv.2`` the two Conv2d, ``out`` the Linear over
    (channel, mel)."""

    def __init__(self, feat_in: int, d_model: int):
        super().__init__()
        self.conv = nn.ModuleList([nn.Conv2d(1, d_model, 3, 2, 1), nn.ReLU(),
                                   nn.Conv2d(d_model, d_model, 3, 2, 1), nn.ReLU()])
        f = feat_in
        for _ in range(2):
            f = (f - 1) // 2 + 1
        self.out = nn.Linear(d_model * f, d_model)


class Encoder(nn.Module):
    def __init__(self, feat_in: int, cfg: ConformerConfig, dtype: torch.dtype):
        super().__init__()
        self.pre_encode = ConvSubsampling(feat_in, cfg.d_model)
        self.layers = nn.ModuleList(ConformerBlock(cfg, dtype) for _ in range(cfg.n_layers))


class ConvDecoder(nn.Module):
    """NeMo's ``ConvASRDecoder``: a kernel-1 Conv1d(d, C) with a bias."""

    def __init__(self, d_model: int, num_classes: int):
        super().__init__()
        self.decoder_layers = nn.ModuleList([nn.Conv1d(d_model, num_classes, 1)])


class Conformer(nn.Module):
    """Conformer-CTC: ``encoder`` (subsampling, ``n_layers`` blocks) and
    ``decoder`` (the CTC head). ``generator`` seeds the initial weights:
    torch's defaults for the Linear and convolution layers (U(-1/sqrt(fan
    in), 1/sqrt(fan in)) for weights and biases), unit LayerNorm and
    BatchNorm, zero u and v."""

    def __init__(self, num_classes: int, spect_cfg: SpectConfig, model_cfg: ConformerConfig,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if model_cfg.d_model % model_cfg.n_heads:
            raise ValueError(f"model.d_model={model_cfg.d_model} is not a multiple of "
                             f"model.n_heads={model_cfg.n_heads}")
        self.num_classes, self.spect_cfg, self.model_cfg = num_classes, spect_cfg, model_cfg
        self.dtype = dtype
        self.encoder = Encoder(stft_params(spect_cfg)[2], model_cfg, dtype)
        self.decoder = ConvDecoder(model_cfg.d_model, num_classes)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                bound = m.weight[0].numel() ** -0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, RelPositionAttention):
                m.pos_bias_u.zero_()
                m.pos_bias_v.zero_()

    @staticmethod
    def output_lengths(lengths: Tensor) -> Tensor:
        """The frame counts ``forward`` returns for ``lengths`` input frames,
        on the device ``lengths`` is on: one ``subsampled_lengths`` a stage."""
        return subsampled_lengths(subsampled_lengths(lengths.long())).to(torch.int32)

    def subsample(self, x: Tensor, lengths: Tensor) -> Tuple[Tensor, Tensor]:
        """(B, F, T) features -> ((B, T', d) scaled encoder input, (B,) T')."""
        pre, dt = self.encoder.pre_encode, self.dtype
        with span("conformer.subsample"):
            x = x.transpose(1, 2)[:, None].to(dt)                            # (B, 1, T, F)
            for conv in (pre.conv[0], pre.conv[2]):
                lengths = subsampled_lengths(lengths)
                x = F.relu(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), conv.stride,
                                    conv.padding))
                keep = torch.arange(x.shape[2], device=x.device)[None, :] < lengths[:, None]
                x = x * keep[:, None, :, None].to(dt)
            b, c, t, f = x.shape
            x = _linear(x.transpose(1, 2).reshape(b, t, c * f), pre.out)
            x = x * math.sqrt(self.model_cfg.d_model)
        return x, lengths

    def forward(self, x: Tensor, lengths: Tensor,
                carry: Optional[Sequence] = None) -> Tuple[Tensor, Tensor, List]:
        if carry:
            raise ValueError("the Conformer carries no state from one call to the next: "
                             "/stream and chunked carries need a recurrent model")
        lengths = torch.as_tensor(lengths, device=x.device).to(torch.int64)
        cfg = self.model_cfg
        x, out_lengths = self.subsample(x, lengths)
        if self.training and cfg.dropout > 0:
            x = F.dropout(x, cfg.dropout)
        n_t = x.shape[1]
        pos = relative_positions(n_t, cfg.d_model, x.device).to(self.dtype)
        key_mask = torch.arange(n_t, device=x.device)[None, :] < out_lengths[:, None]
        step_mask = key_mask[:, :, None].to(self.dtype)
        for layer in self.encoder.layers:
            x = layer(x, pos, key_mask, step_mask)
        out = _linear(x, self.decoder.decoder_layers[0])                     # (B, T', C)
        if not self.training:
            out = torch.softmax(out.float(), dim=-1)
        return out, out_lengths.to(torch.int32), []
