"""Plain PyTorch Conformer-CTC: the reference the port's Conformer is held to.

Written from the sources, not from the port, in float32 with TF32 off
(``strict_f32``), one utterance at a time wherever the batch is not part of
the arithmetic. Imports neither JAX nor anything of ``dsjax_torch``.

Sources: Gulati et al. 2020, arXiv:2005.08100, section 2 (the block);
NVIDIA NeMo's ``conformer_ctc_char.yaml`` (the Large row: d_model 512, 8 heads,
18 blocks, FFN expansion 4, conv kernel 31, striding subsampling by 4,
relative-position attention with untied per-layer biases, x-scaling, 80 mel
features) and its modules (``ConvSubsampling``, ``RelPositionalEncoding``,
``RelPositionMultiHeadAttention``, ``ConformerConvolution``,
``ConformerFeedForward``, ``ConformerLayer``, ``ConvASRDecoder``,
``FilterbankFeatures``); Transformer-XL (Dai et al. 2019) for the relative
scores.

  * log-mel: the int16 samples over 32768 in float64, pre-emphasis y[i] -
    0.97 y[i - 1] (y[0] kept), n_fft / 2 zeros each side, a frame every
    hop, the symmetric Hann window of window_size seconds centred in n_fft
    points, |rfft|^2, Slaney mel bands (the matrix built here in NumPy),
    log(x + 2^-24), each band normalised over the utterance's frames by its
    mean and its ddof=1 standard deviation plus 1e-5;
  * subsampling: Conv2d(1, C, 3, 2, 1), ReLU, Conv2d(C, C, 3, 2, 1), ReLU
    over (time, mel), Linear(C * F', d) over (channel, mel) at each step;
    lengths L -> (L - 1) // 2 + 1 a stage; then x * sqrt(d);
  * P: sin in the even columns and cos in the odd ones of offset x
    10000^(-2i / d), for the offsets T - 1 down to -(T - 1);
  * a block: x + FFN1(LN(x)) / 2; + MHSA(LN(.)); + Conv(LN(.)); + FFN2(LN(.))
    / 2; then LN;
  * FFN: Linear(d, 4d), Swish, Linear(4d, d);
  * MHSA: q, k, v = Linear(x) in H heads of d / H; p = W_pos P; score(i, j)
    = ((q_i + u) . k_j + (q_i + v) . p_{i - j}) / sqrt(d / H), the second
    term gathered from the offset i - j directly; keys past the length
    masked; softmax; the weighted sum of v; the output Linear;
  * conv module: Conv1d(d, 2d, 1), GLU over channels, steps past the length
    set to 0, depthwise Conv1d(d, d, k, pad k // 2, groups d), BatchNorm over
    (batch, time), every position counted, in training (biased variance;
    running statistics in evaluation), Swish, Conv1d(d, d, 1);
  * head: Conv1d(d, C, 1) with a bias; training returns logits, evaluation
    the softmax.

Departures from the sources:

  * each subsampling stage's output is set to 0 past its length, so that an
    utterance's valid outputs do not depend on how far its row is padded
    (NeMo leaves the padding's convolutions in);
  * no dither (random noise that two computations cannot share), no
    SpecAugment, no dropout;
  * the CTC blank is label 0 of the repo's 29 labels (NeMo puts it last);
  * MHSA masks keys only (NeMo also zeroes padded queries' rows, which no
    valid output reads).

For a control, ``quant`` rounds every operand of a product and every tensor
a bf16 program keeps (each module's output) through a lower precision.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

Tensor = torch.Tensor
Quant = Optional[Callable[[Tensor], Tensor]]

LOG_GUARD = 2.0 ** -24
STD_EPS = 1e-5
BN_EPS = 1e-5
LN_EPS = 1e-5


@contextlib.contextmanager
def strict_f32():
    """Matrix products and convolutions in float32, TF32 off, for the
    duration only."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _q(x: Tensor, quant: Quant) -> Tensor:
    return x if quant is None else quant(x)


# ---------------------------------------------------------------------------
# the front end
# ---------------------------------------------------------------------------

def slaney_mel_matrix(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1): band m a triangle over mel points m, m + 1,
    m + 2 (evenly spaced on the Slaney scale from 0 Hz to Nyquist), scaled by
    2 / (its upper edge - its lower edge) in Hz."""
    def hz_to_mel(hz: float) -> float:
        if hz < 1000.0:
            return 3.0 * hz / 200.0
        return 15.0 + math.log(hz / 1000.0) * 27.0 / math.log(6.4)

    def mel_to_hz(mel: float) -> float:
        if mel < 15.0:
            return 200.0 * mel / 3.0
        return 1000.0 * math.exp((mel - 15.0) * math.log(6.4) / 27.0)

    top = hz_to_mel(sample_rate / 2.0)
    hz = [mel_to_hz(top * i / (n_mels + 1)) for i in range(n_mels + 2)]
    out = np.zeros((n_mels, n_fft // 2 + 1))
    for m in range(n_mels):
        lo, mid, hi = hz[m], hz[m + 1], hz[m + 2]
        for k in range(n_fft // 2 + 1):
            f = k * sample_rate / n_fft
            up, down = (f - lo) / (mid - lo), (hi - f) / (hi - mid)
            out[m, k] = max(0.0, min(up, down)) * 2.0 / (hi - lo)
    return out


def logmel(audio: Tensor, n_samples: Sequence[int], fe: Dict) -> Tuple[Tensor, Tensor]:
    """(B, L) samples (int16, or float in full-scale units), the first
    n_samples[b] of row b real -> ((B, features, T) float32 features, zero
    past each utterance's frames, T the longest's; (B,) frame counts).
    ``fe``: sample_rate, window_size, window_stride, n_fft, features,
    preemph."""
    sr, n_fft = int(fe["sample_rate"]), int(fe["n_fft"])
    hop, win = int(sr * fe["window_stride"]), int(sr * fe["window_size"])
    n = [int(k) for k in n_samples]
    frames = [1 + k // hop for k in n]
    t_max = max(frames)
    k = torch.arange(win, dtype=torch.float64)
    hann = 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / (win - 1))
    window = torch.zeros(n_fft, dtype=torch.float64)
    window[(n_fft - win) // 2:(n_fft - win) // 2 + win] = hann
    mel = torch.from_numpy(slaney_mel_matrix(sr, n_fft, int(fe["features"])))
    scale = 1.0 / 32768.0 if not audio.dtype.is_floating_point else 1.0
    out = torch.zeros((audio.shape[0], int(fe["features"]), t_max))
    for b in range(audio.shape[0]):
        y = audio[b, :n[b]].cpu().to(torch.float64) * scale
        e = torch.cat([y[:1], y[1:] - float(fe["preemph"]) * y[:-1]])
        yp = F.pad(e, (n_fft // 2, n_fft // 2))
        fr = yp.unfold(0, n_fft, hop)[:frames[b]]                              # (T, n_fft)
        power = torch.fft.rfft(fr * window, dim=-1).abs() ** 2                # (T, bins)
        spec = torch.log(mel @ power.T + LOG_GUARD)                            # (features, T)
        mean = spec.mean(dim=1, keepdim=True)
        std = torch.sqrt(((spec - mean) ** 2).sum(dim=1, keepdim=True)
                         / max(frames[b] - 1, 1))
        out[b, :, :frames[b]] = ((spec - mean) / (std + STD_EPS)).to(torch.float32)
    return out.to(audio.device), torch.tensor(frames, device=audio.device)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _lin(x: Tensor, w: Tensor, b: Optional[Tensor], quant: Quant) -> Tensor:
    if w.dim() == 3:                       # a kernel-1 Conv1d
        w = w[:, :, 0]
    y = _q(x, quant) @ _q(w, quant).T
    return y if b is None else y + b


def _ln(x: Tensor, w: Dict[str, Tensor], p: str) -> Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * w[f"{p}.weight"] + w[f"{p}.bias"]


def _swish(x: Tensor) -> Tensor:
    return x * torch.sigmoid(x)


def _valid(lengths: Tensor, n_t: int) -> Tensor:
    """(B, n_t) 1.0 at the valid steps."""
    return (torch.arange(n_t, device=lengths.device)[None, :] < lengths[:, None]).float()


def subsample(w: Dict[str, Tensor], feats: Tensor, lengths: Tensor, arch: Dict,
              quant: Quant) -> Tuple[Tensor, Tensor]:
    """(B, F, T) features -> ((B, T', d), (B,) T')."""
    x = feats.transpose(1, 2)[:, None]                                   # (B, 1, T, F)
    for conv in ("encoder.pre_encode.conv.0", "encoder.pre_encode.conv.2"):
        lengths = torch.div(lengths - 1, 2, rounding_mode="floor") + 1
        x = torch.relu(F.conv2d(_q(x, quant), _q(w[f"{conv}.weight"], quant),
                                w[f"{conv}.bias"], stride=2, padding=1))
        x = _q(x * _valid(lengths, x.shape[2])[:, None, :, None], quant)
    b, c, t, f = x.shape
    x = x.permute(0, 2, 1, 3).reshape(b, t, c * f)
    x = _lin(x, w["encoder.pre_encode.out.weight"], w["encoder.pre_encode.out.bias"], quant)
    if arch.get("xscaling", True):
        x = x * math.sqrt(arch["d_model"])
    return _q(x, quant), lengths


def positions(n_t: int, d: int, device) -> Tensor:
    """(2 n_t - 1, d): row r the encoding of offset n_t - 1 - r."""
    out = torch.zeros((2 * n_t - 1, d), device=device)
    for i in range(0, d, 2):
        rate = 10000.0 ** (-i / d)
        offsets = torch.arange(n_t - 1, -n_t, -1, device=device, dtype=torch.float32)
        out[:, i] = torch.sin(offsets * rate)
        out[:, i + 1] = torch.cos(offsets * rate)
    return out


def ffn(w: Dict[str, Tensor], p: str, x: Tensor, quant: Quant) -> Tensor:
    y = _swish(_lin(x, w[f"{p}.linear1.weight"], w[f"{p}.linear1.bias"], quant))
    return _q(_lin(y, w[f"{p}.linear2.weight"], w[f"{p}.linear2.bias"], quant), quant)


def attention(w: Dict[str, Tensor], p: str, x: Tensor, pos: Tensor, lengths: Tensor,
              n_heads: int, quant: Quant) -> Tensor:
    b, t, d = x.shape
    dk = d // n_heads

    def heads(name: str) -> Tensor:                                       # (B, H, T, dk)
        y = _lin(x, w[f"{p}.linear_{name}.weight"], w[f"{p}.linear_{name}.bias"], quant)
        return y.view(b, t, n_heads, dk).transpose(1, 2)

    q, k, v = heads("q"), heads("k"), heads("v")
    pp = _lin(pos, w[f"{p}.linear_pos.weight"], None, quant)
    pp = pp.view(2 * t - 1, n_heads, dk).transpose(0, 1)                  # (H, 2T - 1, dk)
    q_u = q + w[f"{p}.pos_bias_u"][None, :, None, :]
    q_v = q + w[f"{p}.pos_bias_v"][None, :, None, :]
    content = _q(q_u, quant) @ _q(k, quant).transpose(-2, -1)            # (B, H, T, T)
    by_offset = _q(q_v, quant) @ _q(pp, quant).transpose(-2, -1)         # (B, H, T, 2T - 1)
    i = torch.arange(t, device=x.device)[:, None]
    j = torch.arange(t, device=x.device)[None, :]
    position = by_offset[:, :, i, (t - 1) - (i - j)]                      # offset i - j
    scores = (content + position) / math.sqrt(dk)
    keys = _valid(lengths, t).bool()[:, None, None, :]
    probs = torch.softmax(scores.masked_fill(~keys, float("-inf")), dim=-1)
    out = (_q(probs, quant) @ _q(v, quant)).transpose(1, 2).reshape(b, t, d)
    return _q(_lin(out, w[f"{p}.linear_out.weight"], w[f"{p}.linear_out.bias"], quant), quant)


def batch_norm(x: Tensor, w: Dict[str, Tensor], p: str, train: bool) -> Tensor:
    """(B, T, d) over (B, T), every position counted."""
    if train:
        mean = x.mean(dim=(0, 1))
        var = ((x - mean) ** 2).mean(dim=(0, 1))
    else:
        mean, var = w[f"{p}.running_mean"], w[f"{p}.running_var"]
    return (x - mean) / torch.sqrt(var + BN_EPS) * w[f"{p}.weight"] + w[f"{p}.bias"]


def conv_module(w: Dict[str, Tensor], p: str, x: Tensor, lengths: Tensor, train: bool,
                quant: Quant) -> Tensor:
    y = _lin(x, w[f"{p}.pointwise_conv1.weight"], w[f"{p}.pointwise_conv1.bias"], quant)
    d = y.shape[-1] // 2
    y = y[..., :d] * torch.sigmoid(y[..., d:])
    y = y * _valid(lengths, x.shape[1])[:, :, None]
    kw = w[f"{p}.depthwise_conv.weight"]
    y = F.conv1d(_q(y.transpose(1, 2), quant), _q(kw, quant), w[f"{p}.depthwise_conv.bias"],
                 padding=kw.shape[-1] // 2, groups=d).transpose(1, 2)
    y = _swish(_q(batch_norm(_q(y, quant), w, f"{p}.batch_norm", train), quant))
    return _q(_lin(y, w[f"{p}.pointwise_conv2.weight"], w[f"{p}.pointwise_conv2.bias"], quant),
              quant)


def block(w: Dict[str, Tensor], i: int, x: Tensor, pos: Tensor, lengths: Tensor, arch: Dict,
          train: bool, quant: Quant) -> Tensor:
    p = f"encoder.layers.{i}"
    x = x + 0.5 * ffn(w, f"{p}.feed_forward1", _ln(x, w, f"{p}.norm_feed_forward1"), quant)
    x = x + attention(w, f"{p}.self_attn", _ln(x, w, f"{p}.norm_self_att"), pos, lengths,
                      arch["n_heads"], quant)
    x = x + conv_module(w, f"{p}.conv", _ln(x, w, f"{p}.norm_conv"), lengths, train, quant)
    x = x + 0.5 * ffn(w, f"{p}.feed_forward2", _ln(x, w, f"{p}.norm_feed_forward2"), quant)
    return _q(_ln(x, w, f"{p}.norm_out"), quant)


def forward(w: Dict[str, Tensor], arch: Dict, feats: Tensor, lengths: Tensor, train: bool,
            quant: Quant = None, checkpoint: bool = False) -> Tuple[Tensor, Tensor]:
    """(B, F, T) features -> ((B, T', C) logits in training, softmax in
    evaluation; (B,) T'). ``arch``: d_model, n_heads, n_layers (and
    ``xscaling``, default true). With ``checkpoint`` each block keeps only
    its input for the backward and runs again there."""
    x, out_len = subsample(w, feats, lengths, arch, quant)
    pos = positions(x.shape[1], arch["d_model"], x.device)
    for i in range(arch["n_layers"]):
        if checkpoint:
            x = torch.utils.checkpoint.checkpoint(block, w, i, x, pos, out_len, arch, train,
                                                  quant, use_reentrant=False)
        else:
            x = block(w, i, x, pos, out_len, arch, train, quant)
    logits = _lin(x, w["decoder.decoder_layers.0.weight"], w["decoder.decoder_layers.0.bias"],
                  quant)
    return (logits if train else torch.softmax(logits, dim=-1)), out_len


def ctc_loss_sum(logits: Tensor, out_len: Tensor, targets: Tensor,
                 target_lengths: Tensor) -> Tensor:
    """The batch's summed CTC loss (blank 0, zero_infinity) on the f32
    log-softmax."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return F.ctc_loss(logp.transpose(0, 1), targets, out_len, target_lengths, blank=0,
                      reduction="none", zero_infinity=True).sum()
