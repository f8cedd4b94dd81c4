"""Plain PyTorch DeepSpeech2: the reference the port is held to.

It follows deepspeech.pytorch's ``model.py`` and its loader's spectrogram
(``loader/data_loader.py``), reading the weights in that package's
``state_dict`` layout as ``portbench/weights.py`` makes them:

  * features: the int16 samples over 32768, reflect-padded by n_fft / 2,
    framed every hop (n_fft 320, hop 160 at 16 kHz), a periodic Hamming
    window, |rfft|, log1p, normalised per utterance by the mean and the
    ddof=1 standard deviation of its own frames;
  * two Conv2d + BatchNorm + Hardtanh(0, 20) blocks, each output masked past
    the utterance's length (``MaskConv``);
  * recurrent layers, the cell's ``torch.nn`` module (``cells/<rnn_type>.py``:
    ``torch.nn.LSTM``, ``torch.nn.GRU``) over packed sequences (each
    utterance's own length; the reverse direction starts at its end), two
    directions summed, a sequence-wise BatchNorm before every layer but the
    first (``BatchRNN``);
  * for one direction, the Lookahead convolution (context taps over future
    steps, zero past the end) and a Hardtanh(0, 20);
  * sequence-wise BatchNorm, a bias-free Linear head; in evaluation a
    softmax.

BatchNorm in training normalises with the batch's biased variance over
every position, padded ones included, as ``SequenceWise`` and
``nn.BatchNorm2d`` do; in evaluation it uses the running statistics.

Every matrix product and convolution runs in float32 under ``strict_f32``
(TF32 off, set only around the reference's own work). For the control,
``quant`` rounds every operand of a product and every tensor the program
keeps in its compute type (each module's output, the recurrent carries)
through a lower precision.
Imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from portbench.reference import cells

Tensor = torch.Tensor
Quant = Optional[Callable[[Tensor], Tensor]]

N_FFT, HOP = 320, 160


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


def _round_fp8(x: Tensor, dtype: torch.dtype, largest: float) -> Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / largest
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _round_fp8(grad, torch.float8_e5m2, 57344.0)


def fp8_quant(x: Tensor) -> Tensor:
    """x rounded through float8 as fp8 training rounds a product's operands:
    e4m3 going forward, its gradient e5m2 coming back, each with a
    per-tensor scale that maps its largest magnitude to the type's."""
    return _Fp8.apply(x)


def _q(x: Tensor, quant: Quant) -> Tensor:
    return x if quant is None else quant(x)


def frames_of(n_samples: Tensor) -> Tensor:
    return 1 + torch.div(n_samples, HOP, rounding_mode="floor")


def spectrogram(audio: Tensor, n_samples: Sequence[int]) -> Tuple[Tensor, Tensor]:
    """(B, L) int16 samples, the first n_samples[b] of row b real ->
    ((B, 161, T) float32 features, zero past each length, T the longest
    utterance's frames; (B,) frame counts)."""
    n = torch.as_tensor(list(n_samples), dtype=torch.int64)
    n_frames = frames_of(n)
    t_max = int(n_frames.max())
    window = 0.54 - 0.46 * torch.cos(2 * math.pi * torch.arange(N_FFT, device=audio.device,
                                                                 dtype=torch.float64) / N_FFT)
    out = torch.zeros((audio.shape[0], N_FFT // 2 + 1, t_max), device=audio.device)
    for b in range(audio.shape[0]):
        y = audio[b, :int(n[b])].to(torch.float64) / 32768.0
        yp = F.pad(y[None, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[0, 0]
        frames = yp.unfold(0, N_FFT, HOP)[:int(n_frames[b])]
        spec = torch.log1p(torch.fft.rfft(frames * window, dim=-1).abs()).T
        spec = (spec - spec.mean()) / spec.std(unbiased=True)
        out[b, :, :spec.shape[1]] = spec.to(torch.float32)
    return out, n_frames.to(audio.device)


def batch_norm(x: Tensor, w: Dict[str, Tensor], prefix: str, axes: Tuple[int, ...],
               train: bool, eps: float = 1e-5) -> Tensor:
    shape = [1] * x.dim()
    shape[[a for a in range(x.dim()) if a not in axes][0]] = -1
    if train:
        mean = x.mean(dim=axes)
        var = ((x - mean.reshape(shape)) ** 2).mean(dim=axes)
    else:
        mean, var = w[f"{prefix}.running_mean"], w[f"{prefix}.running_var"]
    return ((x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)
            * w[f"{prefix}.weight"].reshape(shape) + w[f"{prefix}.bias"].reshape(shape))


def _time_mask(x: Tensor, lengths: Tensor) -> Tensor:
    t = torch.arange(x.shape[-1], device=x.device)
    return (t[None, :] < lengths[:, None]).to(x.dtype)[:, None, None, :]


def conv_stack(x: Tensor, lengths: Tensor, w: Dict[str, Tensor], train: bool,
               quant: Quant) -> Tuple[Tensor, Tensor]:
    """(B, 161, T) features -> ((T', B, 32 * 41) recurrent input, (B,) T')."""
    out_len = torch.div(lengths + 2 * 5 - 11, 2, rounding_mode="floor") + 1
    x = x[:, None]
    for conv, bn, stride, pad in ((0, 1, (2, 2), (20, 5)), (3, 4, (2, 1), (10, 5))):
        p = f"conv.seq_module.{conv}"
        x = _q(F.conv2d(_q(x, quant), _q(w[f"{p}.weight"], quant), w[f"{p}.bias"], stride,
                        pad), quant)
        m = _time_mask(x, out_len)
        x = _q(batch_norm(x * m, w, f"conv.seq_module.{bn}", (0, 2, 3), train), quant)
        x = torch.clamp(x * m, 0.0, 20.0) * m
    b, c, f, t = x.shape
    return x.permute(3, 0, 1, 2).reshape(t, b, c * f), out_len


def _layer_weights(w: Dict[str, Tensor], layer: int, bidirectional: bool):
    p = f"rnns.{layer}.rnn."
    sfx = ("", "_reverse") if bidirectional else ("",)
    return {f"{name}{s}": w[f"{p}{name}{s}"] for s in sfx
            for name in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")}


def _packed(x: Tensor, lengths: Tensor, w: Dict[str, Tensor], layer: int, kind: str,
            bidirectional: bool) -> Tensor:
    """The cell's ``torch.nn`` module (``cells/<kind>.py``) over the packed
    sequences, with this layer's weights, as deepspeech.pytorch's
    ``BatchRNN`` runs it."""
    weights = _layer_weights(w, layer, bidirectional)
    n_h = weights["weight_hh_l0"].shape[1]
    cls = cells.find(kind).MODULE
    module = cls(x.shape[-1], n_h, bidirectional=bidirectional, device=x.device)
    packed = torch.nn.utils.rnn.pack_padded_sequence(x, lengths.cpu(), enforce_sorted=False)
    out, _ = torch.func.functional_call(module, weights, (packed,))
    y, _ = torch.nn.utils.rnn.pad_packed_sequence(out, total_length=x.shape[0])
    if bidirectional:
        y = y.view(y.shape[0], y.shape[1], 2, -1).sum(2)
    return y


def recurrent(x: Tensor, lengths: Tensor, w: Dict[str, Tensor], layer: int, kind: str,
              bidirectional: bool, quant: Quant) -> Tensor:
    """One recurrent layer over (T, B, in) -> (T, B, H), directions summed.
    In float32 it is ``_packed``; with ``quant`` a step loop of the same
    recurrence in which every tensor the program keeps in its compute type
    is rounded: the weights and the layer's input once, the projected
    input, and every step the carries and the output."""
    if quant is None:
        return _packed(x, lengths, w, layer, kind, bidirectional)
    lw = _layer_weights(w, layer, bidirectional)
    sfx = ("", "_reverse") if bidirectional else ("",)
    w_ih = quant(torch.stack([lw[f"weight_ih_l0{s}"] for s in sfx]))
    w_hh = quant(torch.stack([lw[f"weight_hh_l0{s}"] for s in sfx]))
    b_ih = torch.stack([lw[f"bias_ih_l0{s}"] for s in sfx])
    b_hh = torch.stack([lw[f"bias_hh_l0{s}"] for s in sfx])
    n_t, n_b, _ = x.shape
    n_d, n_h = len(sfx), w_hh.shape[-1]
    xq = quant(x)
    xp = quant(torch.stack([xq @ w_ih[d].T + b_ih[d] for d in range(n_d)]))  # (D, T, B, GH)
    mask = (torch.arange(n_t, device=x.device)[:, None] < lengths[None, :]).to(x.dtype)
    # the reverse direction runs over the time-flipped padded sequence: it
    # starts in the padding with its carry held at zero, so in effect at
    # each utterance's own end, as a packed sequence does
    if n_d == 2:
        xp = torch.stack([xp[0], xp[1].flip(0)])
        masks = torch.stack([mask, mask.flip(0)])
    else:
        masks = mask[None]
    cell = cells.find(kind)
    carries = tuple(x.new_zeros((n_d, n_b, n_h)) for _ in range(cell.CARRIES))
    ys = []
    for t in range(n_t):
        m = masks[:, t, :, None]
        hp = torch.bmm(quant(carries[0]), w_hh.transpose(1, 2)) + b_hh[:, None, :]
        new = cell.update(xp[:, t], hp, carries)
        ys.append(quant(new[0] * m))
        carries = tuple(quant(m * n + (1 - m) * o) for n, o in zip(new, carries))
    y = torch.stack(ys, dim=1)                                             # (D, T, B, H)
    return y[0] if n_d == 1 else y[0] + y[1].flip(0)


def forward(w: Dict[str, Tensor], arch: Dict, feats: Tensor, lengths: Tensor,
            train: bool, quant: Quant = None, checkpoint: bool = False
            ) -> Tuple[Tensor, Tensor]:
    """(B, 161, T) features -> ((B, T', C) logits in training, softmax
    probabilities in evaluation; (B,) T'). With ``checkpoint`` each
    recurrent layer keeps only its input for the backward and runs again
    there (``torch.utils.checkpoint``): the same numbers in a fraction of
    the memory, for batches whose step loop would not fit."""
    x, out_len = conv_stack(feats, lengths, w, train, quant)
    for i in range(arch["hidden_layers"]):
        if i > 0:
            x = _q(batch_norm(x, w, f"rnns.{i}.batch_norm.module", (0, 1), train), quant)
        args = (x, out_len, w, i, arch["rnn_type"], arch["bidirectional"], quant)
        x = (torch.utils.checkpoint.checkpoint(recurrent, *args, use_reentrant=False)
             if checkpoint else recurrent(*args))
    if not arch["bidirectional"]:
        ctx = arch["lookahead_context"]
        xt = F.pad(x.permute(1, 2, 0), (0, ctx - 1))                       # (B, H, T + ctx - 1)
        x = _q(F.conv1d(_q(xt, quant), _q(w["lookahead.0.conv.weight"], quant),
                        groups=x.shape[-1]).permute(2, 0, 1), quant)
        x = torch.clamp(x, 0.0, 20.0)
    x = _q(batch_norm(x, w, "fc.0.module.0", (0, 1), train), quant)
    logits = _q(_q(x, quant) @ _q(w["fc.0.module.1.weight"], quant).T, quant).transpose(0, 1)
    return (logits if train else torch.softmax(logits, dim=-1)), out_len
