"""DeepSpeech2 acoustic model in PyTorch: the counterpart of dsjax/model/ds2.py.

Conv frontend with per-module length masking, N recurrent layers (LSTM,
GRU or vanilla tanh RNN; bidirectional with summed directions, or one
direction followed by the Lookahead convolution) with sequence-wise
BatchNorm, a BatchNorm + bias-free Linear head, and softmax in eval mode.
The RNN carry goes in and out per layer, so chunked streaming continues the
state across calls.

Layouts at the public functions are dsjax's: spectrograms (B, F, T), time
major (T, B, .) inside the recurrent layers, posteriors (B, T', C). The
convolutions run NCHW (``F.conv2d``); the flattened conv feature index is
c * F' + f, as in dsjax and the reference.

Parameters live in float32; ``dtype`` is the compute dtype (bfloat16 for
``precision=16``), cast at use as dsjax does. Each recurrent layer projects
the inputs of all time steps in one matrix product and runs only the
recurrence: LSTM in ``dsjax_torch.ops.lstm.lstm_scan`` and GRU in
``dsjax_torch.ops.gru.gru_scan``, CUDA kernels on CUDA tensors. The vanilla
RNN has no kernel in dsjax (a plain ``lax.scan``, dsjax/model/ds2.py:306-313),
so here it is a plain per-step loop (``rnn_scan``) on every device.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dsjax_torch.config import BiDirectionalConfig, RNNType, SpectConfig, UniDirectionalConfig
from dsjax_torch.ops.gru import gru_scan
from dsjax_torch.ops.lstm import _flip, lstm_scan
from dsjax_torch.parallel import distributed
from dsjax_torch.parallel.tensor import whole

Tensor = torch.Tensor
Carry = Tuple[Tensor, ...]         # LSTM (h, c), GRU and RNN (h,), each (D, B, H)

GATES = {RNNType.lstm: 4, RNNType.gru: 3, RNNType.rnn: 1}


def get_seq_lens(lengths: Tensor) -> Tensor:
    """Time lengths after the conv stack: time kernels 11, pad 5, strides 2
    then 1, so L -> (L - 1) // 2 + 1."""
    lengths = lengths.to(torch.int32)
    l1 = torch.div(lengths + 2 * 5 - 1 * (11 - 1) - 1, 2, rounding_mode="floor") + 1
    l2 = torch.div(l1 + 2 * 5 - 1 * (11 - 1) - 1, 1, rounding_mode="floor") + 1
    return l2


def rnn_input_size(spect_cfg: SpectConfig) -> int:
    """Flattened conv-output feature size."""
    size = int(np.floor(spect_cfg.sample_rate * spect_cfg.window_size / 2) + 1)
    size = int(np.floor(size + 2 * 20 - 41) / 2 + 1)
    size = int(np.floor(size + 2 * 10 - 21) / 2 + 1)
    return size * 32


def hardtanh_0_20(x: Tensor) -> Tensor:
    return torch.clamp(x, 0.0, 20.0)


def global_moments(xf: Tensor, axes: Tuple[int, ...], group=None
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """(mean, biased variance, N / (N - 1)) of f32 ``xf`` over ``axes`` and
    every rank of ``group`` (the default group when None), N the global
    count.

    One all-reduce of [n_r E_r[x], n_r E_r[x^2], n_r] in f64, divided by
    the global N, so ranks holding different counts weigh by them and N is
    exact. At world size 1, n E[x] / n is E[x] exactly in f64, so the
    moments are the single-process path's bit for bit. The backward
    all-reduces their gradients (``distributed.all_reduce_sum``)."""
    f = xf.shape[[a for a in range(xf.dim()) if a not in axes][0]]
    n = math.prod(xf.shape[a] for a in axes)
    local = torch.cat([xf.mean(dim=axes).double() * n, (xf * xf).mean(dim=axes).double() * n,
                       xf.new_full((1,), n, dtype=torch.float64)])
    total = distributed.all_reduce_sum(local, group)
    count = total[2 * f:].detach()
    mean = (total[:f] / count).float()
    var = (total[f:2 * f] / count).float() - mean * mean
    return mean, var, (count / torch.clamp_min(count - 1, 1)).float()


class TorchBatchNorm(nn.Module):
    """BatchNorm over the given reduction axes with torch's semantics.

    Training normalizes with the biased batch variance and moves the running
    stats by momentum 0.1, the variance with its unbiased estimate; the
    statistics include padded (zeroed) positions. Eval uses the running
    stats, with mean and rsqrt cast to the compute dtype before use.

    Inside a process group (``parallel.distributed``, world size 1
    included) training takes the statistics of the global batch, as dsjax's
    do (its means run over a batch sharded across the mesh): one
    differentiable all-reduce of the ranks' sums and counts
    (``global_moments``) over ``stats_group``: the default group, or under
    tensor parallelism the data group (``parallel.tensor.shard_model`` sets
    it), since the M ranks of a model group hold the same rows. The count
    is the global one in the unbiased factor, so every rank's running stats
    move alike.
    """

    def __init__(self, num_features: int, axes: Tuple[int, ...], eps: float = 1e-5,
                 momentum: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.axes = tuple(axes)
        self.eps = eps
        self.momentum = momentum
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.stats_group = None   # the process group the statistics span (None: default)

    def forward(self, x: Tensor) -> Tensor:
        shape = [1] * x.dim()
        (feat_axis,) = [a for a in range(x.dim()) if a not in self.axes]
        shape[feat_axis] = -1
        if self.training:
            xf = x.float()
            if distributed.active():
                mean, var, unbias = global_moments(xf, self.axes, self.stats_group)
            else:
                mean = xf.mean(dim=self.axes)
                var = (xf * xf).mean(dim=self.axes) - mean * mean
                n = math.prod(x.shape[a] for a in self.axes)
                unbias = n / max(n - 1, 1)
            with torch.no_grad():
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                unbiased = var * unbias
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        dt = self.dtype
        inv = torch.rsqrt(var + self.eps).reshape(shape).to(dt)
        return ((x.to(dt) - mean.reshape(shape).to(dt)) * inv
                * self.weight.reshape(shape).to(dt) + self.bias.reshape(shape).to(dt))


class Conv2d(nn.Module):
    """A Conv2d whose weights are cast to the compute dtype at use, with the
    bias added after the convolution as dsjax does."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int],
                 stride: Tuple[int, int], padding: Tuple[int, int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x: Tensor) -> Tensor:
        y = F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), None,
                     self.stride, self.padding)
        return y + self.bias.to(y.dtype)[:, None, None]


class ConvFrontend(nn.Module):
    """Two Conv2d + BN + Hardtanh blocks with a length mask after each
    submodule, so results do not depend on the padding. Input (B, 1, F, T)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(1, 32, (41, 11), (2, 2), (20, 5), dtype)
        self.bn1 = TorchBatchNorm(32, axes=(0, 2, 3), dtype=dtype)
        self.conv2 = Conv2d(32, 32, (21, 11), (2, 1), (10, 5), dtype)
        self.bn2 = TorchBatchNorm(32, axes=(0, 2, 3), dtype=dtype)

    def forward(self, x: Tensor, lengths: Tensor) -> Tuple[Tensor, Tensor]:
        out_lengths = get_seq_lens(lengths)

        def time_mask(z: Tensor) -> Tensor:
            t = torch.arange(z.shape[3], device=z.device)
            return (t[None, :] < out_lengths[:, None])[:, None, None, :].to(z.dtype)

        x = self.conv1(x)
        m = time_mask(x)
        x = self.bn1(x * m)
        x = hardtanh_0_20(x) * m
        x = self.conv2(x)
        m = time_mask(x)
        x = self.bn2(x * m)
        x = hardtanh_0_20(x) * m
        return x, out_lengths


def rnn_scan(xp: Tensor, mask: Tensor, w_hh: Tensor, b_hh: Tensor, h0: Tensor,
             reverse: Sequence[bool]) -> Tuple[Tensor, Tensor]:
    """The vanilla tanh RNN's masked recurrence, in ``lstm_scan``'s layout
    (xp (D, T, B, H), w_hh (D, H, H), b_hh (D, H), h0 (D, B, H)): a plain
    per-step loop on every device, in the working dtype as dsjax's
    ``lax.scan`` step computes it (dsjax/model/ds2.py:306-313); dsjax has no
    kernel for it. Returns (y (D, T, B, H), h_T (D, B, H))."""
    ys, hs = [], []
    m_all = mask.to(xp.dtype)
    for d, rev in enumerate(reverse):
        x_d, m_d = _flip(xp[d], rev), _flip(m_all, rev)
        w_t, b, h = w_hh[d].t(), b_hh[d], h0[d]
        out = []
        for t in range(x_d.shape[0]):
            h_new = torch.tanh(x_d[t] + h @ w_t + b)
            m = m_d[t][:, None]
            h = m * h_new + (1 - m) * h
            out.append(h_new * m)
        y = torch.stack(out) if out else x_d.new_zeros((0,) + h.shape)
        ys.append(_flip(y, rev))
        hs.append(h)
    return torch.stack(ys), torch.stack(hs)


class RecurrentLayer(nn.Module):
    """One recurrent layer (LSTM, GRU or vanilla RNN) with a masked scan,
    bidirectional (directions summed) or forward only.

    Weights are stacked by direction (0 forward, 1 backward) in torch's
    layout: weight_ih (D, G * H, in), weight_hh (D, G * H, H), gate order
    i, f, g, o (LSTM) or r, z, n (GRU), G the number of gates. The returned
    carry holds each direction's (h, c) (LSTM) or (h,) at each utterance's
    true end. Under tensor parallelism each rank holds a block of the G * H
    rows, and the forward gathers them whole (``parallel.tensor.whole``).
    """

    def __init__(self, input_size: int, hidden_size: int,
                 rnn_type: RNNType = RNNType.lstm, bidirectional: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_size, self.hidden_size, self.dtype = input_size, hidden_size, dtype
        self.rnn_type = RNNType(rnn_type)
        self.reverse = (False, True) if bidirectional else (False,)
        d, g = len(self.reverse), GATES[self.rnn_type] * hidden_size
        self.weight_ih = nn.Parameter(torch.empty(d, g, input_size))
        self.weight_hh = nn.Parameter(torch.empty(d, g, hidden_size))
        self.bias_ih = nn.Parameter(torch.empty(d, g))
        self.bias_hh = nn.Parameter(torch.empty(d, g))

    def forward(self, x: Tensor, lengths: Tensor, carry: Optional[Carry] = None
                ) -> Tuple[Tensor, Carry]:
        # x: (T, B, in) time-major; lengths: (B,)
        n_t, n_b = x.shape[0], x.shape[1]
        n_dir, dt = len(self.reverse), self.dtype
        w_ih, w_hh, b_ih, b_hh = (whole(self, name, dt) for name in
                                  ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
        # the input projection of every step as one matrix product per direction
        xp = torch.matmul(x.to(dt).reshape(n_t * n_b, self.input_size), w_ih.transpose(1, 2))
        xp = (xp + b_ih[:, None, :]).reshape(n_dir, n_t, n_b, -1)
        mask = (torch.arange(n_t, device=x.device)[:, None] < lengths[None, :]).float()
        n_state = 2 if self.rnn_type == RNNType.lstm else 1
        if carry is None:
            state = tuple(torch.zeros((n_dir, n_b, self.hidden_size), dtype=dt, device=x.device)
                          for _ in range(n_state))
        else:
            state = tuple(s.to(dt).contiguous() for s in carry)
        w_hh, b_hh = w_hh.contiguous(), b_hh.contiguous()
        scan = {RNNType.lstm: lstm_scan, RNNType.gru: gru_scan, RNNType.rnn: rnn_scan}
        y, *state = scan[self.rnn_type](xp, mask, w_hh, b_hh, *state, self.reverse)
        return (y[0] if n_dir == 1 else y[0] + y[1]), tuple(state)


class Lookahead(nn.Module):
    """Depthwise convolution over future frames (dsjax/model/ds2.py:350-374;
    Wang et al. 2016): y[t, f] = sum_j w[f, j] * x[t + j, f], right-padded by
    context - 1, no bias. Input and output (T, B, F). dsjax computes it
    outside any Pallas kernel, so here it is ``F.conv1d(groups=F)``."""

    def __init__(self, n_features: int, context: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.context, self.dtype = context, dtype
        self.weight = nn.Parameter(torch.empty(n_features, context))

    def forward(self, x: Tensor) -> Tensor:
        xt = F.pad(x.to(self.dtype).permute(1, 2, 0), (0, self.context - 1))   # (B, F, T+c-1)
        y = F.conv1d(xt, self.weight.to(self.dtype)[:, None, :], groups=self.weight.shape[0])
        return y.permute(2, 0, 1)


class Linear(nn.Module):
    """Bias-free Linear computed in the compute dtype; under tensor
    parallelism each rank holds a block of the input columns, gathered
    whole in the forward."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))

    def forward(self, x: Tensor) -> Tensor:
        return F.linear(x.to(self.dtype), whole(self, "weight", self.dtype))


class DeepSpeech2(nn.Module):
    """Full DS2 network: conv frontend -> recurrent stack -> FC head.

    ``forward(x, lengths, carry=None)`` takes (B, F, T) spectrograms (or the
    reference's (B, 1, F, T)) and frame lengths and returns
    (out (B, T', C), out_lengths (B,), carry): raw logits in training mode,
    float32 softmax probabilities in eval mode. ``carry`` is one tuple per
    layer, (h, c) for LSTM and (h,) for GRU and RNN, as returned by the
    previous call.

    A ``UniDirectionalConfig`` builds the streaming model: one direction per
    layer, then ``lookahead`` (context ``lookahead_context``) and a hardtanh
    before the head (dsjax/model/ds2.py:428-431). ``rnn_bns[i - 1]`` is the
    sequence-wise BatchNorm before layer i >= 1. ``generator`` seeds the
    initial weights; loading a state dict replaces them.
    """

    def __init__(self, num_classes: int, spect_cfg: SpectConfig,
                 model_cfg: BiDirectionalConfig, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes, self.spect_cfg, self.model_cfg = num_classes, spect_cfg, model_cfg
        self.dtype = dtype
        self.bidirectional = not isinstance(model_cfg, UniDirectionalConfig)
        h, n_layers = model_cfg.hidden_size, model_cfg.hidden_layers
        self.conv = ConvFrontend(dtype)
        self.rnns = nn.ModuleList(
            RecurrentLayer(rnn_input_size(spect_cfg) if i == 0 else h, h,
                           model_cfg.rnn_type, self.bidirectional, dtype)
            for i in range(n_layers))
        self.rnn_bns = nn.ModuleList(
            TorchBatchNorm(h, axes=(0, 1), dtype=dtype) for _ in range(n_layers - 1))
        self.lookahead = (None if self.bidirectional
                          else Lookahead(h, model_cfg.lookahead_context, dtype))
        self.fc_bn = TorchBatchNorm(h, axes=(0, 1), dtype=dtype)
        self.fc = Linear(h, num_classes, dtype)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """dsjax's initializers: LeCun normal for convs and the head, zero
        conv bias, U(-1/sqrt(H), 1/sqrt(H)) for the recurrent layers, He
        uniform for the Lookahead, unit BatchNorm."""
        for conv in (self.conv.conv1, self.conv.conv2):
            fan_in = conv.weight[0].numel()
            conv.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            conv.bias.zero_()
        bound = self.model_cfg.hidden_size ** -0.5
        for rnn in self.rnns:
            for p in (rnn.weight_ih, rnn.weight_hh, rnn.bias_ih, rnn.bias_hh):
                p.uniform_(-bound, bound, generator=generator)
        if self.lookahead is not None:
            # flax's kaiming_uniform on the (H, context) kernel: fan_in H
            limit = (6.0 / self.model_cfg.hidden_size) ** 0.5
            self.lookahead.weight.uniform_(-limit, limit, generator=generator)
        self.fc.weight.normal_(0.0, self.model_cfg.hidden_size ** -0.5, generator=generator)

    @staticmethod
    def output_lengths(lengths: Tensor) -> Tensor:
        """The frame counts ``forward`` returns for ``lengths`` input frames,
        on the device ``lengths`` is on: the conv stack's rule."""
        return get_seq_lens(lengths)

    def forward(self, x: Tensor, lengths: Tensor,
                carry: Optional[Sequence[Carry]] = None
                ) -> Tuple[Tensor, Tensor, List[Carry]]:
        if x.dim() == 4:  # (B, 1, F, T) reference layout
            x = x[:, 0]
        lengths = torch.as_tensor(lengths, device=x.device)
        b_dim = x.shape[0]
        x, out_lengths = self.conv(x[:, None].to(self.dtype), lengths)
        # (B, C, F', T') -> (T', B, C * F'): feature index c * F' + f
        x = x.permute(3, 0, 1, 2).reshape(x.shape[3], b_dim, -1)
        new_carry: List[Carry] = []
        for i, rnn in enumerate(self.rnns):
            if i > 0:
                x = self.rnn_bns[i - 1](x)
            x, c = rnn(x, out_lengths, carry[i] if carry is not None else None)
            new_carry.append(c)
        if self.lookahead is not None:
            x = hardtanh_0_20(self.lookahead(x))
        x = self.fc(self.fc_bn(x)).transpose(0, 1)               # (B, T', C)
        if not self.training:
            x = torch.softmax(x.float(), dim=-1)
        return x, out_lengths, new_carry
