"""Operations and bytes: the model's FLOPs, the H100's peaks, and the least
time of a call; each kernel's own operations and bytes are in its file,
``kernels/<K>.py``.

The model count rewrites ``bench.py:model_train_flops_per_utt`` (which
imports jax and holds a TPU's peaks) for any DeepSpeech2 architecture of
``configs/*.json``: the two convolutions, each recurrent layer's input
projection and recurrent product (G gates, one or two directions), the
Lookahead's taps and the head, in multiply-adds counted as 2 FLOPs; training
is 3x the forward.

A kernel's bound is PERF.md's rule: the larger of its recurrent product's
FLOPs over the peak of its type and every input and output byte of the call
once over the HBM rate, with the FLOPs of the valid (t, b) steps only
(``least_time``). The byte lists follow each kernel's C entry point
(``dsjax_torch/csrc``). A recurrent cell's gates come from its reference
file, ``reference/cells/<rnn_type>.py``.
"""

from __future__ import annotations

from typing import Dict, Tuple

from portbench import kernels
from portbench.reference import cells

# H100 SXM at 700 W, NVIDIA's data sheet: dense peaks by type, HBM rate
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
ESIZE = {"float32": 4, "bfloat16": 2}

SAMPLE_RATE, HOP = 16000, 160
FREQ_BINS = 161                       # n_fft 320 at 16 kHz and 20 ms
CONV_CHANNELS = 32
CONV1 = (41, 11)                      # (freq, time) kernel, stride (2, 2)
CONV2 = (21, 11)                      # stride (2, 1)


def conv_out_freq() -> Tuple[int, int]:
    """Frequency rows after conv1 and conv2 (81, 41 for 161 bins)."""
    f1 = (FREQ_BINS + 2 * 20 - CONV1[0]) // 2 + 1
    f2 = (f1 + 2 * 10 - CONV2[0]) // 2 + 1
    return f1, f2


def frames_after_convs(frames: int) -> int:
    """Time steps after the conv stack: kernel 11, pad 5, stride 2 then 1."""
    return (frames - 1) // 2 + 1


def frames_of(samples: int) -> int:
    """Spectrogram frames of an utterance (centred STFT): 1 + n // hop."""
    return 1 + samples // HOP


def forward_flops(arch: Dict, steps: int) -> float:
    """FLOPs of one utterance's forward at ``steps`` time steps after the
    convs (the convs' output rows counted at those steps too)."""
    f1, f2 = conv_out_freq()
    h, g = arch["hidden_size"], cells.find(arch["rnn_type"]).GATES
    dirs = 2 if arch["bidirectional"] else 1
    flops = 2.0 * f1 * steps * CONV_CHANNELS * CONV1[0] * CONV1[1]
    flops += 2.0 * f2 * steps * CONV_CHANNELS * CONV2[0] * CONV2[1] * CONV_CHANNELS
    for layer in range(arch["hidden_layers"]):
        d_in = f2 * CONV_CHANNELS if layer == 0 else h
        flops += dirs * 2.0 * steps * (d_in + h) * g * h
    if not arch["bidirectional"]:
        flops += 2.0 * steps * h * arch["lookahead_context"]
    flops += 2.0 * steps * h * arch["num_classes"]
    return flops


def train_flops(arch: Dict, frames: int) -> float:
    """FLOPs to train on one utterance of ``frames`` spectrogram frames:
    the forward and a backward of twice its work."""
    return 3.0 * forward_flops(arch, frames_after_convs(frames))


def least_time(flops: float, n_bytes: float, dtype: str) -> Tuple[float, str]:
    """(seconds, what bounds it): operations over the peak of ``dtype`` or
    bytes over the HBM rate, whichever is larger."""
    ops_s = flops / PEAK_FLOPS[dtype]
    bytes_s = n_bytes / HBM_BYTES_PER_S
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")


def scan_calls(arch: Dict, training: bool, n_t: int, n_b: int, dtype: str, valid: int
               ) -> Dict[str, list]:
    """Each scan kernel's calls for one forward (and, in training, its
    backward) of the model over a (n_t, n_b) batch with ``valid`` valid
    steps a direction: one call a layer, as ``bound``'s arguments. The
    kernels a layer call launches are those whose files name its
    (rnn_type, training) (``kernels.scan_kernels``); none for a recurrent
    type no kernel file names."""
    dirs = 2 if arch["bidirectional"] else 1
    call = (dirs, n_t, n_b, arch["hidden_size"], dtype, valid)
    return {k: [call] * arch["hidden_layers"]
            for k in kernels.scan_kernels().get((arch["rnn_type"], training), ())}


def bound(kernel: str, *call) -> Tuple[float, str]:
    """The least time of one call of ``kernel`` (``kernels/<kernel>.py``)."""
    return kernels.bound(kernel, *call)
