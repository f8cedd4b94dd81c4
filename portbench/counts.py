"""Operations and bytes: the model's FLOPs and each scan or beam kernel's
least time on one H100.

The model count rewrites ``bench.py:model_train_flops_per_utt`` (which
imports jax and holds a TPU's peaks) for any DeepSpeech2 architecture of
``configs/*.json``: the two convolutions, each recurrent layer's input
projection and recurrent product (G gates, one or two directions), the
Lookahead's taps and the head, in multiply-adds counted as 2 FLOPs; training
is 3x the forward.

A kernel's bound is PERF.md's rule: the larger of its recurrent product's
FLOPs over the peak of its type and every input and output byte of the call
once over the HBM rate, with the FLOPs of the valid (t, b) steps only. The
byte lists follow each kernel's C entry point (``dsjax_torch/csrc``).
"""

from __future__ import annotations

from typing import Dict, Tuple

# H100 SXM at 700 W, NVIDIA's data sheet: dense peaks by type, HBM rate
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
ESIZE = {"float32": 4, "bfloat16": 2}
GATES = {"lstm": 4, "gru": 3, "rnn": 1}
# the scan kernels a recurrent layer call launches, by (rnn_type, training):
# the forward with residuals and the reverse scan in training, the
# persistent forward in evaluation; the vanilla RNN has no kernel
SCAN_KERNELS = {("lstm", True): ("K2", "K3"), ("lstm", False): ("K1",),
                ("gru", True): ("K4r", "K5"), ("gru", False): ("K4",),
                ("rnn", True): (), ("rnn", False): ()}

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
    h, g = arch["hidden_size"], GATES[arch["rnn_type"]]
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


def scan_bound(kernel: str, n_dir: int, n_t: int, n_b: int, n_h: int, dtype: str,
               valid: int) -> Tuple[float, str]:
    """Least time of one call of a scan kernel over ``n_dir`` directions of
    (n_t, n_b) steps of which ``valid`` per direction are valid.

    K1/K2 and K4/K4r are the LSTM and GRU forwards without and with
    residuals, K3 and K5 their reverse scans."""
    e = ESIZE[dtype]
    seq = n_dir * n_t * n_b * n_h          # one (D, T, B, H) tensor's elements
    state = n_dir * n_b * n_h              # one (D, B, H) carry
    mask = n_t * n_b * 4                   # (T, B) float32
    if kernel in ("K1", "K2", "K3"):
        g = 4
        w = n_dir * g * n_h * n_h * e
        if kernel == "K3":   # g_seq, mask, w, c0, c_seq, dy, dh_T, dc_T -> dg, dh0, dc0
            n_bytes = mask + w + e * (g * seq + state + seq + seq + 2 * state
                                      + g * seq + 2 * state)
        else:                # xp, mask, w, b, h0, c0 -> y, h_T, c_T [, gates, c_seq]
            n_bytes = mask + w + e * (g * seq + n_dir * g * n_h + 2 * state + seq + 2 * state)
            if kernel == "K2":
                n_bytes += e * (g * seq + seq)
    elif kernel in ("K4", "K4r", "K5"):
        g = 3
        w = n_dir * g * n_h * n_h * e
        if kernel == "K5":   # g_seq (4H), mask, w, h_prev, dy, dh_T -> dxp, dh0
            n_bytes = mask + w + e * (4 * seq + seq + seq + state + g * seq + state)
        else:                # xp, mask, w, b, h0 -> y, h_T [, gates (4H)]
            n_bytes = mask + w + e * (g * seq + n_dir * g * n_h + state + seq + state)
            if kernel == "K4r":
                n_bytes += e * 4 * seq
    else:
        raise KeyError(f"no scan kernel {kernel!r}")
    flops = 2.0 * g * n_h * n_h * valid * n_dir
    return least_time(flops, n_bytes, dtype)


def beam_bound(n_b: int, n_t: int, width: int, classes: int, valid_frames: int
               ) -> Tuple[float, str]:
    """Least time of one K7 call: an operation per (frame, beam, class)
    candidate of the valid frames; the f32 log-probabilities and sizes in,
    the four (T, B, W) int32 histories, the totals, the 7-part carry and
    the ranking out."""
    bw = n_b * width
    n_bytes = (n_b * n_t * classes * 4 + n_b * 4 + 4 * n_t * bw * 4 + bw * 4
               + (2 * 4 + 5 * 4) * bw + bw * 4 + bw * 4)
    return least_time(float(valid_frames) * width * classes, n_bytes, "float32")


def scan_calls(arch: Dict, training: bool, n_t: int, n_b: int, dtype: str, valid: int
               ) -> Dict[str, list]:
    """Each scan kernel's calls for one forward (and, in training, its
    backward) of the model over a (n_t, n_b) batch with ``valid`` valid
    steps a direction: one call a layer, as ``bound``'s arguments."""
    dirs = 2 if arch["bidirectional"] else 1
    call = (dirs, n_t, n_b, arch["hidden_size"], dtype, valid)
    return {k: [call] * arch["hidden_layers"]
            for k in SCAN_KERNELS[(arch["rnn_type"], training)]}


def bound(kernel: str, *call) -> Tuple[float, str]:
    """``beam_bound`` for K7, ``scan_bound`` for the scan kernels."""
    return beam_bound(*call) if kernel == "K7" else scan_bound(kernel, *call)
