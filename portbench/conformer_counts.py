"""The Conformer's model FLOPs (``configs/conformer-*.json``), counted as
``counts.py`` counts DeepSpeech2's: multiply-adds as 2 FLOPs, training 3x the
forward.

One utterance's forward at T front-end frames, T1 = (T - 1) // 2 + 1 and
T2 = (T1 - 1) // 2 + 1 after the two stride-2 stages, F1 and F2 the mel rows
after them, C the subsampling's channels, d the width, H the heads, k the
depthwise kernel, V the classes:

  subsampling   conv 1: 2 T1 F1 C 9; conv 2: 2 T2 F2 C^2 9; Linear: 2 T2 C F2 d
  a block       the two FFNs: 2 x 2 x 2 T2 d (4d); q, k, v and the output
                projection: 4 x 2 T2 d^2; the scores (q + u) k^T: 2 T2^2 d;
                the positional term over the 2 T2 - 1 offsets: 2 T2 (2 T2 - 1) d;
                the product with v: 2 T2^2 d; the conv module's pointwise
                convolutions 2 T2 d (2d) and 2 T2 d^2, its depthwise taps 2 T2 d k
  the head      2 T2 d V

and once a batch, not an utterance, each block's positional projection
W_pos P: 2 (2 T2 - 1) d^2. Elementwise work (LayerNorm, softmax, GLU,
Swish, BatchNorm, the residuals) is not counted.
"""

from __future__ import annotations

from typing import Dict, Tuple

from portbench import counts


def subsampled(n: int) -> int:
    """One stride-2 stage of kernel 3 and pad 1: (n - 1) // 2 + 1."""
    return (n - 1) // 2 + 1


def shapes(arch: Dict, frames: int) -> Tuple[int, int, int, int]:
    """(T1, T2, F1, F2)."""
    t1, f1 = subsampled(frames), subsampled(arch["feat_in"])
    return t1, subsampled(t1), f1, subsampled(f1)


def forward_parts(arch: Dict, frames: int) -> Dict[str, float]:
    """One utterance's forward FLOPs by part: ``subsampling``, ``blocks`` (all
    of them, the positional projection left out), ``head``; and
    ``positions``, the blocks' positional projections, once a batch."""
    d, layers, k = arch["d_model"], arch["n_layers"], arch["conv_kernel_size"]
    c = d                     # subsampling_conv_channels -1: d_model channels
    t1, t2, f1, f2 = shapes(arch, frames)
    ff = d * arch["ff_expansion_factor"]
    sub = 2.0 * t1 * f1 * c * 9 + 2.0 * t2 * f2 * c * c * 9 + 2.0 * t2 * c * f2 * d
    block = (2 * 2 * 2.0 * t2 * d * ff            # two FFNs of two Linear layers
             + 4 * 2.0 * t2 * d * d               # q, k, v, output
             + 2.0 * t2 * t2 * d                  # content scores
             + 2.0 * t2 * (2 * t2 - 1) * d        # positional scores over every offset
             + 2.0 * t2 * t2 * d                  # the product with v
             + 2.0 * t2 * d * 2 * d + 2.0 * t2 * d * d + 2.0 * t2 * d * k)
    return {"subsampling": sub, "blocks": layers * block,
            "head": 2.0 * t2 * d * arch["num_classes"],
            "positions": layers * 2.0 * (2 * t2 - 1) * d * d}


def train_flops(arch: Dict, frames: int, batch: int) -> float:
    """FLOPs of one training step on ``batch`` utterances of ``frames``
    front-end frames: the forward and a backward of twice its work."""
    p = forward_parts(arch, frames)
    return 3.0 * (batch * (p["subsampling"] + p["blocks"] + p["head"]) + p["positions"])


def frames_of(samples: int) -> int:
    return counts.frames_of(samples)
