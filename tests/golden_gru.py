"""Deterministic full-width GRU DeepSpeech2 reference states and their input.

Two models dsjax supports at the flagship's width, in the reference
state_dict layout, with weights from numpy (stable across library versions):
  "bigru"   5 x BiGRU-1024 (``model.rnn_type=gru``);
  "unigru"  5 x GRU-1024 plus the Lookahead convolution with context 20
            (``model=unidirectional model.rnn_type=gru``).
tools/make_golden_gru_fixture.py runs dsjax's model on them and writes the
posteriors to tests/fixtures/golden_gru.npz; the port is held against that
file on the CPU (tests/test_torch_gru.py) and on the card (chip_smoke.py).
numpy only, so chip_smoke.py can import it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

HIDDEN, LAYERS, CLASSES, CONTEXT = 1024, 5, 29, 20
D0 = 41 * 32  # RNN input size after the conv stack
B, F, T = 2, 161, 128
MODELS = {"bigru": (True, 10), "unigru": (False, 11)}   # name: (bidirectional, seed)
GOLDEN_TOL = (5e-6, 1e-4)                                # (atol, rtol) of the posteriors


def gru_state(name: str, hidden: int = HIDDEN, layers: int = LAYERS
              ) -> Dict[str, np.ndarray]:
    bidirectional, seed = MODELS[name]
    rng = np.random.default_rng(seed)
    state: Dict[str, np.ndarray] = {}

    def add(key, *shape, scale=0.05):
        state[key] = (rng.standard_normal(shape) * scale).astype(np.float32)

    def add_bn(prefix, n):
        state[f"{prefix}.weight"] = (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32)
        add(f"{prefix}.bias", n, scale=0.05)
        add(f"{prefix}.running_mean", n, scale=0.1)
        state[f"{prefix}.running_var"] = (1.0 + 0.2 * rng.random(n)).astype(np.float32)

    add("conv.seq_module.0.weight", 32, 1, 41, 11)
    add("conv.seq_module.0.bias", 32)
    add_bn("conv.seq_module.1", 32)
    add("conv.seq_module.3.weight", 32, 32, 21, 11, scale=0.02)
    add("conv.seq_module.3.bias", 32)
    add_bn("conv.seq_module.4", 32)
    for i in range(layers):
        d = D0 if i == 0 else hidden
        if i >= 1:
            add_bn(f"rnns.{i}.batch_norm.module", d)
        for sfx in ("", "_reverse") if bidirectional else ("",):
            add(f"rnns.{i}.rnn.weight_ih_l0{sfx}", 3 * hidden, d, scale=0.02)
            add(f"rnns.{i}.rnn.weight_hh_l0{sfx}", 3 * hidden, hidden, scale=0.02)
            add(f"rnns.{i}.rnn.bias_ih_l0{sfx}", 3 * hidden, scale=0.02)
            add(f"rnns.{i}.rnn.bias_hh_l0{sfx}", 3 * hidden, scale=0.02)
    if not bidirectional:
        add("lookahead.0.conv.weight", hidden, 1, CONTEXT, scale=0.2)
    add_bn("fc.0.module.0", hidden)
    add("fc.0.module.1.weight", CLASSES, hidden, scale=0.05)
    return state


def gru_input(seed: int = 1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, F, T)).astype(np.float32)
    lengths = np.array([T, T - 41], np.int32)
    for i, n in enumerate(lengths):
        x[i, :, n:] = 0.0
    return x, lengths
