#!/usr/bin/env python
"""Write tests/fixtures/golden_gru.npz: dsjax's posteriors for the two
full-width GRU models of tests/golden_gru.py (5 x BiGRU-1024 and 5 x GRU-1024
+ Lookahead 20) on its seeded input, each validated against the torch twin
of the reference architecture (tests/torch_twin.py, nn.GRU) first.

    JAX_PLATFORMS=cpu python tools/make_golden_gru_fixture.py

Runs dsjax on the CPU (about a minute, under 3 GB). The file holds only the
posteriors and output lengths, a few KB.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from tests.golden_gru import CLASSES, CONTEXT, HIDDEN, LAYERS, MODELS, gru_input, gru_state


def twin_probs(state, bidirectional, x, lengths):
    """The reference architecture's posteriors on the same weights."""
    import torch

    from tests.torch_twin import TorchTwin

    twin = TorchTwin(num_classes=CLASSES, hidden=HIDDEN, layers=LAYERS,
                     bidirectional=bidirectional, rnn_type=torch.nn.GRU,
                     lookahead_context=CONTEXT).eval()
    exported = twin.export_reference_state_dict()
    assert set(exported) == set(state), sorted(set(exported) ^ set(state))[:10]
    # export_reference_state_dict renames without copying: its tensors are
    # the twin's own parameters and buffers
    with torch.no_grad():
        for k, v in exported.items():
            v.copy_(torch.from_numpy(state[k]))
        out, out_lens = twin(torch.from_numpy(x)[:, None], torch.from_numpy(lengths))
    return torch.softmax(out, dim=-1).numpy(), out_lens.numpy()


def main():
    import jax
    import jax.numpy as jnp

    from dsjax.config import SpectConfig
    from dsjax.model.ds2 import DeepSpeech2
    from dsjax.model.torch_import import convert_state_dict, infer_architecture

    jax.config.update("jax_platforms", "cpu")
    x, lengths = gru_input()
    arrays = {}
    for name, (bidirectional, _) in MODELS.items():
        state = gru_state(name)
        model_cfg, num_classes = infer_architecture(state)
        assert num_classes == CLASSES and model_cfg.hidden_size == HIDDEN
        params, stats = convert_state_dict(state, LAYERS, bidirectional)
        model = DeepSpeech2(num_classes=CLASSES, spect_cfg=SpectConfig(), model_cfg=model_cfg)
        probs, out_lens, _ = model.apply({"params": params, "batch_stats": stats},
                                         jnp.asarray(x), jnp.asarray(lengths), train=False)
        probs, out_lens = np.asarray(probs), np.asarray(out_lens)
        t_probs, t_lens = twin_probs(state, bidirectional, x, lengths)
        np.testing.assert_array_equal(out_lens, t_lens)
        err = max(float(np.abs(probs[i, :n] - t_probs[i, :n]).max())
                  for i, n in enumerate(out_lens))
        assert err < 2e-4, f"{name}: dsjax vs the torch twin {err}"
        print(f"{name} ({model_cfg}): dsjax vs the torch twin max abs diff {err:.2e}")
        arrays[f"{name}_probs"] = probs.astype(np.float32)
        arrays[f"{name}_out_lens"] = out_lens.astype(np.int32)
    out = os.path.join(os.path.dirname(__file__), "..", "tests", "fixtures", "golden_gru.npz")
    np.savez_compressed(out, **arrays)
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")


if __name__ == "__main__":
    main()
