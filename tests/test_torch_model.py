"""dsjax_torch DeepSpeech2 against dsjax on the same weights and inputs (CPU).

Weights are made by numpy from a seed in the reference state_dict layout and
reach dsjax through ``convert_state_dict`` and the port through
``from_reference_state_dict``. Tolerances: probs atol 1e-5 / rtol 1e-4 (f32;
XLA and torch sum the conv and matmul terms in different orders), exact
output lengths.
"""

from typing import Dict

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dsjax import config as jax_config
from dsjax.model.ds2 import DeepSpeech2 as JaxDeepSpeech2
from dsjax.model.ds2 import TorchBatchNorm as JaxBatchNorm
from dsjax.model.torch_import import convert_state_dict
from dsjax_torch.config import BiDirectionalConfig, RNNType, SpectConfig, UniDirectionalConfig
from dsjax_torch.model import convert
from dsjax_torch.model.ds2 import DeepSpeech2, TorchBatchNorm, rnn_input_size

CLASSES = 29
ATOL, RTOL = 1e-5, 1e-4


def reference_state(seed: int = 0, hidden: int = 64, layers: int = 2,
                    fc_scale: float = 0.05) -> Dict[str, np.ndarray]:
    """Random reference-layout state of a bidirectional LSTM DeepSpeech2
    (the layout of tests/golden_flagship.py:flagship_state at any width)."""
    rng = np.random.default_rng(seed)
    state: Dict[str, np.ndarray] = {}
    d0 = rnn_input_size(SpectConfig())

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
        d = d0 if i == 0 else hidden
        if i >= 1:
            add_bn(f"rnns.{i}.batch_norm.module", d)
        for sfx in ("", "_reverse"):
            add(f"rnns.{i}.rnn.weight_ih_l0{sfx}", 4 * hidden, d, scale=0.1)
            add(f"rnns.{i}.rnn.weight_hh_l0{sfx}", 4 * hidden, hidden, scale=0.1)
            add(f"rnns.{i}.rnn.bias_ih_l0{sfx}", 4 * hidden, scale=0.1)
            add(f"rnns.{i}.rnn.bias_hh_l0{sfx}", 4 * hidden, scale=0.1)
    add_bn("fc.0.module.0", hidden)
    add("fc.0.module.1.weight", CLASSES, hidden, scale=fc_scale)
    return state


def features(seed: int, batch: int, frames: int, lengths):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 161, frames)).astype(np.float32)
    lengths = np.asarray(lengths, np.int32)
    for i, n in enumerate(lengths):
        x[i, :, n:] = 0.0
    return x, lengths


def both_models(state, hidden, layers, **jax_kw):
    cfg = BiDirectionalConfig(hidden_size=hidden, hidden_layers=layers)
    params, stats = convert_state_dict(state, layers, True)
    jmodel = JaxDeepSpeech2(num_classes=CLASSES, spect_cfg=jax_config.SpectConfig(),
                            model_cfg=jax_config.BiDirectionalConfig(hidden_size=hidden,
                                                                     hidden_layers=layers),
                            **jax_kw)
    model = DeepSpeech2(CLASSES, SpectConfig(), cfg)
    model.load_state_dict(convert.from_reference_state_dict(state))
    return jmodel, {"params": params, "batch_stats": stats}, model.eval()


def jax_carry_to_port(carry):
    return [tuple(np.stack([np.asarray(layer["fwd"][k]), np.asarray(layer["bwd"][k])])
                  for k in range(2)) for layer in carry]


def assert_forward_equal(j_out, p_out):
    j_probs, j_lens, j_carry = j_out
    p_probs, p_lens, p_carry = p_out
    np.testing.assert_array_equal(p_lens.numpy(), np.asarray(j_lens))
    np.testing.assert_allclose(p_probs.numpy(), np.asarray(j_probs), atol=ATOL, rtol=RTOL)
    for (jh, jc), (ph, pc) in zip(jax_carry_to_port(j_carry), p_carry):
        np.testing.assert_allclose(ph.numpy(), jh, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(pc.numpy(), jc, atol=ATOL, rtol=RTOL)


def test_converters_agree():
    state = reference_state(seed=1, hidden=32, layers=3)
    port = convert.from_reference_state_dict(state)
    params, stats = convert_state_dict(state, 3, True)
    via_dsjax = convert.from_dsjax_variables({"params": params, "batch_stats": stats})
    assert sorted(port) == sorted(via_dsjax)
    for k in port:
        torch.testing.assert_close(port[k], via_dsjax[k], rtol=0, atol=0)
    back = convert.to_reference_state_dict(port)
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k].numpy(), v)
    cfg, classes = convert.infer_architecture(state)
    assert (cfg.hidden_size, cfg.hidden_layers, cfg.rnn_type, classes) == (32, 3, RNNType.lstm, 29)
    # the port's module tree takes the converted dict without leftovers
    model = DeepSpeech2(CLASSES, SpectConfig(), cfg)
    assert sorted(model.state_dict()) == sorted(port)


def test_forward_matches_dsjax():
    state = reference_state(seed=2)
    jmodel, variables, model = both_models(state, 64, 2)
    x, lengths = features(3, 3, 60, [60, 37, 11])
    j_out = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(lengths), train=False)
    with torch.inference_mode():
        p_out = model(torch.from_numpy(x), torch.from_numpy(lengths))
    assert p_out[0].dtype == torch.float32 and p_out[0].shape == (3, 30, CLASSES)
    assert_forward_equal(j_out, p_out)


def test_chunked_forward_with_carry_matches_dsjax():
    """Two chunks with the RNN carry passed along; the reverse direction of
    the second chunk idles through leading padding with its carry held."""
    state = reference_state(seed=4)
    jmodel, variables, model = both_models(state, 64, 2)
    x1, l1 = features(5, 2, 40, [40, 40])
    x2, l2 = features(6, 2, 40, [40, 17])
    j1 = jmodel.apply(variables, jnp.asarray(x1), jnp.asarray(l1), train=False)
    j2 = jmodel.apply(variables, jnp.asarray(x2), jnp.asarray(l2), j1[2], train=False)
    with torch.inference_mode():
        p1 = model(torch.from_numpy(x1), torch.from_numpy(l1))
        p2 = model(torch.from_numpy(x2), torch.from_numpy(l2), p1[2])
    assert_forward_equal(j1, p1)
    assert_forward_equal(j2, p2)


def test_matches_dsjax_pallas_interpret(monkeypatch):
    """dsjax with its Pallas LSTM kernel (interpret mode) at H=128, B=8."""
    from dsjax.ops import lstm_pallas

    orig = lstm_pallas.lstm_scan

    def interp_scan(xp, mask, w, b, h0, c0, interpret=False):
        return orig(xp, mask, w, b, h0, c0, True)

    monkeypatch.setattr(lstm_pallas, "lstm_scan", interp_scan)
    state = reference_state(seed=7, hidden=128, layers=2)
    jmodel, variables, model = both_models(state, 128, 2, use_pallas=True)
    x, lengths = features(8, 8, 40, [40, 30, 20, 40, 10, 40, 25, 1])
    j_out = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(lengths), train=False)
    with torch.inference_mode():
        p_out = model(torch.from_numpy(x), torch.from_numpy(lengths))
    assert_forward_equal(j_out, p_out)


def test_train_mode_logits_and_batch_stats_match_dsjax():
    """Training mode: raw logits, batch statistics, and the running-stat
    update (momentum 0.1, unbiased variance) equal dsjax's."""
    state = reference_state(seed=9, hidden=32, layers=2)
    jmodel, variables, model = both_models(state, 32, 2)
    x, lengths = features(10, 3, 48, [48, 30, 20])
    (j_logits, j_lens, _), mut = jmodel.apply(
        variables, jnp.asarray(x), jnp.asarray(lengths), train=True,
        mutable=["batch_stats"])
    model.train()
    p_logits, p_lens, _ = model(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_array_equal(p_lens.numpy(), np.asarray(j_lens))
    # raw logits (order 1, not probabilities) after batch statistics that
    # both packages reduce in their own order
    np.testing.assert_allclose(p_logits.detach().numpy(), np.asarray(j_logits),
                               atol=1e-4, rtol=1e-4)
    updated = convert.from_dsjax_variables(
        {"params": variables["params"], "batch_stats": mut["batch_stats"]})
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(v, updated[k], atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_matches_dsjax(train):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((7, 5, 16)).astype(np.float32) * 2 + 0.5
    scale = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(16)).astype(np.float32)
    mean = (0.1 * rng.standard_normal(16)).astype(np.float32)
    var = (1 + 0.2 * rng.random(16)).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    j_out, mut = JaxBatchNorm(16, axes=(0, 1)).apply(
        variables, jnp.asarray(x), train, mutable=["batch_stats"])
    bn = TorchBatchNorm(16, axes=(0, 1))
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var)})
    bn.train(train)
    with torch.no_grad():
        out = bn(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]), atol=1e-6)


def test_checkpoint_roundtrip_and_load_model(tmp_path):
    from dsjax_torch.inference import load_model
    from dsjax_torch.labels import DEFAULT_LABELS

    state = reference_state(seed=12, hidden=32, layers=2)
    port = convert.from_reference_state_dict(state)
    cfg, _ = convert.infer_architecture(state)
    path = str(tmp_path / "m.pt")
    convert.save_checkpoint(path, port, cfg, SpectConfig(), DEFAULT_LABELS)
    bundle = load_model(path, device="cpu")
    assert bundle.labels == list(DEFAULT_LABELS) and bundle.spect_cfg == SpectConfig()
    for k, v in bundle.model.state_dict().items():
        torch.testing.assert_close(v, port[k], rtol=0, atol=0)
    x, lengths = features(13, 2, 32, [32, 20])
    probs, out_lens, carry = bundle.forward(x, lengths)
    assert probs.shape == (2, 16, CLASSES) and len(carry) == 2
    torch.testing.assert_close(probs.sum(-1), torch.ones(2, 16))


VARIANTS = {"bigru": ("bidirectional", "gru"), "unigru_lookahead": ("unidirectional", "gru"),
            "unilstm_lookahead": ("unidirectional", "lstm"), "birnn": ("bidirectional", "rnn"),
            "unirnn_lookahead": ("unidirectional", "rnn")}


def variant_models(name, hidden=128, layers=2, seed=0, **jax_kw):
    """dsjax's DeepSpeech2 of a variant with initialised weights (BatchNorm
    statistics drawn by numpy) and the port's model on the same weights
    through from_dsjax_variables."""
    import jax

    direction, rnn_type = VARIANTS[name]
    kw = dict(hidden_size=hidden, hidden_layers=layers)
    if direction == "unidirectional":
        kw["lookahead_context"] = 5
        jcfg = jax_config.UniDirectionalConfig(rnn_type=jax_config.RNNType(rnn_type), **kw)
        cfg = UniDirectionalConfig(rnn_type=RNNType(rnn_type), **kw)
    else:
        jcfg = jax_config.BiDirectionalConfig(rnn_type=jax_config.RNNType(rnn_type), **kw)
        cfg = BiDirectionalConfig(rnn_type=RNNType(rnn_type), **kw)
    jmodel = JaxDeepSpeech2(num_classes=CLASSES, spect_cfg=jax_config.SpectConfig(),
                            model_cfg=jcfg, **jax_kw)
    x0 = jnp.zeros((2, 161, 16), jnp.float32)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(seed), x0, jnp.full((2,), 16, jnp.int32), train=False))
    rng = np.random.default_rng(seed)

    def draw(tree):
        if "mean" in tree:
            n = tree["mean"].shape
            return {"mean": (0.1 * rng.standard_normal(n)).astype(np.float32),
                    "var": (1.0 + 0.2 * rng.random(n)).astype(np.float32)}
        return {k: draw(v) for k, v in tree.items()}

    variables = {"params": variables["params"], "batch_stats": draw(variables["batch_stats"])}
    model = DeepSpeech2(CLASSES, SpectConfig(), cfg)
    model.load_state_dict(convert.from_dsjax_variables(variables))
    return jmodel, variables, model.eval()


def jax_variant_carry(carry):
    """dsjax's per-layer {"fwd": (h[, c]), "bwd": ...} -> the port's tuples."""
    return [tuple(np.stack([np.asarray(layer[d][k]) for d in ("fwd", "bwd") if d in layer])
                  for k in range(len(layer["fwd"]))) for layer in carry]


def assert_variant_equal(j_out, p_out):
    j_probs, j_lens, j_carry = j_out
    p_probs, p_lens, p_carry = p_out
    np.testing.assert_array_equal(p_lens.numpy(), np.asarray(j_lens))
    np.testing.assert_allclose(p_probs.numpy(), np.asarray(j_probs), atol=ATOL, rtol=RTOL)
    for j_layer, p_layer in zip(jax_variant_carry(j_carry), p_carry):
        assert len(j_layer) == len(p_layer)
        for j, p in zip(j_layer, p_layer):
            np.testing.assert_allclose(p.numpy(), j, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_eval_and_streaming_carry_match_dsjax(name):
    """GRU, vanilla RNN and the unidirectional models with Lookahead (H=128,
    2 layers, T=40 frames, f32): eval posteriors, and a stream of two chunks
    with the carry passed along, against dsjax (its lax.scan route on the
    CPU)."""
    jmodel, variables, model = variant_models(name)
    x1, l1 = features(20, 3, 40, [40, 40, 40])
    x2, l2 = features(21, 3, 40, [40, 17, 9])
    j1 = jmodel.apply(variables, jnp.asarray(x1), jnp.asarray(l1), train=False)
    j2 = jmodel.apply(variables, jnp.asarray(x2), jnp.asarray(l2), j1[2], train=False)
    with torch.inference_mode():
        p1 = model(torch.from_numpy(x1), torch.from_numpy(l1))
        p2 = model(torch.from_numpy(x2), torch.from_numpy(l2), p1[2])
    n_state = 2 if VARIANTS[name][1] == "lstm" else 1
    n_dir = 2 if VARIANTS[name][0] == "bidirectional" else 1
    assert all(len(c) == n_state and c[0].shape == (n_dir, 3, 128) for c in p1[2])
    assert_variant_equal(j1, p1)
    assert_variant_equal(j2, p2)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_train_mode_logits_match_dsjax(name):
    """Training mode: raw logits and the BatchNorm running-stat update."""
    jmodel, variables, model = variant_models(name, seed=1)
    x, lengths = features(22, 3, 40, [40, 30, 12])
    (j_logits, j_lens, _), mut = jmodel.apply(
        variables, jnp.asarray(x), jnp.asarray(lengths), train=True, mutable=["batch_stats"])
    model.train()
    p_logits, p_lens, _ = model(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_array_equal(p_lens.numpy(), np.asarray(j_lens))
    np.testing.assert_allclose(p_logits.detach().numpy(), np.asarray(j_logits),
                               atol=1e-4, rtol=1e-4)
    updated = convert.from_dsjax_variables(
        {"params": variables["params"], "batch_stats": mut["batch_stats"]})
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(v, updated[k], atol=1e-5, rtol=1e-4)


def test_gru_model_matches_dsjax_pallas_interpret(monkeypatch):
    """dsjax's GRU model on its Pallas route (interpret mode) at H=128, B=8."""
    from dsjax.ops import gru_pallas

    orig = gru_pallas.gru_scan

    def interp_scan(xp, mask, w, b, h0, interpret=False):
        return orig(xp, mask, w, b, h0, True)

    monkeypatch.setattr(gru_pallas, "gru_scan", interp_scan)
    jmodel, variables, model = variant_models("bigru", seed=2, use_pallas=True)
    x, lengths = features(23, 8, 40, [40, 30, 20, 40, 10, 40, 25, 1])
    j_out = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(lengths), train=False)
    with torch.inference_mode():
        p_out = model(torch.from_numpy(x), torch.from_numpy(lengths))
    assert_variant_equal(j_out, p_out)


@pytest.mark.parametrize("rnn,bidirectional", [("GRU", True), ("GRU", False), ("LSTM", False)],
                         ids=["bigru", "unigru", "unilstm"])
def test_reference_layout_round_trips_through_the_torch_twin(rnn, bidirectional, tmp_path):
    """The reference's module tree (tests/torch_twin.py, nn.GRU and
    bidirectional=False with Lookahead): its exported state_dict converts to
    the port's and back unchanged, the port's posteriors equal the twin's
    softmax, and a checkpoint of it loads as the same model."""
    from dsjax_torch.inference import load_model
    from dsjax_torch.labels import DEFAULT_LABELS
    from tests.torch_twin import TorchTwin

    torch.manual_seed(0)
    twin = TorchTwin(num_classes=CLASSES, hidden=32, layers=2, bidirectional=bidirectional,
                     rnn_type=getattr(torch.nn, rnn), lookahead_context=4).eval()
    state = {k: v.detach().numpy().copy() for k, v in twin.export_reference_state_dict().items()}
    port = convert.from_reference_state_dict(state)
    back = convert.to_reference_state_dict(port)
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    cfg, classes = convert.infer_architecture(state)
    assert isinstance(cfg, UniDirectionalConfig) != bidirectional
    assert cfg.rnn_type == RNNType(rnn.lower()) and classes == CLASSES
    model = DeepSpeech2(CLASSES, SpectConfig(), cfg)
    model.load_state_dict(port)
    x, lengths = features(24, 3, 48, [48, 35, 20])
    with torch.no_grad():
        t_logits, t_lens = twin(torch.from_numpy(x)[:, None], torch.from_numpy(lengths))
        probs, out_lens, _ = model.eval()(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_array_equal(out_lens.numpy(), t_lens.numpy())
    want = torch.softmax(t_logits, -1)
    for i, n in enumerate(out_lens.tolist()):
        torch.testing.assert_close(probs[i, :n], want[i, :n], atol=ATOL, rtol=RTOL)
    path = str(tmp_path / "m.pt")
    convert.save_checkpoint(path, port, cfg, SpectConfig(), DEFAULT_LABELS)
    saved = torch.load(path, weights_only=True)["hyper_parameters"]["model_cfg"]
    assert saved["bidirectional"] == bidirectional and saved["rnn_type"] == rnn.lower()
    assert saved.get("lookahead_context") == (None if bidirectional else 4)
    bundle = load_model(path, device="cpu")
    assert bundle.model.model_cfg == cfg
    for k, v in bundle.model.state_dict().items():
        torch.testing.assert_close(v, port[k], rtol=0, atol=0)


def test_generator_seeds_initial_weights():
    cfg = BiDirectionalConfig(hidden_size=16, hidden_layers=1)
    a = DeepSpeech2(CLASSES, SpectConfig(), cfg, generator=torch.Generator().manual_seed(3))
    b = DeepSpeech2(CLASSES, SpectConfig(), cfg, generator=torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
