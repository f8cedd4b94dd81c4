"""Weights across layouts: the reference state_dict, dsjax variables, the port.

The reference layout is deepspeech.pytorch's module tree (the layout of its
``.ckpt`` files, of ``tests/golden_flagship.py:flagship_state`` and of
``tests/torch_twin.py:export_reference_state_dict``). dsjax keeps the same
weights as flax trees (``dsjax/model/torch_import.py:convert_state_dict``:
HWIO convs, (in, G*H) recurrent matrices). The port keeps torch's layouts and
stacks the D directions of a layer (2, or 1 for the unidirectional model):

  conv.conv{1,2}.weight (O, I, kF, kT), .bias    conv.bn{1,2}.*
  rnns.{i}.weight_ih (D, G*H, in)  .weight_hh (D, G*H, H)  .bias_ih/.bias_hh (D, G*H)
  rnn_bns.{i-1}.*  (the BatchNorm before layer i)
  lookahead.weight (H, context)    (unidirectional only; the reference's
                                    lookahead.0.conv.weight (H, 1, context))
  fc_bn.*  fc.weight (C, H)

G is 4 for LSTM, 3 for GRU and 1 for the vanilla RNN. BatchNorm entries are
weight, bias, running_mean and running_var.

The Conformer (``model/conformer.py``) keeps NeMo's names and shapes in the
port itself (``encoder.pre_encode.*``, ``encoder.layers.{i}.*``,
``decoder.decoder_layers.0.*``), so its file layout is its state_dict as it
stands. Its widths cannot all be read from the shapes (the head count), so
``save_checkpoint`` records the model and front-end configs and
``model_from_hparams`` reads them back.
"""

from __future__ import annotations

import dataclasses
import functools
import pickle
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from dsjax_torch.config import (BiDirectionalConfig, ConformerConfig, LogMelConfig, RNNType,
                                SpectConfig, SpectrogramWindow, UniDirectionalConfig)

Tensor = torch.Tensor

_BN = ("weight", "bias", "running_mean", "running_var")
_CONVS = (("conv1", "conv.seq_module.0", "bn1", "conv.seq_module.1"),
          ("conv2", "conv.seq_module.3", "bn2", "conv.seq_module.4"))
_RNN = (("weight_ih", "weight_ih_l0"), ("weight_hh", "weight_hh_l0"),
        ("bias_ih", "bias_ih_l0"), ("bias_hh", "bias_hh_l0"))
_SUFFIXES = ("", "_reverse")
_LOOKAHEAD = "lookahead.0.conv.weight"
# converts a dsjax checkpoint directory (needs jax, orbax and dsjax)
CONVERT_TOOL = "tools/dsjax_checkpoint_to_torch.py"


def _t(a: Any) -> Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def is_conformer_state(state: Mapping[str, Any]) -> bool:
    """Whether a state_dict (either layout) is a Conformer's."""
    return any(k.startswith("encoder.pre_encode.") for k in state)


def infer_architecture(state: Mapping[str, Any]) -> Tuple[BiDirectionalConfig, int]:
    """(model_cfg, num_classes) from the shapes of a reference state_dict."""
    n_layers = 1 + max(
        (int(k.split(".")[1]) for k in state if k.startswith("rnns.")), default=0)
    bidirectional = any("_reverse" in k for k in state)
    hidden = state["rnns.0.rnn.weight_hh_l0"].shape[1]
    gates = state["rnns.0.rnn.weight_hh_l0"].shape[0] // hidden
    rnn_type = {4: RNNType.lstm, 3: RNNType.gru, 1: RNNType.rnn}[gates]
    fc_key = next(k for k in state if k.startswith("fc.") and k.endswith(".weight")
                  and len(state[k].shape) == 2)
    num_classes = state[fc_key].shape[0]
    if bidirectional:
        cfg = BiDirectionalConfig(rnn_type=rnn_type, hidden_size=hidden,
                                  hidden_layers=n_layers)
    else:
        ctx = state[_LOOKAHEAD].shape[2] if _LOOKAHEAD in state else 20
        cfg = UniDirectionalConfig(rnn_type=rnn_type, hidden_size=hidden,
                                   hidden_layers=n_layers, lookahead_context=ctx)
    return cfg, num_classes


def from_reference_state_dict(state: Mapping[str, Any]) -> Dict[str, Tensor]:
    """Reference state_dict (numpy arrays or tensors) -> the port's state_dict
    (a Conformer's as it stands, in float32)."""
    if is_conformer_state(state):
        return {k: _t(v) for k, v in state.items()}
    model_cfg, _ = infer_architecture(state)
    suffixes = _SUFFIXES[:1] if isinstance(model_cfg, UniDirectionalConfig) else _SUFFIXES
    out: Dict[str, Tensor] = {}
    for conv, ref_conv, bn, ref_bn in _CONVS:
        out[f"conv.{conv}.weight"] = _t(state[f"{ref_conv}.weight"])
        out[f"conv.{conv}.bias"] = _t(state[f"{ref_conv}.bias"])
        for k in _BN:
            out[f"conv.{bn}.{k}"] = _t(state[f"{ref_bn}.{k}"])
    for i in range(model_cfg.hidden_layers):
        for name, ref in _RNN:
            out[f"rnns.{i}.{name}"] = torch.stack(
                [_t(state[f"rnns.{i}.rnn.{ref}{sfx}"]) for sfx in suffixes])
        if i > 0:
            for k in _BN:
                out[f"rnn_bns.{i - 1}.{k}"] = _t(state[f"rnns.{i}.batch_norm.module.{k}"])
    if isinstance(model_cfg, UniDirectionalConfig):
        out["lookahead.weight"] = _t(state[_LOOKAHEAD])[:, 0, :]
    for k in _BN:
        out[f"fc_bn.{k}"] = _t(state[f"fc.0.module.0.{k}"])
    out["fc.weight"] = _t(state["fc.0.module.1.weight"])
    return out


def to_reference_state_dict(state: Mapping[str, Tensor]) -> Dict[str, Tensor]:
    """The port's state_dict -> the reference layout (inverse of the above)."""
    if is_conformer_state(state):
        return {k: v.detach().cpu().contiguous() for k, v in state.items()}
    out: Dict[str, Tensor] = {}
    for conv, ref_conv, bn, ref_bn in _CONVS:
        out[f"{ref_conv}.weight"] = state[f"conv.{conv}.weight"]
        out[f"{ref_conv}.bias"] = state[f"conv.{conv}.bias"]
        for k in _BN:
            out[f"{ref_bn}.{k}"] = state[f"conv.{bn}.{k}"]
    n_layers = 1 + max(int(k.split(".")[1]) for k in state if k.startswith("rnns."))
    for i in range(n_layers):
        for name, ref in _RNN:
            stacked = state[f"rnns.{i}.{name}"]
            for d, sfx in zip(range(stacked.shape[0]), _SUFFIXES):
                out[f"rnns.{i}.rnn.{ref}{sfx}"] = stacked[d]
        if i > 0:
            for k in _BN:
                out[f"rnns.{i}.batch_norm.module.{k}"] = state[f"rnn_bns.{i - 1}.{k}"]
    if "lookahead.weight" in state:
        out[_LOOKAHEAD] = state["lookahead.weight"][:, None, :]
    for k in _BN:
        out[f"fc.0.module.0.{k}"] = state[f"fc_bn.{k}"]
    out["fc.0.module.1.weight"] = state["fc.weight"]
    return {k: v.detach().cpu().contiguous() for k, v in out.items()}


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    """A nested mapping's leaves by path."""
    if isinstance(tree, Mapping):
        return {p: v for k, sub in tree.items() for p, v in _leaves(sub, path + (k,)).items()}
    return {path: tree}


def _layers(params: Mapping[str, Any]) -> int:
    return sum(1 for k in params if k.startswith("rnn") and not k.endswith("_bn"))


def from_dsjax_params(tree: Mapping[str, Any]) -> Dict[str, Tensor]:
    """A tree shaped like dsjax's ``params`` (the weights, or an element-wise
    optimizer state over them: Adam's ``mu``/``nu``, SGD's ``trace``) -> the
    port's parameters by ``named_parameters`` name. HWIO convs become OIHW,
    ``w_ih``/``w_hh``/``fc.kernel`` are transposed, the directions stacked,
    BatchNorm ``scale``/``bias`` become ``weight``/``bias``: a permutation,
    so every value is carried exactly. Raises ValueError for a leaf the
    layout lacks or one it does not take."""
    leaves = _leaves(tree)

    def leaf(*path: str) -> np.ndarray:
        if path not in leaves:
            raise ValueError(f"the dsjax tree has no leaf {'/'.join(path)}")
        return np.asarray(leaves.pop(path))

    out: Dict[str, Tensor] = {}
    for conv, _, bn_name, _ in _CONVS:
        # HWIO (kF, kT, I, O) -> OIHW
        out[f"conv.{conv}.weight"] = _t(leaf("conv", conv, "kernel").transpose(3, 2, 0, 1))
        out[f"conv.{conv}.bias"] = _t(leaf("conv", conv, "bias"))
        out[f"conv.{bn_name}.weight"] = _t(leaf("conv", bn_name, "scale"))
        out[f"conv.{bn_name}.bias"] = _t(leaf("conv", bn_name, "bias"))
    for i in range(_layers(tree)):
        dirs = ("fwd", "bwd") if "bwd_w_hh" in tree[f"rnn{i}"] else ("fwd",)
        for name, key, transpose in (("weight_ih", "w_ih", True), ("weight_hh", "w_hh", True),
                                     ("bias_ih", "b_ih", False), ("bias_hh", "b_hh", False)):
            per_dir = [leaf(f"rnn{i}", f"{d}_{key}") for d in dirs]
            out[f"rnns.{i}.{name}"] = torch.stack([_t(w.T if transpose else w) for w in per_dir])
        if i > 0:
            out[f"rnn_bns.{i - 1}.weight"] = _t(leaf(f"rnn{i}_bn", "scale"))
            out[f"rnn_bns.{i - 1}.bias"] = _t(leaf(f"rnn{i}_bn", "bias"))
    if "lookahead" in tree:
        # dsjax's (H, context) kernel (dsjax/model/torch_import.py:259-261)
        out["lookahead.weight"] = _t(leaf("lookahead", "weight"))
    out["fc_bn.weight"] = _t(leaf("fc_bn", "scale"))
    out["fc_bn.bias"] = _t(leaf("fc_bn", "bias"))
    out["fc.weight"] = _t(leaf("fc", "kernel").T)
    if leaves:
        raise ValueError(f"dsjax leaves with no counterpart among the port's parameters: "
                         f"{['/'.join(p) for p in leaves]}")
    return out


def from_dsjax_variables(variables: Mapping[str, Any]) -> Dict[str, Tensor]:
    """dsjax ``{"params": ..., "batch_stats": ...}`` trees (numpy or array
    leaves) of a DeepSpeech2 (any rnn_type, bidirectional or with Lookahead)
    -> the port's state_dict: ``from_dsjax_params`` and the BatchNorm
    running statistics."""
    params, stats = variables["params"], variables["batch_stats"]
    out = from_dsjax_params(params)
    norms = [("conv.bn1", stats["conv"]["bn1"]), ("conv.bn2", stats["conv"]["bn2"])]
    norms += [(f"rnn_bns.{i - 1}", stats[f"rnn{i}_bn"]) for i in range(1, _layers(params))]
    norms.append(("fc_bn", stats["fc_bn"]))
    for prefix, s in norms:
        out[f"{prefix}.running_mean"] = _t(s["mean"])
        out[f"{prefix}.running_var"] = _t(s["var"])
    return out


def model_cfg_dict(model_cfg: BiDirectionalConfig) -> Dict[str, Any]:
    """The hyper-parameters ``save_checkpoint`` records beside the weights:
    rnn_type, widths, direction and (unidirectional) the Lookahead context.
    A record for the reader, as in the reference's ``.ckpt`` files: loading
    reads the architecture from the weights (``infer_architecture``). A
    Conformer's is its whole config under ``"model": "conformer"``, which
    loading reads."""
    if isinstance(model_cfg, ConformerConfig):
        return {"model": "conformer", **dataclasses.asdict(model_cfg)}
    out = {"rnn_type": model_cfg.rnn_type.value, "hidden_size": model_cfg.hidden_size,
           "hidden_layers": model_cfg.hidden_layers,
           "bidirectional": not isinstance(model_cfg, UniDirectionalConfig)}
    if isinstance(model_cfg, UniDirectionalConfig):
        out["lookahead_context"] = model_cfg.lookahead_context
    return out


def spect_cfg_dict(spect_cfg: SpectConfig) -> Dict[str, Any]:
    """The front end's config as plain data: the reference's four fields,
    and for the log-mel front end ``"kind": "logmel"`` and its own two."""
    out = {"sample_rate": spect_cfg.sample_rate, "window_size": spect_cfg.window_size,
           "window_stride": spect_cfg.window_stride, "window": spect_cfg.window.value}
    if isinstance(spect_cfg, LogMelConfig):
        out.update(kind="logmel", n_fft=spect_cfg.n_fft, features=spect_cfg.features)
    return out


def spect_cfg_from(sp: Any) -> SpectConfig:
    """``spect_cfg_dict``'s inverse; missing fields take the defaults (a
    reference ``.ckpt`` holds the four linear fields)."""
    if not isinstance(sp, dict):
        return SpectConfig()
    cls = LogMelConfig if sp.get("kind") == "logmel" else SpectConfig
    base = cls()
    kwargs = {f.name: type(getattr(base, f.name))(sp[f.name])
              for f in dataclasses.fields(cls) if f.name in sp and f.name != "window"}
    return cls(window=SpectrogramWindow(sp.get("window", base.window.value)), **kwargs)


def model_from_hparams(state: Mapping[str, Any], hparams: Mapping[str, Any]
                       ) -> Tuple[Any, int]:
    """(model_cfg, num_classes) of a checkpoint: a Conformer's from its
    recorded config, a DeepSpeech2's from the weights' shapes."""
    if not is_conformer_state(state):
        return infer_architecture(state)
    rec = hparams.get("model_cfg")
    if not (isinstance(rec, dict) and rec.get("model") == "conformer"):
        raise ValueError("a Conformer's weights without its model_cfg: the head count cannot "
                         "be read from the shapes; write the file with save_checkpoint")
    fields = {f.name for f in dataclasses.fields(ConformerConfig)}
    cfg = ConformerConfig(**{k: v for k, v in rec.items() if k in fields})
    return cfg, state["decoder.decoder_layers.0.weight"].shape[0]


def save_checkpoint(path: str, state_dict: Mapping[str, Tensor],
                    model_cfg: BiDirectionalConfig, spect_cfg: SpectConfig,
                    labels: Sequence[str], extra: Optional[Mapping[str, Any]] = None) -> None:
    """Write a checkpoint that ``dsjax_torch.inference.load_model`` reads:
    the reference-layout state_dict plus the hyper-parameters the reference
    keeps beside it (labels, spect_cfg, model_cfg), all plain data.
    ``extra`` adds top-level entries (the trainer's optimizer state and
    counters), which loading a model ignores."""
    torch.save({
        **(extra or {}),
        "state_dict": to_reference_state_dict(state_dict),
        "hyper_parameters": {
            "labels": list(labels),
            "spect_cfg": spect_cfg_dict(spect_cfg),
            "model_cfg": model_cfg_dict(model_cfg),
        },
    }, path)


class _Stub:
    """Stands in for a class that ``load_checkpoint`` does not resolve
    (omegaconf's DictConfig and ListConfig and their value nodes, enums,
    Lightning's internals). It takes its state as dsjax's stub does
    (dsjax/model/torch_import.py:36-47), keyword arguments and a pickled
    state dict as attributes, and keeps its positional arguments (an enum's
    value)."""

    def __init__(self, *args, **kwargs):
        self.__dict__.update(kwargs)
        self._args = args

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)


@functools.lru_cache(maxsize=None)
def _allowed_globals() -> Dict[Tuple[str, str], Any]:
    """What a tensor state needs, by (module, name): torch's tensor rebuild
    functions, collections.OrderedDict, and the builtins that protocol 2
    pickles by name (sets, complex numbers, bytes through _codecs.encode).
    Storage classes never reach the unpickler: torch.load resolves them."""
    import _codecs
    import builtins
    import collections

    allowed: Dict[Tuple[str, str], Any] = {
        ("collections", "OrderedDict"): collections.OrderedDict,
        ("_codecs", "encode"): _codecs.encode,
    }
    for name in ("_rebuild_tensor", "_rebuild_tensor_v2", "_rebuild_parameter",
                 "_rebuild_parameter_with_state"):
        allowed[("torch._utils", name)] = getattr(torch._utils, name)
    for name in ("bytearray", "complex", "frozenset", "range", "set", "slice"):
        allowed[("builtins", name)] = getattr(builtins, name)
    return allowed


class _RestrictedUnpickler(pickle.Unpickler):
    """Resolves only ``_allowed_globals()``; any other (module, name) becomes
    a subclass of ``_Stub`` without its module being imported, so a
    checkpoint can neither import nor call anything else."""

    def find_class(self, module, name):
        found = _allowed_globals().get((module, name))
        if found is not None:
            return found
        return type(str(name), (_Stub,), {"__module__": str(module)})


class _RestrictedPickle:
    """The ``pickle_module`` that ``load_checkpoint`` gives ``torch.load``."""

    Unpickler = _RestrictedUnpickler

    @staticmethod
    def load(f, **kwargs):
        return _RestrictedUnpickler(f, **kwargs).load()


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The object a checkpoint file holds, on the CPU: the port's own files
    (``save_checkpoint``, the trainer's) and the reference's Lightning
    ``.ckpt`` files, whose hyper-parameters hold omegaconf objects. Tensors
    and plain data load as they are; every other class or function the
    pickle names becomes a ``_Stub`` (``_RestrictedUnpickler``)."""
    return torch.load(path, map_location="cpu", pickle_module=_RestrictedPickle,
                      weights_only=False)


def plain_hparams(x: Any) -> Any:
    """Hyper-parameters as plain data: a stubbed omegaconf container as its
    ``_content`` (as dsjax reads ``spect_cfg``, torch_import.py:279-298), a
    value node as its ``_val``, an enum as its value; dicts and lists as
    they are."""
    if isinstance(x, _Stub):
        state = vars(x)
        for key in ("_content", "_val"):
            if key in state:
                return plain_hparams(state[key])
        args = state.get("_args", ())
        if len(args) == 1:
            return plain_hparams(args[0])
        return {k: plain_hparams(v) for k, v in state.items()}
    if isinstance(x, dict):
        return {k: plain_hparams(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain_hparams(v) for v in x]
    return x
