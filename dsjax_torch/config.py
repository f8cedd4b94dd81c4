"""Configuration: the dataclasses of dsjax/config.py that the serving and
training paths read, and ``compose`` for dotted overrides.

A copy, so the port runs without the JAX package beside it;
tests/test_torch_frontend.py and tests/test_torch_data.py hold every field
name and default equal to dsjax.config's, and ``compose`` equal to dsjax's
on the same command lines (including the group swaps ``optim=sgd`` and
``model=unidirectional``). The additions are ``ServerConfig.device`` and
``TrainerConfig.device``, the torch device the server or the trainer runs
the model on, and two group members dsjax lacks: ``model=conformer``
(``ConformerConfig``) and ``data.spect=logmel`` (``LogMelConfig``, a
``SpectConfig`` with NeMo's log-mel fields); the defaults stay dsjax's. Fields that select or tune JAX itself (``platform``,
``matmul_precision``, ``donate_state``) are kept so the same command lines
parse; the server, evaluation and transcription read none of them, and the
trainer refuses a value other than the default. ``num_cpu_devices`` of the
inference configs is read as in dsjax: with ``device=cpu`` the model gets
that many CPU replicas (dsjax's fake CPU devices), over which batches shard
(``inference.local_devices``); ``trainer.num_cpu_devices`` stays refused.
Under torchrun ``trainer.devices`` counts a node's processes, one a card,
and the trainer's ``mesh_*`` must describe the world size
(``parallel/mesh.py``); ``mesh_model`` > 1 shards the recurrent and head
weights over groups of that many ranks (``parallel/tensor.py``).
``EvalConfig`` and ``TranscribeConfig`` also gain ``device``;
``EvalConfig`` drops dsjax's unread ``save_output``.

Override values follow YAML's scalar rules (``8`` is an int, ``true`` a
bool, ``null`` None), implemented here: PyYAML is imported only to read an
overlay file (``configs=PATH``, or ``+configs=NAME`` for
``dsjax_torch/configs/NAME.yaml``, byte-for-byte copies of dsjax's dataset
overlays, then ``./configs/NAME.yaml``). ``to_dict``/``from_dict`` are
dsjax's, so a checkpoint directory's ``meta.json`` carries the same tagged
config in both packages; ``compose_cli`` gives the entry modules dsjax's
``-h``/``--help`` listing.
"""

from __future__ import annotations

import enum
import os
import re
import typing
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, List, Optional, Tuple, Type


class DecoderType(str, enum.Enum):
    greedy = "greedy"
    beam = "beam"


class SpectrogramWindow(str, enum.Enum):
    hamming = "hamming"
    hann = "hann"
    blackman = "blackman"
    bartlett = "bartlett"


class RNNType(str, enum.Enum):
    lstm = "lstm"
    gru = "gru"
    rnn = "rnn"


@dataclass
class SpectConfig:
    sample_rate: int = 16000          # sample rate of features/model
    window_size: float = 0.02         # STFT window in seconds
    window_stride: float = 0.01       # STFT hop in seconds
    window: SpectrogramWindow = SpectrogramWindow.hamming


@dataclass
class LogMelConfig(SpectConfig):
    """NeMo's log-mel front end (``AudioToMelSpectrogramPreprocessor``):
    ``data.spect=logmel``. The window of ``window_size`` seconds sits in the
    middle of ``n_fft`` points; pre-emphasis, the power spectrum, ``features``
    Slaney mel bands, a log, per-feature normalisation
    (``audio/features.py:logmel_np``)."""
    window_size: float = 0.025
    window: SpectrogramWindow = SpectrogramWindow.hann
    n_fft: int = 512
    features: int = 80


@dataclass
class AugmentationConfig:
    speed_volume_perturb: bool = False  # random tempo/gain perturbation
    spec_augment: bool = False          # SpecAugment on spectrograms
    spec_augment_device: bool = False   # dsjax: SpecAugment masks inside the step
    noise_dir: str = ""                 # dir of noise wavs ('' disables)
    noise_prob: float = 0.4             # per-sample probability of noise mix
    noise_min: float = 0.0
    noise_max: float = 0.5


@dataclass
class DataConfig:
    train_path: str = "data/train_manifest.json"
    val_path: str = "data/val_manifest.json"
    batch_size: int = 64
    num_workers: int = 4                # host-side loader threads
    labels_path: str = "labels.json"
    spect: SpectConfig = field(default_factory=SpectConfig)
    augmentation: AugmentationConfig = field(default_factory=AugmentationConfig)
    # the STFT on the device inside the step, from int16 raw audio; false
    # computes the features on the loader's threads
    device_features: bool = True
    bucket_frames: int = 64             # pad the time axis to a multiple of this
    # split each training batch into this many length-quantile sub-batches
    # whose gradients sum into one optimizer step; 1 = off
    ragged_split: int = 1
    bucket_labels: int = 256            # pad targets to a multiple of this
    prefetch_batches: int = 2           # collated batches loaded ahead
    device_prefetch: int = 2            # batches copied to the device ahead; 0 = off


@dataclass
class BiDirectionalConfig:
    rnn_type: RNNType = RNNType.lstm
    hidden_size: int = 1024
    hidden_layers: int = 5


@dataclass
class UniDirectionalConfig(BiDirectionalConfig):
    lookahead_context: int = 20


@dataclass
class ConformerConfig:
    """Conformer-CTC (Gulati et al. 2020, arXiv:2005.08100), ``model=conformer``:
    the defaults are NeMo's Large row (``conformer_ctc_char.yaml``), built as
    that file builds it: striding subsampling by 4 with d_model channels,
    x-scaling, relative-position attention with per-layer biases."""
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 18
    ff_expansion_factor: int = 4
    conv_kernel_size: int = 31
    # NeMo's dropout, dropout_pre_encoder and dropout_att, equal in its Large
    # row: the subsampling's output, the FFNs, the attention probabilities
    # and every residual branch
    dropout: float = 0.1


@dataclass
class OptimConfig:
    learning_rate: float = 1.5e-4
    learning_anneal: float = 0.99       # per-epoch exponential LR decay
    weight_decay: float = 1e-5


@dataclass
class SGDConfig(OptimConfig):
    momentum: float = 0.9


@dataclass
class AdamConfig(OptimConfig):
    eps: float = 1e-8
    betas: Tuple[float, float] = (0.9, 0.999)


@dataclass
class CheckpointConfig:
    dirpath: Optional[str] = None       # where checkpoints are written
    filename: Optional[str] = None
    monitor: str = "wer"                # metric minimized for best-k
    save_top_k: int = 1
    save_last: bool = True
    verbose: bool = False
    every_n_steps: int = 0              # 0 = only at validation epochs


@dataclass
class TrainerConfig:
    max_epochs: int = 70
    precision: int = 16                 # 16: bfloat16 compute, float32 parameters
    gradient_clip_val: float = 400.0
    # cards on this node, one process each (torchrun's LOCAL_WORLD_SIZE):
    # -1 = all; without torchrun -1 or 1
    devices: int = -1
    limit_train_batches: float = 1.0    # fraction (<=1.0) or count (>1)
    limit_val_batches: float = 1.0
    log_every_n_steps: int = 50
    log_dir: str = "logs"               # metrics.jsonl + TensorBoard events; '' disables
    val_check_interval: float = 1.0     # fraction of an epoch between validations
    accumulate_grad_batches: int = 1
    enable_checkpointing: bool = True
    # a checkpoint to resume from: the port's checkpoint directory (or its
    # last/best subdirectory) or file, or a reference-layout .ckpt
    # state_dict, which warm-starts the weights with a fresh optimizer
    resume_from_checkpoint: str = ""
    deterministic: bool = False
    detect_anomaly: bool = False        # raise at the first NaN/Inf in backward
    # dsjax's mesh: mesh_model x mesh_dcn (nodes) dividing the world size,
    # mesh_data -1 or world size / (mesh_model x mesh_dcn); mesh_model > 1
    # shards the recurrent and head weights over that many ranks
    mesh_data: int = -1
    mesh_model: int = 1
    mesh_dcn: int = 1
    platform: str = ""                  # dsjax's JAX platform
    num_cpu_devices: int = 0            # dsjax's fake CPU devices
    matmul_precision: str = ""          # dsjax's XLA matmul precision
    donate_state: bool = True           # dsjax's buffer donation
    profile: bool = False               # dsjax: an XProf trace of a few steps
    profile_dir: str = "profiles"
    profile_start_step: int = 10
    profile_num_steps: int = 4
    # "cpu" only when asked for; "cuda" is cuda:LOCAL_RANK under torchrun
    device: str = "cuda"


@dataclass
class TrainConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: BiDirectionalConfig = field(default_factory=BiDirectionalConfig)
    optim: OptimConfig = field(default_factory=AdamConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    seed: int = 123456
    load_auto_checkpoint: bool = False


@dataclass
class LMConfig:
    decoder_type: DecoderType = DecoderType.greedy
    lm_path: str = ""
    top_paths: int = 1
    alpha: float = 0.0
    beta: float = 0.0
    cutoff_top_n: int = 40
    cutoff_prob: float = 1.0
    beam_width: int = 10
    lm_workers: int = 4
    device_beam: bool = False


@dataclass
class ModelLoadConfig:
    precision: int = 32               # 16: bfloat16 compute
    model_path: str = ""


@dataclass
class InferenceConfig:
    lm: LMConfig = field(default_factory=LMConfig)
    model: ModelLoadConfig = field(default_factory=ModelLoadConfig)
    platform: str = ""                # dsjax's JAX platform; not read here
    # with device=cpu, this many CPU replicas when > 0 (dsjax's fake CPU
    # devices); batches shard over them
    num_cpu_devices: int = 0


@dataclass
class TranscribeConfig(InferenceConfig):
    audio_path: str = ""
    offsets: bool = False
    chunk_size_seconds: float = -1.0
    device: str = "cuda"              # "cpu" only when asked for; see ServerConfig


@dataclass
class EvalConfig(InferenceConfig):
    test_path: str = ""
    verbose: bool = True
    batch_size: int = 20
    num_workers: int = 4
    # the STFT on the device from int16 raw audio (dsjax's default);
    # evaluate() takes host features when the window overlap is not 50%
    device_features: bool = True
    device: str = "cuda"              # "cpu" only when asked for; see ServerConfig


@dataclass
class ServerConfig(InferenceConfig):
    host: str = "0.0.0.0"
    port: int = 8888
    chunk_size_seconds: float = -1.0
    max_batch: int = 8                # server-side dynamic batching cap
    batch_timeout_ms: float = 20.0
    # run every power-of-2 batch size once at startup at this utterance
    # length (seconds), so no request pays for first-use work; 0 disables
    warmup_seconds: float = 10.0
    # /stream sessions idle longer than this are garbage-collected
    stream_session_ttl: float = 300.0
    # "cpu" only when asked for; "cuda" is every visible card, "cuda:k" one,
    # "cuda:0,cuda:1" a list, where a card may repeat
    device: str = "cuda"


# polymorphic groups: "optim=sgd" swaps the group's dataclass
GROUPS: Dict[str, Dict[str, Type]] = {
    "optim": {"adam": AdamConfig, "sgd": SGDConfig},
    "model": {"bidirectional": BiDirectionalConfig, "unidirectional": UniDirectionalConfig,
              "conformer": ConformerConfig},
    "spect": {"linear": SpectConfig, "logmel": LogMelConfig},
}
# every schema by name: the ``_type_`` tags of to_dict, meta.json and overlays
_ALL_SCHEMAS: Dict[str, Type] = {cls.__name__: cls for cls in (
    SpectConfig, LogMelConfig, AugmentationConfig, DataConfig, BiDirectionalConfig,
    UniDirectionalConfig, ConformerConfig, OptimConfig, SGDConfig, AdamConfig, CheckpointConfig, TrainerConfig, TrainConfig,
    LMConfig, ModelLoadConfig, InferenceConfig, TranscribeConfig, EvalConfig, ServerConfig)}
# overlays by name: the port's copies of dsjax's dataset overlays, then ./configs
CONFIG_DIRS = [os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs"), "configs"]

# YAML 1.1's implicit scalar types, as PyYAML's safe loader resolves them
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {v: b for b, vs in ((True, "yes Yes YES true True TRUE on On ON"),
                            (False, "no No NO false False FALSE off Off OFF"))
         for v in vs.split()}
_INT = re.compile(r"^[-+]?(?:0b[01_]+|0x[0-9a-fA-F_]+|0[0-7_]+|0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _parse_scalar(s: str) -> Any:
    """A command-line value by YAML's scalar rules ('8' -> 8, 'on' -> True)."""
    s = s.strip()
    if _NULL.match(s):
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        body = s.lstrip("+-").replace("_", "")
        sign = -1 if s.startswith("-") else 1
        if body.startswith(("0b", "0x")):
            return sign * int(body, 0)
        return sign * int(body, 8 if len(body) > 1 and body[0] == "0" else 10)
    if _FLOAT.match(s):
        return float(s.replace("_", "").replace(".inf", "inf").replace(".Inf", "inf")
                     .replace(".INF", "inf").replace(".nan", "nan").replace(".NaN", "nan")
                     .replace(".NAN", "nan"))
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    if s[:1] in "[{":
        raise ValueError(f"{s!r}: flow collections are not parsed on the command "
                         f"line; put them in an overlay file (configs=PATH)")
    return s


def _coerce(value: Any, typ: Any) -> Any:
    """A parsed value as the field's annotated type."""
    if getattr(typ, "__origin__", None) is typing.Union:
        if value is None:
            return None
        typ = next(a for a in typ.__args__ if a is not type(None))
    if isinstance(typ, type) and issubclass(typ, enum.Enum):
        return value if isinstance(value, typ) else typ(value)
    if getattr(typ, "__origin__", None) is tuple:
        return tuple(_coerce(v, t) for v, t in zip(value, typ.__args__))
    if typ is float and isinstance(value, (int, str)):
        return float(value)
    if typ is int and isinstance(value, (float, str)):
        return int(float(value))
    if typ is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    if typ is str and not isinstance(value, str):
        return str(value)
    return value


def _field_type(obj: Any, name: str) -> Any:
    if name not in {f.name for f in fields(obj)}:
        raise KeyError(f"config has no field {name!r}")
    return typing.get_type_hints(type(obj))[name]


def _set_dotted(cfg: Any, dotted: str, value: Any) -> None:
    *path, name = dotted.split(".")
    obj = cfg
    for p in path:
        if not (is_dataclass(obj) and hasattr(obj, p)):
            raise KeyError(f"config has no field {dotted!r} (at {p!r})")
        obj = getattr(obj, p)
    if not is_dataclass(obj) or not hasattr(obj, name):
        raise KeyError(f"config has no field {dotted!r}")
    if name in GROUPS and isinstance(value, str) and value in GROUPS[name]:
        setattr(obj, name, GROUPS[name][value]())
        return
    typ = _field_type(obj, name)
    if is_dataclass(typ):
        raise ValueError(f"{dotted} is a group: set its fields ({dotted}.NAME=...)")
    setattr(obj, name, _coerce(value, typ))


def _merge_overlay(cfg: Any, overlay: Dict[str, Any], path: str = "") -> None:
    for k, v in overlay.items():
        full = f"{path}.{k}" if path else k
        if not hasattr(cfg, k):
            raise KeyError(f"overlay key {full!r} not in config schema")
        if k == "_type_":
            continue
        cur = getattr(cfg, k)
        if k in GROUPS and isinstance(v, str) and v in GROUPS[k]:
            setattr(cfg, k, GROUPS[k][v]())
        elif is_dataclass(cur) and isinstance(v, dict):
            tag = v.get("_type_")
            if tag in _ALL_SCHEMAS and type(cur).__name__ != tag:
                cur = _ALL_SCHEMAS[tag]()
                setattr(cfg, k, cur)
            _merge_overlay(cur, v, full)
        else:
            setattr(cfg, k, _coerce(v, _field_type(cfg, k)))


def find_overlay(name: str) -> Optional[str]:
    """An overlay name ('an4') or path -> its YAML file: a path first, then
    NAME.yaml in each of CONFIG_DIRS (dsjax's find_overlay)."""
    if os.path.isfile(name):
        return name
    for folder in CONFIG_DIRS:
        path = os.path.join(folder, name + ".yaml")
        if os.path.isfile(path):
            return path
    return None


def _load_overlay(name: str) -> Dict[str, Any]:
    path = find_overlay(name)
    if path is None:
        raise FileNotFoundError(f"config overlay {name!r} not found: neither a path nor "
                                f"NAME.yaml in {CONFIG_DIRS}")
    import yaml

    with open(path) as fh:
        overlay = yaml.safe_load(fh) or {}
    overlay.pop("# @package _global_", None)
    return overlay


def compose(schema: Type, argv: Optional[List[str]] = None,
            overlays: Optional[List[str]] = None) -> Any:
    """Build a config: schema defaults -> overlay file(s) -> dotted overrides
    (``key.path=value``; ``configs=NAME`` or ``+configs=NAME`` adds an
    overlay, found by ``find_overlay``)."""
    cfg = schema()
    overlay_names = list(overlays or [])
    rest = []
    for a in argv or []:
        key, _, val = a.partition("=")
        key = key.lstrip("+")
        if key in ("configs", "config"):
            overlay_names.append(val)
        else:
            rest.append((key, val))
    for name in overlay_names:
        _merge_overlay(cfg, _load_overlay(name))
    for key, val in rest:
        _set_dotted(cfg, key, _parse_scalar(val))
    return cfg


def compose_cli(schema: Type, doc: Optional[str], argv: List[str]) -> Any:
    """An entry module's config: with -h or --help among ``argv``, print
    ``doc`` and the options (print_help) and exit 0, as dsjax's root CLIs
    do; else compose(schema, argv)."""
    if any(a in ("-h", "--help") for a in argv):
        print_help(schema, doc)
        raise SystemExit(0)
    return compose(schema, argv)


# ---------------------------------------------------------------------------
# dict <-> dataclass (dsjax/config.py's to_dict, from_dict and print_help)
# ---------------------------------------------------------------------------

def to_dict(cfg: Any) -> Any:
    """Dataclass tree -> plain dict (enums -> their values, each dataclass
    tagged with its ``_type_``)."""
    if is_dataclass(cfg) and not isinstance(cfg, type):
        d = {f.name: to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
        d["_type_"] = type(cfg).__name__
        return d
    if isinstance(cfg, enum.Enum):
        return cfg.value
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    return cfg


def from_dict(d: Any, schema: Type) -> Any:
    """Plain dict -> dataclass of type ``schema``, honouring ``_type_`` tags;
    keys the schema lacks are ignored."""
    if d is None:
        return schema() if is_dataclass(schema) else None
    if not is_dataclass(schema) or isinstance(d, schema):
        return d
    if isinstance(d, dict) and d.get("_type_") in _ALL_SCHEMAS:
        schema = _ALL_SCHEMAS[d["_type_"]]
    hints = typing.get_type_hints(schema)
    kwargs = {}
    for f in fields(schema):
        if isinstance(d, dict) and f.name in d:
            typ = hints[f.name]
            kwargs[f.name] = (from_dict(d[f.name], typ) if is_dataclass(typ)
                              else _coerce(d[f.name], typ))
    return schema(**kwargs)


def print_help(schema: Type, doc: Optional[str] = None) -> None:
    """Print a flat listing of dotted option paths with their defaults."""
    if doc:
        print(doc)
    print("Options (dotted key=value overrides; defaults shown):")

    def walk(d: Dict[str, Any], prefix: str = "") -> None:
        for k, v in d.items():
            if k == "_type_":
                continue
            if isinstance(v, dict) and "_type_" in v:
                walk(v, prefix + k + ".")
            else:
                print(f"  {prefix}{k} = {v!r}")

    walk(to_dict(schema()))
