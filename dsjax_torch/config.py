"""Serving configuration: the dataclasses of dsjax/config.py that the serving
path reads, and ``compose`` for dotted overrides.

A copy, so the port runs without the JAX package beside it;
tests/test_torch_frontend.py holds every field name and default equal to
dsjax.config's, and ``compose`` equal to dsjax's on the same command lines.
The one addition is ``ServerConfig.device``, the torch device the server
runs the model on. ``platform`` and ``num_cpu_devices`` select a JAX
platform in dsjax; they are kept so the same command lines parse, and the
port reads neither.

Override values follow YAML's scalar rules (``8`` is an int, ``true`` a
bool, ``null`` None), implemented here: PyYAML is imported only to read an
overlay file (``configs=PATH``).
"""

from __future__ import annotations

import enum
import os
import re
import typing
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, List, Optional, Type


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
class BiDirectionalConfig:
    rnn_type: RNNType = RNNType.lstm
    hidden_size: int = 1024
    hidden_layers: int = 5


@dataclass
class UniDirectionalConfig(BiDirectionalConfig):
    lookahead_context: int = 20


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
    num_cpu_devices: int = 0          # dsjax's fake CPU devices; not read here


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
    device: str = "cuda"              # "cpu" only when asked for


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
    typ = _field_type(obj, name)
    if is_dataclass(typ):
        raise ValueError(f"{dotted} is a group: set its fields ({dotted}.NAME=...)")
    setattr(obj, name, _coerce(value, typ))


def _merge_overlay(cfg: Any, overlay: Dict[str, Any], path: str = "") -> None:
    for k, v in overlay.items():
        full = f"{path}.{k}" if path else k
        if not hasattr(cfg, k):
            raise KeyError(f"overlay key {full!r} not in config schema")
        cur = getattr(cfg, k)
        if is_dataclass(cur) and isinstance(v, dict):
            _merge_overlay(cur, v, full)
        else:
            setattr(cfg, k, _coerce(v, _field_type(cfg, k)))


def _load_overlay(name: str) -> Dict[str, Any]:
    """An overlay file: a path, or NAME for configs/NAME.yaml."""
    path = name if os.path.isfile(name) else os.path.join("configs", name + ".yaml")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"config overlay {name!r} not found (a path, or configs/NAME.yaml)")
    import yaml

    with open(path) as fh:
        overlay = yaml.safe_load(fh) or {}
    overlay.pop("# @package _global_", None)
    return overlay


def compose(schema: Type, argv: Optional[List[str]] = None,
            overlays: Optional[List[str]] = None) -> Any:
    """Build a config: schema defaults -> overlay file(s) -> dotted overrides
    (``key.path=value``; ``configs=NAME`` or ``+configs=NAME`` adds an
    overlay)."""
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
