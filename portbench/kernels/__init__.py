"""The kernels the benchmark reads, one file each: ``kernels/<K>.py``, the
file's name the kernel's. A kernel comes into the benchmark with its file
alone; nothing here names one.

Each file declares:

  COUNTER      (module, attribute): the program's launch counter, one a
               call of the kernel's C entry point, in ``dsjax_torch.ops``;
  matches      matches(name) -> bool: whether a device kernel's name, in
               lower case, is one of this kernel's launches;
  LAUNCHED_BY  the (rnn_type, training) layer calls that launch it once
               each (none for a kernel no recurrent layer launches);
  bound        bound(*call) -> (seconds, what bounds it): the least time of
               one call on one H100 (``counts.least_time``).

No device kernel's name may match two files.
"""

from __future__ import annotations

import functools
import importlib
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional, Tuple

HERE = Path(__file__).resolve().parent


@functools.lru_cache(maxsize=None)
def found() -> Dict[str, ModuleType]:
    """Every kernel file of this folder, by kernel name."""
    return {p.stem: importlib.import_module(f"{__name__}.{p.stem}")
            for p in sorted(HERE.glob("*.py")) if p.stem != "__init__"}


def scan_kernels() -> Dict[Tuple[str, bool], Tuple[str, ...]]:
    """The kernels each (rnn_type, training) layer call launches once."""
    out: Dict[Tuple[str, bool], Tuple[str, ...]] = {}
    for name, k in found().items():
        for call in k.LAUNCHED_BY:
            out[call] = out.get(call, ()) + (name,)
    return out


def counters() -> Dict[str, int]:
    """Each kernel's launch counter as the program holds it now; a counter
    the program lacks is left out, so its kernel's roofline reads nothing."""
    out = {}
    for name, k in found().items():
        module, attribute = k.COUNTER
        try:
            out[name] = int(getattr(importlib.import_module(module), attribute))
        except (ImportError, AttributeError):
            continue
    return out


def kernel_of(name: str) -> Optional[str]:
    """The kernel whose file matches a device kernel's name, or None."""
    low = name.lower()
    hits = [k for k, m in found().items() if m.matches(low)]
    if len(hits) > 1:
        raise ValueError(f"device kernel {name!r} matches the files of {hits}")
    return hits[0] if hits else None


def bound(kernel: str, *call) -> Tuple[float, str]:
    return found()[kernel].bound(*call)


def scan_sizes(n_dir: int, n_t: int, n_b: int, n_h: int) -> Tuple[int, int, int]:
    """A scan call's (D, T, B, H) sequence tensor's elements, a (D, B, H)
    carry's, and the (T, B) float32 mask's bytes."""
    return n_dir * n_t * n_b * n_h, n_dir * n_b * n_h, n_t * n_b * 4
