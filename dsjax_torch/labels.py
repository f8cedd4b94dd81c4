"""Label alphabet: the counterpart of dsjax/labels.py.

A copy, so the port runs without the JAX package beside it;
tests/test_torch_frontend.py holds it equal to the original. The alphabet is
the reference's ``labels.json``: 29 characters, blank ``"_"`` at index 0,
apostrophe, A-Z, space at index 28.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence

DEFAULT_LABELS: List[str] = ["_", "'"] + [chr(c) for c in range(ord("A"), ord("Z") + 1)] + [" "]

BLANK_INDEX = 0


def load_labels(path: Optional[str] = None) -> List[str]:
    """The label list from a JSON file; the default alphabet if path is None."""
    if path is None:
        return list(DEFAULT_LABELS)
    with open(path, "r", encoding="utf8") as f:
        labels = json.load(f)
    if not isinstance(labels, list) or not all(isinstance(c, str) for c in labels):
        raise ValueError(f"labels file {path} must contain a JSON list of strings")
    return labels


class LabelMap:
    """Char <-> int mapping. ``space_index`` is len(labels) when the
    alphabet has no space (an out-of-bounds sentinel, as in the reference)."""

    def __init__(self, labels: Sequence[str], blank_index: int = BLANK_INDEX):
        self.labels = list(labels)
        self.blank_index = blank_index
        self.char_to_int = {c: i for i, c in enumerate(self.labels)}
        self.int_to_char = {i: c for i, c in enumerate(self.labels)}
        self.space_index = self.labels.index(" ") if " " in self.labels else len(self.labels)

    def __len__(self) -> int:
        return len(self.labels)

    def encode(self, transcript: str) -> List[int]:
        """Transcript -> ids; characters outside the alphabet are dropped."""
        return [self.char_to_int[c] for c in transcript if c in self.char_to_int]

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(self.int_to_char[int(i)] for i in ids)
