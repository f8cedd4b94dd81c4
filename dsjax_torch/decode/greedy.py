"""Greedy (best-path) CTC decoding: the counterpart of dsjax/decode/greedy.py.

The argmax and the collapse mask run in torch on the posteriors' device;
the host only builds the final short strings.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dsjax_torch.labels import LabelMap
from dsjax_torch.trace import span

Tensor = torch.Tensor


def greedy_collapse_device(probs: Tensor, sizes: Tensor, blank_index: int = 0
                           ) -> Tuple[Tensor, Tensor]:
    """(B, T, C) probs/logits -> (argmax ids (B, T) int32, keep mask (B, T)).

    keep[b, t] is True where the frame contributes a character after CTC
    collapse: not blank, not a repeat of the previous frame, and t < size.
    """
    ids = probs.argmax(dim=-1).to(torch.int32)
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    t = torch.arange(ids.shape[1], device=ids.device)[None, :]
    keep = (ids != blank_index) & (ids != prev) & (t < sizes.to(ids.device)[:, None])
    return ids, keep


class GreedyDecoder:
    """``decode(probs, sizes)`` returns (strings, offsets) shaped like the
    reference: strings[b] is a one-element list (the best path), offsets[b]
    the frame index of each character."""

    def __init__(self, labels: Sequence[str], blank_index: int = 0):
        label_map = LabelMap(labels, blank_index)
        self.blank_index = blank_index
        self.space_index = label_map.space_index
        self.int_to_char = label_map.int_to_char

    def decode(self, probs, sizes=None, n_best: Optional[int] = None
               ) -> Tuple[List[List[str]], List[List[np.ndarray]]]:
        # n_best: signature parity across decoders; greedy has one path
        del n_best
        probs = torch.as_tensor(probs)
        b, t = probs.shape[0], probs.shape[1]
        if sizes is None:
            sizes = torch.full((b,), t, dtype=torch.int32)
        ids, keep = greedy_collapse_device(probs, torch.as_tensor(sizes), self.blank_index)
        ids_np = ids.cpu().numpy()
        keep_np = keep.cpu().numpy()
        strings: List[List[str]] = []
        offsets: List[List[np.ndarray]] = []
        for i in range(b):
            pos = np.nonzero(keep_np[i])[0]
            strings.append(["".join(self.int_to_char[int(c)] for c in ids_np[i, pos])])
            offsets.append([pos.astype(np.int32)])
        return strings, offsets

    def convert_to_strings(self, sequences: Sequence[Sequence[int]]) -> List[List[str]]:
        """Label id sequences -> one-element lists of strings, blanks dropped
        (reference: decoder.py:125-162); used for the targets' strings. The
        call is a ``greedy.strings`` span (``dsjax_torch.trace``)."""
        with span("greedy.strings"):
            return [["".join(" " if int(c) == self.space_index else self.int_to_char[int(c)]
                             for c in seq if int(c) != self.blank_index)]
                    for seq in sequences]
