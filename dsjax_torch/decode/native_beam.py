"""ctypes bindings of the port's native word n-gram LM and CTC prefix beam
search (``csrc/host/lm.cpp`` and ``beam.cpp``, copies of dsjax's), on the
host library of ``dsjax_torch.audio.native``.

Counterpart of dsjax/cpp/beam_binding.py: ``build_lm_binary`` (ARPA text ->
the DSLMBIN2 binary), ``CppLM`` (an ARPA or DSLMBIN1/2 model) and
``CppBeamDecoder`` (one utterance's beam search, with or without an LM).
The native call releases the interpreter lock, so a thread pool decodes
utterances in parallel. Importing this module builds and loads nothing.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np

from dsjax_torch.audio import native


def build_lm_binary(arpa_path: str, out_path: str) -> None:
    """ARPA text -> mmap-ready DSLMBIN2 binary: the host queries it by binary
    search, and the device LM (``decode.lm_device``) packs its tables from
    its word and n-gram id arrays."""
    rc = native.load_library().ds_lm_build_binary(arpa_path.encode(), out_path.encode())
    if rc != 0:
        raise IOError(f"binary LM build failed (code {rc}) for {arpa_path}")


class CppLM:
    """The native LM of an ARPA file or a DSLMBIN1/2 binary: log10 scores
    with Katz backoff, as ``decode.lm.ArpaLM``'s."""

    def __init__(self, path: str):
        self.lib = native.load_library()
        self.handle = self.lib.ds_lm_load(path.encode())
        if not self.handle:
            raise IOError(f"failed to load LM from {path} (ARPA or DSLMBIN1/2)")

    @property
    def order(self) -> int:
        return int(self.lib.ds_lm_order(self.handle))

    def score_word(self, word: str, context: Sequence[str]) -> float:
        arr = (ctypes.c_char_p * len(context))(*[c.encode() for c in context])
        return self.lib.ds_lm_score_word(self.handle, arr, len(context), word.encode())

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.ds_lm_free(self.handle)
            self.handle = None


class CppBeamDecoder:
    """Native prefix beam search over one utterance's posteriors, the
    contract of ``decode.beam.BeamCTCDecoder._decode_one``."""

    def __init__(self, labels: Sequence[str], lm_path: Optional[str], blank_index: int,
                 space_index: int):
        self.lib = native.load_library()
        self._lm = CppLM(lm_path) if lm_path else None
        label_arr = (ctypes.c_char_p * len(labels))(*[lbl.encode() for lbl in labels])
        self.handle = self.lib.ds_beam_create(label_arr, len(labels), blank_index, space_index,
                                              self._lm.handle if self._lm else None)

    def decode(self, probs: np.ndarray, alpha: float, beta: float, beam_width: int,
               cutoff_top_n: int, cutoff_prob: float, n_paths: Optional[int] = None
               ) -> List[Tuple[Tuple[int, ...], Tuple[int, ...], float]]:
        """probs: (T, C) float32 posteriors of one utterance -> the beams,
        best first, as (label ids, frame offsets, score)."""
        probs = np.ascontiguousarray(probs, dtype=np.float32)
        t_dim, c_dim = probs.shape
        n_paths = n_paths or beam_width
        max_len = max(t_dim, 1)
        out_ids = np.zeros((n_paths, max_len), np.int32)
        out_offs = np.zeros((n_paths, max_len), np.int32)
        out_lens = np.zeros((n_paths,), np.int32)
        out_scores = np.zeros((n_paths,), np.float64)
        ip = ctypes.POINTER(ctypes.c_int)
        written = self.lib.ds_beam_decode(
            self.handle, probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), t_dim, c_dim,
            alpha, beta, beam_width, cutoff_top_n, cutoff_prob, n_paths, max_len,
            out_ids.ctypes.data_as(ip), out_offs.ctypes.data_as(ip), out_lens.ctypes.data_as(ip),
            out_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        results = []
        for i in range(written):
            n = int(out_lens[i])
            results.append((tuple(int(x) for x in out_ids[i, :n]),
                            tuple(int(x) for x in out_offs[i, :n]), float(out_scores[i])))
        return results

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.ds_beam_free(self.handle)
            self.handle = None
