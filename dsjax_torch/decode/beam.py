"""CTC prefix beam search on the host, with optional n-gram LM shallow fusion.

Counterpart of dsjax/decode/beam.py: the reference's BeamCTCDecoder
(deepspeech_pytorch/decoder.py:56-118, which wraps the C++ ctcdecode
package), with its constructor surface (labels, lm_path, alpha, beta,
cutoff_top_n, cutoff_prob, beam_width, num_processes, blank_index), its
``decode(probs, sizes) -> (strings, offsets)`` contract and
``reset_params(alpha, beta)`` for the LM tuner (reference:
search_lm_params.py:54-57).

Algorithm: CTC prefix beam search (Hannun et al. 2014) in log space with
per-prefix (p_blank, p_nonblank) mass, candidate pruning by cutoff_top_n /
cutoff_prob, and word-level LM fusion: on completing a word (space emission,
plus the trailing word at finalization) the path score gains
``alpha * ln P_lm(word | history) + beta``.

The decoder's path is the native one (``decode.native_beam``, a copy of
dsjax's C++ built into the port's host library): a failed build raises.
``native=False`` runs ``_decode_one``, the Python version, which the tests
hold equal to it and to dsjax's. ``decode`` takes numpy arrays or tensors
on any device: posteriors on the card are copied to the host once a decode.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dsjax_torch.decode.lm import load_word_lm
from dsjax_torch.labels import LabelMap

NEG_INF = -float("inf")


def _logaddexp(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    m = a if a > b else b
    return m + math.log(math.exp(a - m) + math.exp(b - m))


class _TrieNode:
    """ctcdecode PathTrie twin (parlance/ctcdecode path_trie.cpp).

    Semantics that matter for offsets parity with the reference's
    BeamCTCDecoder (reference decoder.py:85-101, which surfaces
    ctcdecode's per-beam ``timesteps``):

      * each char node carries (log_prob_c, timestep); EVERY extension
        attempt from a parent that is in the current beam updates them to
        the loudest frame seen so far (get_path_trie updates when the
        frame's char log-prob exceeds the stored one) — the reported
        offset of a char is NOT its first emission frame but the frame
        with the highest per-frame probability of that char among all
        frames where the extension was attempted;
      * nodes persist across steps; pruning a beam marks it dead
        (exists=False) and deletes now-childless chains, so a later
        re-creation of the same prefix starts with fresh (logp, t).
    """

    __slots__ = ("char", "parent", "children", "exists", "p_b", "p_nb",
                 "p_b_cur", "p_nb_cur", "log_prob_c", "timestep")

    def __init__(self, char: int = -1, parent: "_TrieNode" = None,
                 timestep: int = 0, log_prob_c: float = NEG_INF):
        self.char = char
        self.parent = parent
        self.children: Dict[int, "_TrieNode"] = {}
        self.exists = True
        self.p_b = NEG_INF
        self.p_nb = NEG_INF
        self.p_b_cur = NEG_INF
        self.p_nb_cur = NEG_INF
        self.log_prob_c = log_prob_c
        self.timestep = timestep

    def total(self) -> float:
        return _logaddexp(self.p_b, self.p_nb)

    def get_path_trie(self, c: int, t: int, log_prob_c: float) -> "_TrieNode":
        node = self.children.get(c)
        if node is not None:
            if node.log_prob_c < log_prob_c:
                node.log_prob_c = log_prob_c
                node.timestep = t
            if not node.exists:
                node.exists = True
                node.p_b = node.p_nb = NEG_INF
                node.p_b_cur = node.p_nb_cur = NEG_INF
            return node
        node = _TrieNode(c, self, t, log_prob_c)
        self.children[c] = node
        return node

    def remove(self) -> None:
        # iterative: prefix depth equals transcript length, which can
        # exceed Python's recursion limit on long one-shot audio
        node = self
        node.exists = False
        while (not node.children and node.parent is not None
               and not node.exists):
            del node.parent.children[node.char]
            node = node.parent
            if node.exists or node.children:
                break

    def path(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        ids: List[int] = []
        offs: List[int] = []
        n = self
        while n.parent is not None:
            ids.append(n.char)
            offs.append(n.timestep)
            n = n.parent
        return tuple(reversed(ids)), tuple(reversed(offs))

    def iterate_to_vec(self, out: List["_TrieNode"]) -> None:
        """End-of-step collection: swap cur -> prev for every live node
        (ctcdecode path_trie.cpp iterate_to_vec). Iterative — trie depth
        equals transcript length and can exceed the recursion limit."""
        stack = [self]
        while stack:
            node = stack.pop()
            if node.exists:
                node.p_b = node.p_b_cur
                node.p_nb = node.p_nb_cur
                node.p_b_cur = NEG_INF
                node.p_nb_cur = NEG_INF
                out.append(node)
            # reversed so pop() visits children in insertion order — the
            # exact pre-order the recursive version produced (stable-sort
            # tie-breaks downstream depend on it)
            stack.extend(reversed(list(node.children.values())))


class BeamCTCDecoder:
    def __init__(self, labels: Sequence[str], lm_path: Optional[str] = None,
                 alpha: float = 0.0, beta: float = 0.0, cutoff_top_n: int = 40,
                 cutoff_prob: float = 1.0, beam_width: int = 100,
                 num_processes: int = 4, blank_index: int = 0, native: bool = True):
        self.label_map = LabelMap(labels, blank_index)
        self.labels = list(labels)
        self.blank_index = blank_index
        self.space_index = self.label_map.space_index
        self.alpha = alpha
        self.beta = beta
        self.cutoff_top_n = cutoff_top_n
        self.cutoff_prob = cutoff_prob
        self.beam_width = beam_width
        self.num_processes = num_processes
        self.lm = load_word_lm(lm_path) if lm_path else None
        self._cpp = None
        if native:
            from dsjax_torch.decode.native_beam import CppBeamDecoder

            self._cpp = CppBeamDecoder(self.labels, lm_path, blank_index, self.space_index)

    def reset_params(self, alpha: float, beta: float) -> None:
        """LM weight update without rebuilding (reference: decoder.py via
        search_lm_params.py:54-57)."""
        self.alpha = alpha
        self.beta = beta

    # ------------------------------------------------------------------

    def decode(self, probs, sizes: Optional[Sequence[int]] = None,
               n_best: Optional[int] = None
               ) -> Tuple[List[List[str]], List[List[np.ndarray]]]:
        """probs: (B, T, C) posteriors (softmax output), numpy or a tensor on
        any device. Returns top-beam strings + per-char frame offsets,
        reference layout. n_best limits how many hypotheses are materialized
        per utterance (default: all beams, the ctcdecode contract)."""
        if isinstance(probs, torch.Tensor):
            probs = probs.detach().to("cpu", torch.float32).numpy()
        probs = np.asarray(probs, dtype=np.float32)
        b, t, c = probs.shape
        if isinstance(sizes, torch.Tensor):
            sizes = sizes.cpu().numpy()
        sizes = [t] * b if sizes is None else [int(s) for s in np.asarray(sizes)]

        # ctcdecode applies alpha/beta only through the LM scorer
        # (reference decoder.py:69-74): with no LM they must be inert
        alpha = self.alpha if self.lm is not None else 0.0
        beta = self.beta if self.lm is not None else 0.0

        def decode_one(i: int):
            if self._cpp is not None:
                # ctypes releases the GIL during the native call, so the
                # thread pool gives real parallelism (num_processes parity
                # with ctcdecode's worker threads, reference decoder.py:65)
                return self._cpp.decode(probs[i, :sizes[i]], alpha,
                                        beta, self.beam_width,
                                        self.cutoff_top_n, self.cutoff_prob)
            return self._decode_one(probs[i, :sizes[i]])

        if self._cpp is not None and self.num_processes > 1 and b > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(min(self.num_processes, b)) as pool:
                results = list(pool.map(decode_one, range(b)))
        else:
            results = [decode_one(i) for i in range(b)]

        all_strings: List[List[str]] = []
        all_offsets: List[List[np.ndarray]] = []
        for hyps in results:
            if n_best is not None:
                hyps = hyps[:n_best]
            strings = []
            offsets = []
            for ids, offs, _score in hyps:
                strings.append("".join(self.label_map.int_to_char[j] for j in ids))
                offsets.append(np.asarray(offs, np.int32))
            if not strings:
                strings, offsets = [""], [np.zeros((0,), np.int32)]
            all_strings.append(strings)
            all_offsets.append(offsets)
        return all_strings, all_offsets

    # ------------------------------------------------------------------

    def _lm_score(self, prefix: Tuple[int, ...]) -> float:
        """alpha * ln P(last word | history) + beta for the word just
        completed (prefix must end at a word boundary or utterance end).

        Without an LM this is 0: ctcdecode applies alpha/beta only through
        the LM scorer, so lm_path=None with beta != 0 must not add a
        per-word bonus (reference decoder.py:69-74)."""
        if self.lm is None:
            return 0.0
        chars = [self.label_map.int_to_char[i] for i in prefix]
        words = "".join(chars).split()
        if not words:
            return 0.0
        return self.alpha * self.lm.score_word_ln(words[-1], words[:-1]) + self.beta

    def _lm_score_node(self, node: "_TrieNode") -> float:
        """_lm_score over a trie node's prefix (walks parent pointers)."""
        if self.lm is None:
            return 0.0
        return self._lm_score(node.path()[0])

    def _decode_one(self, lp: np.ndarray) -> List[Tuple[Tuple[int, ...], Tuple[int, ...], float]]:
        t_dim, c_dim = lp.shape
        log_probs = np.log(np.maximum(lp, 1e-30))
        root = _TrieNode()
        root.p_b = 0.0
        beams: List[_TrieNode] = [root]
        for t in range(t_dim):
            row = log_probs[t]
            # candidate pruning: top cutoff_top_n chars, cumulative
            # cutoff_prob. The sort key is the 1e-30-CLIPPED raw
            # probability (not its float32 log, whose coarser quantization
            # manufactures ties the C++ twin would order by value), stable
            # argsort (ties by index), float64 accumulation of the raw
            # probabilities: bit-identical candidate sets and ordering
            # with the C++ twin, so tie-breaking stays deterministic
            # across the two implementations.
            order = np.argsort(-np.maximum(lp[t], 1e-30), kind="stable")
            if self.cutoff_prob < 1.0:
                cum = np.cumsum(lp[t].astype(np.float64)[order])
                n_keep = int(np.searchsorted(cum, self.cutoff_prob) + 1)
            else:
                n_keep = c_dim
            cand = order[: min(self.cutoff_top_n, n_keep, c_dim)]

            for prefix in beams:
                p_total = prefix.total()
                last = prefix.char
                for ci in cand:
                    p_c = float(row[ci])
                    if ci == self.blank_index:
                        prefix.p_b_cur = _logaddexp(prefix.p_b_cur,
                                                    p_total + p_c)
                        continue
                    if ci == last:
                        # same char: repeat collapses into prefix
                        prefix.p_nb_cur = _logaddexp(prefix.p_nb_cur,
                                                     prefix.p_nb + p_c)
                    # extension attempt — creates/updates the trie node
                    # (offset bookkeeping) even if it won't win a beam slot
                    ext = prefix.get_path_trie(ci, t, p_c)
                    if ci == last:
                        # extends only after a blank
                        score = (prefix.p_b + p_c
                                 if prefix.p_b != NEG_INF else NEG_INF)
                    else:
                        score = p_total + p_c
                    if ci == self.space_index and score != NEG_INF:
                        score += self._lm_score_node(prefix)
                    ext.p_nb_cur = _logaddexp(ext.p_nb_cur, score)

            # collect every live node (cur -> prev swap), prune to width,
            # and remove the rest (dead childless chains are deleted, so a
            # later re-creation starts fresh — ctcdecode remove())
            collected: List[_TrieNode] = []
            root.iterate_to_vec(collected)
            collected.sort(key=_TrieNode.total, reverse=True)
            beams = collected[: self.beam_width]
            for node in collected[self.beam_width:]:
                node.remove()

        # finalize: score trailing word
        results = []
        for node in beams:
            score = node.total()
            if (self.lm is not None and node.char >= 0
                    and node.char != self.space_index):
                score += self._lm_score_node(node)
            ids, offs = node.path()
            results.append((ids, offs, score))
        results.sort(key=lambda r: r[2], reverse=True)
        return results

    # reference-API helpers (decoder.py:76-101)
    def convert_to_strings(self, out, seq_len):
        results = []
        for b, batch in enumerate(out):
            utterances = []
            for p, utt in enumerate(batch):
                size = int(seq_len[b][p])
                utterances.append(
                    "".join(self.label_map.int_to_char[int(x)] for x in utt[:size])
                    if size > 0 else "")
            results.append(utterances)
        return results

    def convert_tensor(self, offsets, sizes):
        results = []
        for b, batch in enumerate(offsets):
            utterances = []
            for p, utt in enumerate(batch):
                size = int(sizes[b][p])
                utterances.append(np.asarray(utt[:size], np.int32) if size > 0
                                  else np.zeros((0,), np.int32))
            results.append(utterances)
        return results
