"""Word-level n-gram language model loaded from ARPA files, and the readers
of the DSLMBIN1/2 binaries.

A copy of dsjax/decode/lm.py (plain Python and numpy), so the port imports
nothing of dsjax; tests/test_torch_lm.py holds it equal to dsjax's.
Arbitrary-order ARPA with Katz backoff, the KenLM scorer behind the
reference's ctcdecode decoder (reference: decoder.py:69-74). Scores are kept
in log10 (ARPA's); :meth:`score_word_ln` gives natural logs for the decoder.
``MmapLM`` queries a binary through the native twin
(``decode.native_beam.CppLM``).
"""

from __future__ import annotations

import gzip
import math
from typing import Dict, List, Optional, Sequence, Tuple

LOG10_TO_LN = math.log(10.0)


class ArpaLM:
    def __init__(self, path: str):
        self.ngrams: List[Dict[Tuple[str, ...], Tuple[float, float]]] = []
        self.order = 0
        self._load(path)
        self.unk = ("<unk>",)
        self.has_unk = self.order >= 1 and self.unk in self.ngrams[0]

    def _load(self, path: str) -> None:
        opener = gzip.open if path.endswith(".gz") else open
        counts: List[int] = []
        with opener(path, "rt", encoding="utf8", errors="replace") as f:
            section = None
            cur: Optional[int] = None
            for raw in f:
                line = raw.strip()
                if not line:
                    continue
                if line == "\\data\\":
                    section = "data"
                    continue
                if line.startswith("\\") and line.endswith("-grams:"):
                    cur = int(line[1:line.index("-")])
                    while len(self.ngrams) < cur:
                        self.ngrams.append({})
                    section = "ngrams"
                    continue
                if line == "\\end\\":
                    break
                if section == "data" and line.startswith("ngram"):
                    counts.append(int(line.split("=")[1]))
                    continue
                if section == "ngrams" and cur is not None:
                    parts = line.split("\t")
                    if len(parts) < 2:
                        parts = line.split()
                        if len(parts) < cur + 1:
                            continue
                        logp = float(parts[0])
                        words = tuple(parts[1:cur + 1])
                        backoff = float(parts[cur + 1]) if len(parts) > cur + 1 else 0.0
                    else:
                        logp = float(parts[0])
                        words = tuple(parts[1].split())
                        backoff = float(parts[2]) if len(parts) > 2 else 0.0
                    self.ngrams[cur - 1][words] = (logp, backoff)
        self.order = len(self.ngrams)

    # -- queries ---------------------------------------------------------

    def score_word(self, word: str, context: Sequence[str]) -> float:
        """log10 P(word | context) with Katz backoff."""
        context = tuple(context)[-(self.order - 1):] if self.order > 1 else ()
        return self._score(tuple(context) + (word,))

    def _score(self, ngram: Tuple[str, ...]) -> float:
        n = len(ngram)
        if n == 0:
            return -99.0
        table = self.ngrams[n - 1] if n <= self.order else None
        if table is not None and ngram in table:
            return table[ngram][0]
        if n == 1:
            # OOV -> <unk> if present, else a large penalty
            if self.has_unk:
                return self.ngrams[0][self.unk][0]
            return -100.0
        # backoff: b(context) + P(word | shorter context)
        context = ngram[:-1]
        bo = 0.0
        ctx_table = self.ngrams[len(context) - 1] if len(context) <= self.order else None
        if ctx_table is not None and context in ctx_table:
            bo = ctx_table[context][1]
        return bo + self._score(ngram[1:])

    def score_word_ln(self, word: str, context: Sequence[str]) -> float:
        return self.score_word(word, context) * LOG10_TO_LN

    def score_sentence(self, words: Sequence[str], bos: bool = True,
                       eos: bool = True) -> float:
        """log10 P(sentence) for LM sanity tests."""
        context: List[str] = ["<s>"] if bos else []
        total = 0.0
        for w in words:
            total += self.score_word(w, context)
            context.append(w)
        if eos:
            total += self.score_word("</s>", context)
        return total


BINARY_MAGIC = b"DSLMBIN1"
BINARY_MAGIC2 = b"DSLMBIN2"  # v1 + vocab words + n-gram id arrays


def read_binary_lm_v2(path: str):
    """Parse a DSLMBIN2 file into numpy arrays (no C++ dependency).

    Returns a dict with: order, words (list[str], id order), unk_id (or
    None), uni_logp/uni_backoff (float32 [vocab]), and per order n>=2:
    ids[n] (uint32 [count, n]), logp[n]/backoff[n] (float32 [count]) —
    everything decode.lm_device needs to pack the on-device tables
    without re-parsing ARPA text."""
    import numpy as np

    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != BINARY_MAGIC2:
        raise ValueError("not a DSLMBIN2 file (v1 binaries carry only "
                         "one-way hashes; rebuild with "
                         "python -m dsjax_torch.build_lm_binary for device-beam use)")
    align8 = lambda x: (x + 7) & ~7
    order, vocab, unk = np.frombuffer(buf, np.uint32, 3, 8)
    off = 24
    counts = np.frombuffer(buf, np.uint64, int(order), off)
    off = align8(off + 8 * int(order))
    off += 8 * int(vocab)  # vocab fnv hashes (host lookup only)
    uni_logp = np.frombuffer(buf, np.float32, int(vocab), off)
    off += 4 * int(vocab)
    uni_backoff = np.frombuffer(buf, np.float32, int(vocab), off)
    off = align8(off + 4 * int(vocab))
    logp, backoff = {}, {}
    for n in range(2, int(order) + 1):
        cnt = int(counts[n - 1])
        off += 8 * cnt  # keys (host binary search only)
        logp[n] = np.frombuffer(buf, np.float32, cnt, off)
        off += 4 * cnt
        backoff[n] = np.frombuffer(buf, np.float32, cnt, off)
        off = align8(off + 4 * cnt)
    (nb,) = np.frombuffer(buf, np.uint64, 1, off)
    off += 8
    words = buf[off:off + int(nb)].decode("utf8").split("\n") if nb else []
    off = align8(off + int(nb))
    ids = {}
    for n in range(2, int(order) + 1):
        cnt = int(counts[n - 1])
        ids[n] = np.frombuffer(buf, np.uint32, cnt * n, off).reshape(cnt, n)
        off = align8(off + 4 * cnt * n)
    return {"order": int(order), "words": words,
            "unk_id": None if unk == 0xFFFFFFFF else int(unk),
            "uni_logp": uni_logp, "uni_backoff": uni_backoff,
            "ids": ids, "logp": logp, "backoff": backoff}


class MmapLM:
    """Python adapter over the mmap'd DSLMBIN1/2 binary LM (built with
    ``decode.native_beam.build_lm_binary``, the KenLM-binary equivalent).
    Queries go through the native library; same interface as ArpaLM."""

    def __init__(self, path: str):
        from dsjax_torch.decode.native_beam import CppLM

        self._c = CppLM(path)
        self.order = self._c.order

    def score_word(self, word: str, context: Sequence[str]) -> float:
        return self._c.score_word(word, list(context))

    def score_word_ln(self, word: str, context: Sequence[str]) -> float:
        return self.score_word(word, context) * LOG10_TO_LN


def load_word_lm(path: str):
    """ARPA text (optionally .gz) -> ArpaLM; DSLMBIN1/2 binary -> MmapLM."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head in (BINARY_MAGIC, BINARY_MAGIC2):
        return MmapLM(path)
    return ArpaLM(path)
