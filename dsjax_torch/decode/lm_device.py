"""Word n-gram LM packed into device hash tables, for LM fusion inside the
device beam search.

Counterpart of dsjax/decode/lm_device.py. The whole Katz-backoff scorer lives
on the posteriors' device, so the beam scan (``decode.beam_device``) adds
``alpha * ln P(word | context) + beta`` without a copy to the host:

* every n-gram order is one single-probe bucketed hash table: a key's one
  bucket of ``BUCKET`` slots, each slot two independent 32-bit check keys and
  the float32 log10-prob and backoff as bit patterns; all orders are packed
  bucket-major into one (n_buckets, BUCKET * 4) int32 tensor, so a probe is
  one contiguous row gather followed by a key-match select (collision odds
  about 2^-64 a pair);
* the decoder identifies words by two rolling hashes over their label
  indices; n-gram keys fold those hash pairs directly (no word-id lookup);
* scoring follows ``decode.lm.ArpaLM._score``: P(w | ctx) from the longest
  matching order, else backoff(ctx) + P(w | shorter ctx); an OOV word
  misses every table and scores the <unk> unigram (or -100 log10).

n-grams holding <s>, </s>, <unk> or a word the labels cannot spell are
dropped at build time, as dsjax drops them.

The numpy build is dsjax's, copied. The queries run in torch on any device.
dsjax computes hashes in uint32 with wraparound; torch has no complete
uint32 arithmetic on CUDA, so here hashes are int64 tensors holding values
in [0, 2^32), masked to 32 bits after every multiply and add (an int64
product may overflow, its low 32 bits stay exact) and shifted only when
masked and non-negative. The table keeps keys as int32 bit patterns; a
query turns its keys into the same patterns before comparing, and the
logp/backoff columns come out by ``.view(torch.float32)``, dsjax's bitcast.
tests/test_torch_lm_device.py holds the packed tables bit for bit and the
scores to 1e-6 against dsjax's.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from dsjax_torch.labels import LabelMap

Tensor = torch.Tensor

LOG10_TO_LN = math.log(10.0)

# word-char rolling-hash multipliers (over label indices, seed 1)
CHAR_A1 = np.uint32(1000003)
CHAR_A2 = np.uint32(10007)
CHAR_SEED = np.uint32(1)
# n-gram key fold multipliers (over word hash pairs)
FOLD_A1 = np.uint32(2654435761)
FOLD_A2 = np.uint32(2246822519)
FOLD_SEED = np.uint32(2166136261)
# bucket-index mixer (one bucket choice a key)
MIX1 = np.uint32(0x9E3779B1)
MIX2 = np.uint32(0x85EBCA6B)
EMPTY_KEY = np.uint32(0xFFFFFFFF)
# slots a bucket: one probe gathers one row of BUCKET * 4 int32 (256 B); the
# build starts at 4 keys a bucket and doubles the table until no bucket
# overflows
BUCKET = 16

# absent-context sentinel: a context slot whose h1 is EMPTY_KEY holds no
# word yet (real word hashes are remapped away from it)
CTX_ABSENT = EMPTY_KEY

_M32 = 0xFFFFFFFF


def _mix_index(k1, k2, mask):
    """Bucket index of a key (numpy uint32; the build's). A murmur3-style
    finalizer: ``& mask`` keeps the low bits, which the raw multiply-xor
    avalanches poorly."""
    h = (k1 * MIX1) ^ (k2 * MIX2)
    h = (h ^ (h >> np.uint32(16))) * np.uint32(0x7FEB352D)
    h = (h ^ (h >> np.uint32(15))) * np.uint32(0x846CA68B)
    return (h ^ (h >> np.uint32(16))) & mask


def _fold_ids(ids: np.ndarray, mult: np.uint32, reserve_empty: bool = False) -> np.ndarray:
    """Fold an (..., n) int array (word hash-pair columns) into one uint32
    key. ``reserve_empty`` keeps EMPTY_KEY out of the result: only the key1
    column, mirrored by the query's fold (``_fold_pairs``)."""
    h = np.full(ids.shape[:-1], FOLD_SEED, np.uint32)
    for j in range(ids.shape[-1]):
        h = h * mult + (ids[..., j].astype(np.int64) + 2).astype(np.uint32)
    if reserve_empty:
        h = np.where(h == EMPTY_KEY, h ^ np.uint32(1), h)
    return h


def _word_hash(label_ids) -> "tuple[int, int]":
    """Canonical (h1, h2) word identity: two rolling hashes over the word's
    label indices, h1 remapped away from EMPTY_KEY. The device beam keeps
    the same pair as characters append."""
    h1, h2 = int(CHAR_SEED), int(CHAR_SEED)
    for ci in label_ids:
        h1 = (h1 * int(CHAR_A1) + ci + 1) & _M32
        h2 = (h2 * int(CHAR_A2) + ci + 1) & _M32
    if h1 == int(EMPTY_KEY):
        h1 ^= 1
    return h1, h2


class HashTable:
    """A single-probe bucketed table on the host: data (n_buckets * BUCKET,
    4) uint32 = [key1, key2, bits of f32 val0, bits of f32 val1], every key
    in its one ``_mix_index`` bucket. ``depth`` is BUCKET."""

    def __init__(self, data: np.ndarray, depth: int = BUCKET):
        self.data = data
        self.depth = int(depth)

    @property
    def mask(self) -> int:
        """Bucket-index mask (n_buckets - 1)."""
        return len(self.data) // BUCKET - 1


def _build_table(k1: np.ndarray, k2: np.ndarray, v0: np.ndarray, v1: np.ndarray) -> HashTable:
    """Bulk single-probe bucket insertion: every key goes to its one bucket;
    the table doubles until no bucket holds more than BUCKET keys."""
    n = len(k1)
    k1 = np.asarray(k1, np.uint32)
    k2 = np.asarray(k2, np.uint32)
    v0u = np.asarray(v0, np.float32).view(np.uint32)
    v1u = np.asarray(v1, np.float32).view(np.uint32)
    n_buckets = 1 << max(3, int(np.ceil(np.log2(max(1, n) * 4 / BUCKET))))
    while True:
        mask = np.uint32(n_buckets - 1)
        cur = _mix_index(k1, k2, mask).astype(np.int64)
        counts = np.bincount(cur, minlength=n_buckets)
        if counts.max(initial=0) <= BUCKET:
            break
        n_buckets *= 2
    order = np.argsort(cur, kind="stable")
    seg_start = np.zeros(n_buckets, np.int64)
    seg_start[1:] = np.cumsum(counts)[:-1]
    slot = np.empty(n, np.int64)
    slot[order] = (np.arange(n) - seg_start[cur[order]]) + cur[order] * BUCKET
    data = np.zeros((n_buckets * BUCKET, 4), np.uint32)
    data[:, 0] = EMPTY_KEY
    data[slot, 0] = k1
    data[slot, 1] = k2
    data[slot, 2] = v0u
    data[slot, 3] = v1u
    return HashTable(data, BUCKET)


class PackedLM:
    """The device LM: every order's table concatenated bucket-major into one
    (n_buckets_total, BUCKET * 4) int32 tensor ``ngrams`` (the uint32 words
    as int32 bit patterns), with each table's first bucket (``bases``),
    bucket-index mask and probe depth; ``order`` and ``unk_logp`` (log10)."""

    def __init__(self, order: int, unk_logp: float, ngrams: Tensor, bases, masks, depths):
        self.order = int(order)
        self.unk_logp = float(unk_logp)
        self.ngrams = ngrams
        self.bases = tuple(int(b) for b in bases)
        self.masks = tuple(int(m) for m in masks)
        self.depths = tuple(int(d) for d in depths)

    def to(self, device) -> "PackedLM":
        """The same tables on ``device``."""
        return PackedLM(self.order, self.unk_logp, self.ngrams.to(device), self.bases,
                        self.masks, self.depths)


class DeviceNgramLM:
    """Packed word n-gram LM: the numpy build of the tables from an ARPA path
    (optionally .gz), a DSLMBIN2 binary or any object with ArpaLM's
    ``ngrams`` and ``order``; ``device(device)`` packs them into torch."""

    SPECIALS = ("<s>", "</s>", "<unk>")

    def __init__(self, lm, labels: Sequence[str], blank_index: int = 0):
        from dsjax_torch.decode.lm import BINARY_MAGIC2, ArpaLM

        if isinstance(lm, str):
            with open(lm, "rb") as f:
                head = f.read(8)
            if head == BINARY_MAGIC2:
                # pack straight from the binary, with no ARPA parse
                self._init_from_binary(lm, labels, blank_index)
                return
            lm = ArpaLM(lm)
        self.order = lm.order
        label_map = LabelMap(labels, blank_index)
        unk = lm.ngrams[0].get(("<unk>",)) if lm.order >= 1 else None
        self.unk_logp = float(unk[0]) if unk is not None else -100.0

        # word identities: (h1, h2) rolling hashes over label indices
        word_hash = {}
        for (w,) in lm.ngrams[0]:
            if w in self.SPECIALS:
                continue
            ids = [label_map.char_to_int.get(ch) for ch in w]
            if any(i is None for i in ids):
                continue  # not formable by the decoder -> never looked up
            word_hash[w] = _word_hash(ids)
        self.n_vocab = len(word_hash)

        # n-gram tables (hash pairs folded oldest -> newest)
        self.tables: List[HashTable] = []
        for n in range(1, self.order + 1):
            keys, logps, boffs = [], [], []
            for ngram, (logp, boff) in lm.ngrams[n - 1].items():
                if any(w in self.SPECIALS or w not in word_hash for w in ngram):
                    continue
                keys.append([c for w in ngram for c in word_hash[w]])
                logps.append(logp)
                boffs.append(boff)
            ids = (np.asarray(keys, np.int64).reshape(len(keys), 2 * n)
                   if keys else np.zeros((0, 2 * n), np.int64))
            self.tables.append(_build_table(
                _fold_ids(ids, FOLD_A1, reserve_empty=True), _fold_ids(ids, FOLD_A2),
                np.asarray(logps, np.float32), np.asarray(boffs, np.float32)))

    def _init_from_binary(self, path: str, labels: Sequence[str], blank_index: int) -> None:
        """The tables from a DSLMBIN2 binary: its dense word ids become the
        canonical hash pairs; n-grams with specials or words the labels
        cannot spell are dropped, as the ARPA build drops them."""
        from dsjax_torch.decode.lm import read_binary_lm_v2

        raw = read_binary_lm_v2(path)
        self.order = raw["order"]
        label_map = LabelMap(labels, blank_index)
        words = raw["words"]
        unk_id = raw["unk_id"]
        self.unk_logp = float(raw["uni_logp"][unk_id]) if unk_id is not None else -100.0

        wh1 = np.zeros(len(words), np.int64)
        wh2 = np.zeros(len(words), np.int64)
        formable = np.zeros(len(words), bool)
        for wid, w in enumerate(words):
            if w in self.SPECIALS:
                continue
            ids = [label_map.char_to_int.get(ch) for ch in w]
            if any(i is None for i in ids):
                continue
            wh1[wid], wh2[wid] = _word_hash(ids)
            formable[wid] = True
        self.n_vocab = int(formable.sum())

        def pair_cols(id_rows: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
            keep = formable[id_rows].all(axis=1)
            rows = id_rows[keep]
            cols = np.empty((len(rows), 2 * rows.shape[1]), np.int64)
            cols[:, 0::2] = wh1[rows]
            cols[:, 1::2] = wh2[rows]
            return cols, keep

        self.tables = []
        uni_ids = np.arange(len(words), dtype=np.int64)[:, None]
        cols, keep = pair_cols(uni_ids)
        self.tables.append(_build_table(
            _fold_ids(cols, FOLD_A1, reserve_empty=True), _fold_ids(cols, FOLD_A2),
            raw["uni_logp"].astype(np.float32)[keep], raw["uni_backoff"].astype(np.float32)[keep]))
        for n in range(2, self.order + 1):
            cols, keep = pair_cols(raw["ids"][n].astype(np.int64))
            self.tables.append(_build_table(
                _fold_ids(cols, FOLD_A1, reserve_empty=True), _fold_ids(cols, FOLD_A2),
                raw["logp"][n].astype(np.float32)[keep],
                raw["backoff"][n].astype(np.float32)[keep]))

    def packed(self) -> np.ndarray:
        """All tables bucket-major: (n_buckets_total, BUCKET * 4) uint32."""
        return np.concatenate([t.data.reshape(-1, BUCKET * 4) for t in self.tables], axis=0)

    def device(self, device) -> PackedLM:
        """The tables as one bucket-major int32 tensor on ``device``: a table
        row is one whole bucket, so every probe is one row gather."""
        bases, off = [], 0
        for t in self.tables:
            bases.append(off)
            off += len(t.data) // BUCKET
        ngrams = torch.from_numpy(self.packed().view(np.int32)).to(device)
        return PackedLM(self.order, self.unk_logp, ngrams, bases,
                        [t.mask for t in self.tables], [t.depth for t in self.tables])


# ----------------------------------------------------------------------
# queries on a PackedLM, in torch; hashes are int64 tensors in [0, 2^32)
# ----------------------------------------------------------------------


def _mix_index_t(k1: Tensor, k2: Tensor, mask: int) -> Tensor:
    """``_mix_index`` on int64 tensors holding uint32 values, bit for bit."""
    h = ((k1 * int(MIX1)) & _M32) ^ ((k2 * int(MIX2)) & _M32)
    h = ((h ^ (h >> 16)) * 0x7FEB352D) & _M32
    h = ((h ^ (h >> 15)) * 0x846CA68B) & _M32
    return (h ^ (h >> 16)) & mask


def _bits_i32(k: Tensor) -> Tensor:
    """An int64 tensor of uint32 values as the int32 bit patterns the
    packed table stores."""
    return (((k + 0x80000000) & _M32) - 0x80000000).to(torch.int32)


def _fold_pairs(pairs):
    """Fold a list of (h1, h2) word-identity pairs (oldest -> newest) into
    keys, as the build's ``_fold_ids`` over interleaved pair columns (h1
    remapped away from EMPTY_KEY). ``valid`` requires every pair's h1 to
    differ from the CTX_ABSENT sentinel."""
    h1 = torch.full(pairs[0][0].shape, int(FOLD_SEED), dtype=torch.int64,
                    device=pairs[0][0].device)
    h2 = h1
    valid = torch.ones(pairs[0][0].shape, dtype=torch.bool, device=h1.device)
    for a, b in pairs:
        for u in ((a + 2) & _M32, (b + 2) & _M32):
            h1 = (h1 * int(FOLD_A1) + u) & _M32
            h2 = (h2 * int(FOLD_A2) + u) & _M32
        valid = valid & (a != int(CTX_ABSENT))
    h1 = torch.where(h1 == int(EMPTY_KEY), h1 ^ 1, h1)
    return h1, h2, valid


def _probe_packed(lm: PackedLM, probes):
    """Each probe (table index, k1, k2, valid) as one row gather of its
    bucket -> (found, val0, val1). At most one slot of a bucket matches
    (keys are unique in a table), so a masked sum selects it, as dsjax's."""
    out = []
    for ti, k1, k2, valid in probes:
        rows = lm.ngrams[_mix_index_t(k1, k2, lm.masks[ti]) + lm.bases[ti]]  # (..., BUCKET*4)
        r = rows.reshape(rows.shape[:-1] + (BUCKET, 4))
        hit = (r[..., 0] == _bits_i32(k1)[..., None]) & (r[..., 1] == _bits_i32(k2)[..., None])
        found = hit.any(-1) & valid

        def pick(col):
            return torch.where(hit, r[..., col].view(torch.float32), 0.0).sum(-1)

        out.append((found, pick(2), pick(3)))
    return out


def score_word_ln(lm: PackedLM, cur1: Tensor, cur2: Tensor, ctx: Tensor, ctx_bos=None):
    """ln P(word | context), the word's canonical identity pair and the
    backoff carries a beam adopts if the word completes.

    cur1/cur2: the word's rolling char hashes (int64, any batch shape);
    ctx: (..., order-1, 2) int64 context word hash pairs, oldest -> newest
    (h1 == CTX_ABSENT where the history is shorter). ctx_bos: (...,
    order-1) float32 carried context backoffs, ctx_bos[..., j] the log10
    backoff (0 where absent) of ctx's length-(j+1) suffix; when None they
    are probed here. With them carried, a query is ``order`` independent
    one-row probes, with no vocabulary lookup: the unigram probe's hit is
    the in-vocabulary test.

    Returns (score_ln float32, pair (..., 2) int64, new_bos (..., order-1)
    float32): new_bos[..., j] is the backoff of (ctx[-j:] + word), the
    carries of a beam that commits this word."""
    cur1 = torch.where(cur1 == int(EMPTY_KEY), cur1 ^ 1, cur1)
    me = (cur1, cur2)
    probes = []                                    # the table index is static
    k1, k2, v = _fold_pairs([me])
    probes.append((0, k1, k2, v))
    for n in range(2, lm.order + 1):
        ctx_n = [(ctx[..., -(j + 1), 0], ctx[..., -(j + 1), 1]) for j in range(n - 2, -1, -1)]
        if ctx_bos is None:
            kc1, kc2, vc = _fold_pairs(ctx_n)      # backoff(context)
            probes.append((n - 2, kc1, kc2, vc))
        kf1, kf2, vf = _fold_pairs(ctx_n + [me])
        probes.append((n - 1, kf1, kf2, vf))
    res = _probe_packed(lm, probes)

    if ctx_bos is None:
        fulls = [res[0]] + [res[i + 1] for i in range(1, len(res), 2)]
        ctx_bo_vals = [torch.where(res[i][0], res[i][2], 0.0) for i in range(1, len(res), 2)]
    else:
        fulls = res
        ctx_bo_vals = [ctx_bos[..., j] for j in range(lm.order - 1)]

    f1, p1, _ = fulls[0]
    s = torch.where(f1, p1, torch.tensor(lm.unk_logp, dtype=torch.float32, device=p1.device))
    for n in range(2, lm.order + 1):
        f, p, _ = fulls[n - 1]
        s = torch.where(f, p, ctx_bo_vals[n - 2] + s)
    # backoff carries of the would-be new context (every suffix ends in the
    # word): the full probe of order j gives the suffix of length j
    if lm.order > 1:
        new_bos = torch.stack([torch.where(fulls[j][0], fulls[j][2], 0.0)
                               for j in range(lm.order - 1)], dim=-1)
    else:
        new_bos = torch.zeros(cur1.shape + (0,), dtype=torch.float32, device=cur1.device)
    pair = torch.stack([cur1, cur2], dim=-1)
    return s * LOG10_TO_LN, pair, new_bos
