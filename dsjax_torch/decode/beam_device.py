"""Batched CTC prefix beam search on the posteriors' device, with optional
n-gram LM fusion.

Counterpart of dsjax/decode/beam_device.py. The search runs over time with
(B, W) beam state: each beam keeps (p_blank, p_nonblank, last_char) and two
independent rolling hashes of its collapsed prefix and of that prefix
minus its last char. Every step the pool is {stay} + {extend with each
class}; live beams hold pairwise-distinct prefixes, so the only candidates
that collapse to the same string are extend(q, c) and stay(r) with
prefix_r = prefix_q + c. An O(W^2) join of parent-prefix hashes against
beam hashes finds them exactly (collision odds about 2^-64), absorbs the
extend's mass into the stay and kills the extend; the top-W of the pool
[W stays | W*C extends] survive. Emission history is kept as per-step
backpointers (parent slot, emitted char) and read back by
``ops.beam.backtrack`` (one kernel on the card; ``_backtrack`` on CPU
tensors).

Two routes run the scan, both on the card for CUDA tensors:
  * ``_beam_scan``: the steps in PyTorch, with each step's top-W selection
    by K6 (``ops.topk.topk``, ``csrc/topk.cu``), which breaks ties to the
    lower pool index as ``lax.top_k`` does;
  * K7 (``ops.beam.fused_beam_scan``, ``csrc/beam_scan.cu``): the whole
    no-LM, no-pruning scan in one kernel, bit for bit the same outputs
    (K7 compares the floats, as dsjax's fused scan does, so the two
    routes could part only where a -0.0 and a +0.0 score tie).
    ``DeviceBeamDecoder`` takes it when ``DSJAX_FUSED_BEAM=1`` (re-read on
    every decode) and the decode can run there (``_fused_ok``). Both routes
    return a carry of the same structure, so a stream may switch between
    chunks.
On CPU tensors the same code runs with the plain top-k, which is how the
tests hold it against dsjax.

LM fusion (``lm``, a ``decode.lm_device.PackedLM`` on the posteriors'
device): every beam also carries rolling hashes of its current partial word,
the hash pairs of its last order-1 words and their backoffs, so the scan
adds ``alpha * ln P(word | context) + beta`` on every space extension (with
no partial word, the previous word's bonus again) and the trailing word's
bonus to the final totals, the scoring of the host ``decode.beam``
decoder. An LM decode always takes ``_beam_scan``, K6 selecting every frame
on the card; K7 takes no LM. Its carry is ``(core, lm_state)``, the core
being the no-LM scan's 7-tuple.

Exactness: logaddexp is written as max + log1p(exp(-|a - b|)), jnp's
formula; the prefix hashes are int32 and wrap modulo 2^32
(``h * 1000003 + c + 1``), as dsjax's do. The LM word hashes are uint32 in
dsjax, int64 holding values in [0, 2^32) here (``decode.lm_device``).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dsjax_torch.decode import lm_device
from dsjax_torch.labels import LabelMap
from dsjax_torch.ops import beam as beam_ops
from dsjax_torch.ops import topk as topk_ops
from dsjax_torch.trace import span

Tensor = torch.Tensor

NEG = -1e30
_P1 = 1000003
_P2 = 10007
_M32 = 0xFFFFFFFF


def _logaddexp(a: Tensor, b: Tensor) -> Tensor:
    """jnp.logaddexp's formula; neither operand is NaN here."""
    return torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))


def _init_carry(b_dim: int, w: int, device) -> Tuple[Tensor, ...]:
    """(p_b, p_nb, last, h1, h2, ph1, ph2), each (B, W): only beam 0 alive,
    holding the empty prefix (hash 1, no parent: 0)."""
    p_b = torch.full((b_dim, w), NEG, dtype=torch.float32, device=device)
    p_b[:, 0] = 0.0
    i32 = dict(dtype=torch.int32, device=device)
    return (p_b, torch.full((b_dim, w), NEG, dtype=torch.float32, device=device),
            torch.full((b_dim, w), -1, **i32), torch.ones((b_dim, w), **i32),
            torch.ones((b_dim, w), **i32), torch.zeros((b_dim, w), **i32),
            torch.zeros((b_dim, w), **i32))


def _init_lm_state(b_dim: int, w: int, order: int, device) -> Tuple[Tensor, ...]:
    """(cur1, cur2, ctx, in_word, memo, ctx_bos): the partial word's two
    hashes (seed 1), the context word hash pairs interleaved [h1, h2] *
    max(1, order-1), oldest first (all absent), whether a word is open, the
    last completed word's bonus, and the carried backoffs of the context's
    suffixes (0 = absent, right for the empty context)."""
    cw, nbo = max(1, order - 1), max(0, order - 1)
    i64 = dict(dtype=torch.int64, device=device)
    return (torch.full((b_dim, w), int(lm_device.CHAR_SEED), **i64),
            torch.full((b_dim, w), int(lm_device.CHAR_SEED), **i64),
            torch.full((b_dim, w, 2 * cw), int(lm_device.CTX_ABSENT), **i64),
            torch.zeros((b_dim, w), dtype=torch.bool, device=device),
            torch.zeros((b_dim, w), dtype=torch.float32, device=device),
            torch.zeros((b_dim, w, nbo), dtype=torch.float32, device=device))


def _lm_bonus(lm, lm_state: Tuple[Tensor, ...], alpha: float, beta: float):
    """The bonus of completing each beam's partial word now, alpha * ln
    P(word | context) + beta, and the backoff carries a beam committing the
    word adopts."""
    cur1, cur2, ctx, _, _, ctx_bos = lm_state
    cw = ctx.shape[-1] // 2
    score_ln, _, new_bos = lm_device.score_word_ln(
        lm, cur1, cur2, ctx.reshape(ctx.shape[:-1] + (cw, 2)), ctx_bos)
    return alpha * score_ln + beta, new_bos


def _keep_mask(lp_t: Tensor, cutoff_top_n: int, cutoff_prob: float) -> Tensor:
    """(B, C) candidate mask of one frame: the top cutoff_top_n classes and,
    when cutoff_prob < 1, the smallest head of the sorted distribution that
    reaches cutoff_prob (ties to the lower class, a stable sort)."""
    order = torch.argsort(-lp_t, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    keep = rank < cutoff_top_n
    if cutoff_prob < 1.0:
        cum = torch.cumsum(torch.exp(torch.gather(lp_t, 1, order)), dim=1)
        n_keep = (cum < cutoff_prob).sum(dim=1, keepdim=True) + 1
        keep &= rank < n_keep
    return keep


def _fusable(b_dim: int, c_dim: int, beam_width: int, cutoff_top_n: int,
             cutoff_prob: float, lm=None) -> bool:
    """Whether K7 takes this decode: no LM, no pruning, W <= 128, C <= 30."""
    return (lm is None and cutoff_top_n >= c_dim and cutoff_prob >= 1.0
            and beam_width <= beam_ops.MAX_WIDTH and c_dim <= beam_ops.MAX_CLASSES
            and b_dim > 0)


def _beam_scan(log_probs: Tensor, sizes: Tensor, beam_width: int, blank: int,
               cutoff_top_n: int = 10 ** 9, cutoff_prob: float = 1.0,
               carry0=None, fused: bool = False, top_k=None, lm=None,
               alpha: float = 0.0, beta: float = 0.0, space: int = -1):
    """log_probs (B, T, C) -> (backptr (T, B, W) i32, emit (T, B, W) i32,
    (h1_seq, h2_seq) (T, B, W) i32, totals (B, W) f32, carry).

    ``carry0`` resumes from a previous call's carry (streaming: decoding
    chunk by chunk is exactly the one-shot decode of the concatenated
    posteriors). ``fused`` sends a decode K7 can take (``_fusable``) to it.
    ``top_k`` replaces the selection function
    (default ``ops.topk.topk``; the plain version of K7 passes K7's own
    float-order selection).

    ``lm`` (a PackedLM on the posteriors' device) fuses the LM: extending a
    beam with ``space`` adds ``alpha * ln P(word | context) + beta`` for the
    word it completes, and the totals include the trailing word's bonus
    (the returned carry does not, so a stream can go on). The carry is then
    (the 7-tuple core, the LM state of ``_init_lm_state``)."""
    b_dim, t_dim, c_dim = log_probs.shape
    w = beam_width
    sizes = torch.as_tensor(sizes, dtype=torch.int32, device=log_probs.device)
    if fused and _fusable(b_dim, c_dim, w, cutoff_top_n, cutoff_prob, lm):
        return beam_ops.fused_beam_scan(log_probs, sizes, w, blank, carry0=carry0)[:5]
    top_k = top_k or topk_ops.topk
    device = log_probs.device
    lp = log_probs.to(torch.float32).transpose(0, 1)      # (T, B, C)
    if lm is None:
        core0, lm_state = carry0, None
    else:
        core0, lm_state = (carry0 if carry0 is not None
                           else (None, _init_lm_state(b_dim, w, lm.order, device)))
    p_b, p_nb, last, h1, h2, ph1, ph2 = (core0 if core0 is not None
                                         else _init_carry(b_dim, w, device))
    classes = torch.arange(c_dim, device=device, dtype=torch.int32)
    slot = torch.arange(w, device=device, dtype=torch.int32)[None, :]
    sentinel = -(slot + 2)
    prune = cutoff_top_n < c_dim or cutoff_prob < 1.0
    bps, ems, h1s, h2s = [], [], [], []
    for t in range(t_dim):
        lp_t = lp[t]
        total = _logaddexp(p_b, p_nb)                     # (B, W)
        # a class outside the kept set contributes nothing this frame,
        # blank included (its stay mass is dropped too)
        keep = _keep_mask(lp_t, cutoff_top_n, cutoff_prob) if prune else None

        # stay: emit blank (from total) or repeat the last char (from p_nb)
        last_c = last.clamp_min(0).long()
        lp_last = torch.gather(lp_t, 1, last_c)
        stay_b = total + lp_t[:, blank:blank + 1]
        stay_nb = torch.where(last >= 0, p_nb + lp_last, NEG)
        if keep is not None:
            stay_b = torch.where(keep[:, blank:blank + 1], stay_b, NEG)
            last_kept = torch.gather(keep, 1, last_c)
            stay_nb = torch.where(last_kept, stay_nb, NEG)

        # extend with char c: from total if c != last, else from p_b only
        from_score = torch.where(last[:, :, None] == classes, p_b[:, :, None],
                                 total[:, :, None])
        ext = from_score + lp_t[:, None, :]               # (B, W, C)
        ext[:, :, blank] = NEG
        if keep is not None:
            ext = torch.where(keep[:, None, :], ext, NEG)

        if lm is not None:
            # the word-boundary bonus of every space extension: the partial
            # word scored against the beam's history; with no partial word,
            # the previous word's bonus again (the host decoder splits the
            # prefix into words, skipping empty ones)
            cur1, cur2, ctx, in_word, memo, ctx_bos = lm_state
            bonus_new, new_bos_cand = _lm_bonus(lm, lm_state, alpha, beta)
            has_words = ctx[..., -2] != int(lm_device.CTX_ABSENT)
            bonus = torch.where(in_word, bonus_new, torch.where(has_words, memo, 0.0))
            ext[:, :, space] = ext[:, :, space] + bonus

        # merge: hj[b, r, q] when extend(q, last_r) collapses to stay r's
        # prefix
        live = total > NEG / 2
        hj = ((ph1[:, :, None] == h1[:, None, :]) & (ph2[:, :, None] == h2[:, None, :])
              & (last[:, :, None] >= 0) & live[:, :, None] & live[:, None, :])
        # e_at[b, r, q] = ext[b, q, last_r] in closed form
        same = last[:, :, None] == last[:, None, :]
        e_at = torch.where(same, p_b[:, None, :], total[:, None, :]) + lp_last[:, :, None]
        if keep is not None:
            e_at = torch.where(last_kept[:, :, None], e_at, NEG)
        if lm is not None:
            # the space column of ext carries the bonus: mirror it for stays
            # whose last char is the space (adding 0.0 elsewhere, as dsjax)
            e_at = e_at + torch.where((last == space)[:, :, None], bonus[:, None, :], 0.0)
        # no match fills NEG, which also clamps a decayed p_nb
        absorbed = torch.where(hj, e_at, NEG).amax(dim=2)
        nb_stay = _logaddexp(stay_nb, absorbed)
        # killed[b, q, c] = any_r hj[b, r, q] and last_r == c (exact 0/1
        # counts through one batched product); last_r = -1 matches no class
        onehot = (last[:, :, None] == classes).float()
        killed = torch.bmm(hj.float().transpose(1, 2), onehot) > 0.5
        ext = torch.where(killed, NEG, ext)

        # pool [W stays | W*C extends]; winners rebuild from the pool index
        cand = torch.cat([_logaddexp(stay_b, nb_stay), ext.reshape(b_dim, -1)], dim=1)
        top_scores, top_idx = top_k(cand, w)
        sel_stay = top_idx < w
        char = torch.where(sel_stay, -1, (top_idx - w) % c_dim).to(torch.int32)
        parent = torch.where(sel_stay, top_idx, (top_idx - w) // c_dim).to(torch.int32)
        # a stay inherits its parent's fields; an extend's p_nb is its pool
        # score, its p_b is empty and its hashes roll on from the parent's
        idx = parent.long()
        g_sb, g_nb, g_last, g_h1, g_h2, g_ph1, g_ph2 = (
            torch.gather(a, 1, idx) for a in (stay_b, nb_stay, last, h1, h2, ph1, ph2))
        new_p_b = torch.where(sel_stay, g_sb, NEG)
        new_p_nb = torch.where(sel_stay, g_nb, top_scores)
        new_last = torch.where(sel_stay, g_last, char)
        # int32 products wrap modulo 2^32, as dsjax's do
        new_h1 = torch.where(sel_stay, g_h1, g_h1 * _P1 + char + 1)
        new_h2 = torch.where(sel_stay, g_h2, g_h2 * _P2 + char + 1)
        new_ph1 = torch.where(sel_stay, g_ph1, g_h1)
        new_ph2 = torch.where(sel_stay, g_ph2, g_h2)

        # dead slots carry no mass and hashes that match no real prefix
        dead = top_scores <= NEG / 2
        new_h1, new_h2, new_ph1, new_ph2 = (torch.where(dead, sentinel, a)
                                            for a in (new_h1, new_h2, new_ph1, new_ph2))
        new_p_b = torch.where(dead, NEG, new_p_b)
        new_p_nb = torch.where(dead, NEG, new_p_nb)

        # frames past each utterance's length leave the state unchanged
        act = (t < sizes)[:, None]
        if lm is not None:
            # the word state is a function of the selected prefix: rebuilt
            # from the parent's payloads and the char
            p_cur1, p_cur2, p_in, p_memo, p_bonus_new = (
                torch.gather(a, 1, idx) for a in (cur1, cur2, in_word, memo, bonus_new))
            p_ctx, p_bos, p_newbos = (
                torch.gather(a, 1, idx[..., None].expand(-1, -1, a.shape[-1]))
                for a in (ctx, ctx_bos, new_bos_cand))
            is_stay = char < 0
            is_space = char == space
            cu = char.clamp_min(0).long() + 1
            seed = int(lm_device.CHAR_SEED)
            new_cur1 = torch.where(is_stay, p_cur1, torch.where(
                is_space, seed, (p_cur1 * int(lm_device.CHAR_A1) + cu) & _M32))
            new_cur2 = torch.where(is_stay, p_cur2, torch.where(
                is_space, seed, (p_cur2 * int(lm_device.CHAR_A2) + cu) & _M32))
            new_in = torch.where(is_stay, p_in, ~is_space)
            complete = is_space & p_in                      # a word just closed
            # the committed word's canonical pair: h1 away from the sentinel
            w1 = torch.where(p_cur1 == int(lm_device.EMPTY_KEY), p_cur1 ^ 1, p_cur1)
            new_ctx = torch.where(complete[..., None],
                                  torch.cat([p_ctx[..., 2:], w1[..., None], p_cur2[..., None]],
                                            -1), p_ctx)
            new_memo = torch.where(complete, p_bonus_new, p_memo)
            # the completed word's own probe backoffs are the new carries
            new_bos = torch.where(complete[..., None], p_newbos, p_bos)
            lm_state = tuple(
                torch.where(act[..., None] if n.dim() == 3 else act, n, o) for n, o in zip(
                    (new_cur1, new_cur2, new_ctx, new_in, new_memo, new_bos), lm_state))
        p_b, p_nb, last, h1, h2, ph1, ph2 = (
            torch.where(act, n, o) for n, o in zip(
                (new_p_b, new_p_nb, new_last, new_h1, new_h2, new_ph1, new_ph2),
                (p_b, p_nb, last, h1, h2, ph1, ph2)))
        bps.append(torch.where(act, parent, slot))
        ems.append(torch.where(act, char, -1))
        h1s.append(h1)
        h2s.append(h2)
    carry = (p_b, p_nb, last, h1, h2, ph1, ph2)
    totals = _logaddexp(p_b, p_nb)
    if lm is not None:
        # the trailing word's bonus (a prefix not ending in a space gains one
        # more word); the carry stays without it
        trailing, _ = _lm_bonus(lm, lm_state, alpha, beta)
        totals = totals + torch.where(lm_state[3], trailing, 0.0)
        carry = (carry, lm_state)

    def seq(xs):
        return (torch.stack(xs) if xs
                else torch.zeros((0, b_dim, w), dtype=torch.int32, device=device))

    return seq(bps), seq(ems), (seq(h1s), seq(h2s)), totals, carry


def _backtrack(backptr: Tensor, emit: Tensor, order: Tensor) -> Tuple[Tensor, Tensor]:
    """Chase parent pointers: (T, B, W) backptr/emit and the (B, K) slots
    to follow -> (T, B, K) emitted chars (int16, -1 = none) and the (B, K)
    start slots at t = 0. The plain version of the backtrack kernel
    (``ops.beam.backtrack``, which the decoders call): two gathers a frame."""
    slot = order.long()
    rev = [None] * backptr.shape[0]
    for t in reversed(range(backptr.shape[0])):
        rev[t] = torch.gather(emit[t], 1, slot).to(torch.int16)
        slot = torch.gather(backptr[t], 1, slot).long()
    chars = (torch.stack(rev) if rev
             else torch.zeros((0,) + tuple(order.shape), dtype=torch.int16, device=order.device))
    return chars, slot.to(torch.int32)


def _decode_device(log_probs: Tensor, sizes: Tensor, beam_width: int, blank: int,
                   n_best: int, want_hists: bool = False, cutoff_top_n: int = 10 ** 9,
                   cutoff_prob: float = 1.0, fused: bool = False, lm=None, alpha: float = 0.0,
                   beta: float = 0.0, space: int = -1):
    """Scan -> rank the beams by total score -> backtrack the top n_best:
    ((T, B, n_best) int16 chars, the (h1, h2) histories when asked for,
    (B, n_best) totals). The scan route ranks with K6 (T + 1 launches a
    decode); K7 ranks its own final beams (one launch, no K6). Either route
    then backtracks in one launch (``ops.beam.backtrack``)."""
    b_dim, _, c_dim = log_probs.shape
    if fused and _fusable(b_dim, c_dim, beam_width, cutoff_top_n, cutoff_prob, lm):
        backptr, emit, hists, _, _, (ranked, order) = beam_ops.fused_beam_scan(
            log_probs, sizes, beam_width, blank)
        top_totals, order = ranked[:, :n_best], order[:, :n_best]
    else:
        backptr, emit, hists, totals, _ = _beam_scan(
            log_probs, sizes, beam_width, blank, cutoff_top_n=cutoff_top_n,
            cutoff_prob=cutoff_prob, lm=lm, alpha=alpha, beta=beta, space=space)
        # ties resolve to the lower slot index, as np.argsort(-scores)
        top_totals, order = topk_ops.topk(totals, n_best)
    rev, _ = beam_ops.backtrack(backptr, emit, order)
    return rev, (hists if want_hists else None), top_totals


def _decode_chunk_device(log_probs: Tensor, sizes: Tensor, beam_width: int, blank: int,
                         cutoff_top_n: int = 10 ** 9, cutoff_prob: float = 1.0, carry0=None,
                         fused: bool = False, lm=None, alpha: float = 0.0, beta: float = 0.0,
                         space: int = -1):
    """Streaming twin of _decode_device: scan one chunk from carry0, then
    backtrack every beam slot to the chunk start; the best slot is the
    first maximum of the totals."""
    backptr, emit, _, totals, carry = _beam_scan(
        log_probs, sizes, beam_width, blank, cutoff_top_n=cutoff_top_n,
        cutoff_prob=cutoff_prob, carry0=carry0, fused=fused, lm=lm, alpha=alpha, beta=beta,
        space=space)
    order = torch.arange(beam_width, dtype=torch.int32, device=log_probs.device)
    rev, start = beam_ops.backtrack(backptr, emit, order[None].expand(log_probs.shape[0], -1))
    return rev, start, torch.argmax(totals, dim=1), carry


class _BeamStreamState:
    """Carried streaming-beam state: the scan carry, the per-beam hypothesis
    strings (host side) and the current best text."""

    __slots__ = ("carry", "strings", "text")

    def __init__(self, carry, strings, text):
        self.carry = carry
        self.strings = strings
        self.text = text


class DeviceBeamDecoder:
    """Batched beam search on the posteriors' device, with optional LM fusion.

    ``decode`` has the contract of GreedyDecoder and dsjax's decoders:
    (strings, offsets), all beams per utterance by default (``n_best``
    caps them). ``decode_chunk`` streams one utterance chunk by chunk with
    the full search state carried, the LM word state included. With
    ``lm_path`` (ARPA or DSLMBIN2) the LM is packed once
    (``decode.lm_device``) and moved to the posteriors' device at their
    first decode there; ``shared_lm`` takes tables packed already (the
    tuner's workers share one set); ``reset_params`` changes alpha and beta
    without rebuilding them."""

    # evaluate() may hand device tensors straight in
    accepts_device_arrays = True

    def __init__(self, labels: Sequence[str], beam_width: int = 16, blank_index: int = 0,
                 lm_path: Optional[str] = None, alpha: float = 0.0, beta: float = 0.0,
                 cutoff_top_n: int = 10 ** 9, cutoff_prob: float = 1.0, shared_lm=None,
                 ctc_offsets: bool = False):
        self.label_map = LabelMap(labels, blank_index)
        self.labels = list(labels)
        self.beam_width = beam_width
        self.blank_index = blank_index
        self.alpha = alpha
        self.beta = beta
        self.cutoff_top_n = cutoff_top_n
        self.cutoff_prob = cutoff_prob
        # ctc_offsets=True: report ctcdecode-parity timesteps, rebuilt on
        # the host from the streamed beam-hash history and the posteriors
        # (one (T, B, W) x2 and one (B, T, C) device-to-host copy a decode);
        # False: emission frames, no extra copy
        self.ctc_offsets = ctc_offsets
        self._lm = None
        if (lm_path or shared_lm is not None) and " " not in self.labels:
            raise ValueError("LM fusion needs a space label (word boundaries)")
        if shared_lm is not None:
            self._lm = shared_lm
        elif lm_path:
            self._lm = lm_device.DeviceNgramLM(lm_path, labels, blank_index).device("cpu")
        self._lm_placed = self._lm           # the tables on the last decode's device

    def _lm_kwargs(self, lp: Tensor) -> dict:
        """The scan's LM arguments, the tables on the posteriors' device
        (copied there at the first decode on it)."""
        if self._lm is None:
            return {}
        if self._lm_placed.ngrams.device != lp.device:
            self._lm_placed = self._lm.to(lp.device)
        return dict(lm=self._lm_placed, alpha=float(self.alpha), beta=float(self.beta),
                    space=self.label_map.space_index)

    def reset_params(self, alpha: float, beta: float) -> None:
        """LM weight update without rebuilding the tables (tuner parity)."""
        self.alpha = alpha
        self.beta = beta

    def _fused_ok(self, lp: Tensor) -> bool:
        """Whether this decode may take K7: DSJAX_FUSED_BEAM=1, read here on
        every decode, a decode the kernel takes (``_fusable``: no LM among
        its conditions), and CUDA tensors."""
        return (os.environ.get("DSJAX_FUSED_BEAM") == "1" and lp.is_cuda
                and _fusable(lp.shape[0], lp.shape[-1], self.beam_width, self.cutoff_top_n,
                             self.cutoff_prob, self._lm))

    @staticmethod
    def _log(probs) -> Tensor:
        probs = torch.as_tensor(probs)
        return torch.log(torch.clamp_min(probs.to(torch.float32), 1e-30))

    def decode_chunk(self, probs, state: Optional[_BeamStreamState] = None):
        """Feed one (1, T, C) posterior chunk; returns (best_text, new_state),
        with new_state.strings holding every beam's hypothesis."""
        lp = self._log(probs)
        if lp.dim() == 2:
            lp = lp[None]
        b, t = lp.shape[0], lp.shape[1]
        assert b == 1, "decode_chunk streams one utterance"
        carry0 = state.carry if state is not None else None
        rev_d, start_d, best_d, carry = _decode_chunk_device(
            lp, torch.full((b,), t, dtype=torch.int32, device=lp.device), self.beam_width,
            self.blank_index, cutoff_top_n=self.cutoff_top_n, cutoff_prob=self.cutoff_prob,
            carry0=carry0, fused=self._fused_ok(lp), **self._lm_kwargs(lp))
        rev = rev_d[:, 0].cpu().numpy()                  # (T, W) int16
        slot = start_d[0].cpu().numpy()
        old = state.strings if state is not None else [""] * self.beam_width
        strings = []
        for p in range(self.beam_width):
            chars = rev[:, p][rev[:, p] >= 0]
            strings.append(old[slot[p]] + "".join(self.label_map.int_to_char[int(c)]
                                                  for c in chars))
        best = strings[int(best_d[0])]
        return best, _BeamStreamState(carry, strings, best)

    def decode(self, probs, sizes=None, n_best: Optional[int] = None,
               with_scores: bool = False):
        """(strings, offsets); with_scores=True appends the (B, n_best) total
        log-scores of the hypotheses (the trailing word's LM bonus
        included).

        The call is a ``beam.decode`` span (``dsjax_torch.trace``) of three
        parts: ``beam.search`` issues the search, ``beam.fetch`` waits for
        its characters to reach the host (behind whatever the device's
        stream holds before it), ``beam.strings`` builds the strings and
        offsets."""
        n_best = self.beam_width if n_best is None else n_best
        with span("beam.decode"):
            with span("beam.search"):
                lp = self._log(probs)
                b, t = lp.shape[0], lp.shape[1]
                sizes_t = (torch.full((b,), t, dtype=torch.int32, device=lp.device)
                           if sizes is None
                           else torch.as_tensor(sizes).to(device=lp.device, dtype=torch.int32))
                rev_d, hists, scores_d = _decode_device(
                    lp, sizes_t, self.beam_width, self.blank_index,
                    n_best=min(n_best, self.beam_width), want_hists=self.ctc_offsets,
                    cutoff_top_n=self.cutoff_top_n, cutoff_prob=self.cutoff_prob,
                    fused=self._fused_ok(lp), **self._lm_kwargs(lp))
            with span("beam.fetch"):
                rev_chars = rev_d.cpu().numpy()          # (T, B, n_best)
            with span("beam.strings"):
                strings, offsets = self._strings(rev_chars, lp, sizes_t, hists)
                if with_scores:
                    return strings, offsets, scores_d.cpu().numpy()[:, :rev_chars.shape[2]]
                return strings, offsets

    def _strings(self, rev_chars: np.ndarray, lp: Tensor, sizes_t: Tensor, hists):
        """Each utterance's hypotheses and their offsets from the host copy
        of the backtracked characters, (T, B, n_best) int16."""
        n_best = rev_chars.shape[2]
        b_dim = rev_chars.shape[1]

        chars = [self.label_map.int_to_char.get(c, "\x00")
                 for c in range(int(rev_chars.max(initial=0)) + 1)]
        if all(len(ch) == 1 and ord(ch) < 128 for ch in chars):
            lut = np.array([ord(ch) for ch in chars], np.uint8)
            mk = lambda row: lut[row].tobytes().decode("ascii")
        else:
            slut = np.array(chars)
            mk = lambda row: "".join(slut[row])
        ctc = None
        if self.ctc_offsets:
            ctc = _CtcOffsets(lp.cpu().numpy(), sizes_t.cpu().numpy(), hists[0].cpu().numpy(),
                              hists[1].cpu().numpy(), self.blank_index, self.cutoff_top_n,
                              self.cutoff_prob)
        strings: List[List[str]] = []
        offsets: List[List[np.ndarray]] = []
        for i in range(b_dim):
            utt_s, utt_o = [], []
            for p in range(n_best):
                pos = np.nonzero(rev_chars[:, i, p] >= 0)[0]
                chars_row = rev_chars[pos, i, p]
                utt_s.append(mk(chars_row))
                if ctc is not None:
                    utt_o.append(ctc.offsets(i, chars_row.astype(np.int64), pos))
                else:
                    utt_o.append(pos.astype(np.int32))
            strings.append(utt_s)
            offsets.append(utt_o)
        return strings, offsets


class _CtcOffsets:
    """ctcdecode-parity timesteps for the device beam, rebuilt on the host
    from the scan's streamed per-step beam hashes. A copy of dsjax's (host
    numpy); see dsjax/decode/beam_device.py:_CtcOffsets for the derivation.

    ctcdecode's rule (parlance/ctcdecode path_trie.cpp): a char node's
    timestep is the frame with the highest char log-prob among every
    extension attempt (the parent prefix in the beam and the char passing
    candidate pruning), and a pruned childless node restarts at its next
    re-creation. When ``_keep_all`` proves the host trie never outgrew the
    width, the reconstruction is exact with no hash lookups; otherwise it
    follows the hash history, best-effort where -inf "zombie" parents made
    attempts the hashes cannot show."""

    def __init__(self, lp, sizes, h1_hist, h2_hist, blank, cutoff_top_n, cutoff_prob):
        self.lp = lp                    # (B, T, C) log posteriors
        self.sizes = sizes
        # uint32 views so the hash arithmetic below is plain mod 2^32
        self.h1 = h1_hist.astype(np.int64) & 0xFFFFFFFF   # (T, B, W)
        self.h2 = h2_hist.astype(np.int64) & 0xFFFFFFFF
        self.blank = blank
        self.cutoff_top_n = cutoff_top_n
        self.cutoff_prob = cutoff_prob
        self._cand = {}
        self._keepall = {}

    def _keep_all(self, i):
        """True iff a keep-all host run is self-consistent for utterance i:
        replay the host's node creation under never-prune semantics (every
        live node attempts every non-blank candidate each step) and confirm
        the node count never exceeds the beam width within `size` steps."""
        if i in self._keepall:
            return self._keepall[i]
        w = self.h1.shape[2]
        cand = self._cand_mask(i)
        size = int(self.sizes[i])
        children = [{}]          # node id -> {char: child id}; root = 0
        ok = True
        for t in range(size):
            cs = [int(c) for c in np.nonzero(cand[t])[0] if int(c) != self.blank]
            for p in range(len(children)):   # nodes existing before step t
                kids = children[p]
                for c in cs:
                    if c not in kids:
                        kids[c] = len(children)
                        children.append({})
                        if len(children) > w:
                            ok = False
                            break
                if not ok:
                    break
            if not ok:
                break
        self._keepall[i] = ok
        return ok

    def _cand_mask(self, i):
        """(T, C) candidate mask replicating the scan's pruning."""
        if i in self._cand:
            return self._cand[i]
        lp = self.lp[i]
        t_dim, c_dim = lp.shape
        if self.cutoff_top_n >= c_dim and self.cutoff_prob >= 1.0:
            mask = np.ones((t_dim, c_dim), bool)
        else:
            # stable: equal log-probs resolve to the lower index
            order = np.argsort(-lp, axis=1, kind="stable")
            rank = np.argsort(order, axis=1)
            mask = rank < self.cutoff_top_n
            if self.cutoff_prob < 1.0:
                svals = np.take_along_axis(lp, order, axis=1)
                cum = np.cumsum(np.exp(svals), axis=1)
                n_keep = np.sum(cum < self.cutoff_prob, axis=1, keepdims=True) + 1
                mask &= rank < n_keep
        self._cand[i] = mask
        return mask

    def offsets(self, i, chars, pos):
        t_dim = self.h1.shape[0]
        size = int(self.sizes[i])
        m1, m2 = self.h1[:, i, :], self.h2[:, i, :]      # post-step (T, W)
        cand = self._cand_mask(i)
        tvalid = np.arange(t_dim) < size

        # exhaustive regime: dead (sentinel-hashed) slots at every step and
        # a trie that never outgrew the width -> exact, no hash lookups
        w = m1.shape[1]
        sent = (np.arange(w) + 2) & 0xFFFFFFFF  # uint32 view of -(slot+2)
        dead_any = ((m1 == (0x100000000 - sent)) & (m2 == (0x100000000 - sent))).any(axis=1)
        if size > 0 and bool(dead_any[:size].all()) and self._keep_all(i):
            lp = self.lp[i]
            out = np.empty(len(chars), np.int32)
            create_parent = -1                    # root exists from t=0
            for j, c in enumerate(chars):
                attempts = (cand[:, int(c)] & tvalid
                            & (np.arange(t_dim) >= create_parent + 1))
                if not attempts.any():            # defensive
                    attempts[int(pos[j])] = True
                col = np.where(attempts, lp[:, int(c)], -np.inf)
                out[j] = int(np.argmax(col))
                create_parent = int(np.nonzero(attempts)[0][0])
            return out
        # prefix hashes: empty prefix = 1 (scan init), then the scan's int32
        # rolling update mod 2^32
        hp1, hp2 = [1], [1]
        for c in chars:
            hp1.append((hp1[-1] * _P1 + int(c) + 1) & 0xFFFFFFFF)
            hp2.append((hp2[-1] * _P2 + int(c) + 1) & 0xFFFFFFFF)
        out = np.empty(len(chars), np.int32)
        lp = self.lp[i]
        for j, c in enumerate(chars):
            # membership entering step t = state after step t-1; at t=0 the
            # scan starts with the empty prefix alive (hash 1)
            in_after = (m1 == hp1[j]) & (m2 == hp2[j])
            parent_in = np.empty(t_dim, bool)
            parent_in[1:] = in_after.any(axis=1)[:-1]
            parent_in[0] = hp1[j] == 1 and hp2[j] == 1
            attempts = parent_in & cand[:, int(c)] & tvalid
            child_after = ((m1 == hp1[j + 1]) & (m2 == hp2[j + 1])).any(axis=1)
            tau = int(pos[j])
            deaths = np.nonzero(attempts & ~child_after & (np.arange(t_dim) < tau))[0]
            r = int(deaths[-1]) + 1 if len(deaths) else 0
            window = attempts & (np.arange(t_dim) >= r)
            if not window.any():        # defensive: the emission frame always
                window[tau] = True      # qualifies
            col = np.where(window, lp[:, int(c)], -np.inf)
            out[j] = int(np.argmax(col))
        return out
