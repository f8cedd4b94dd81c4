"""Plain CTC prefix beam search and the CTC log-likelihood of a transcript,
in float64 on the host.

The search is the textbook one (Hannun et al. 2014, without a language
model), as ctcdecode and deepspeech.pytorch's ``BeamCTCDecoder`` run it
with no pruning: every frame each kept prefix may stay (blank, or its last
character again) or be extended by any character; an extension that spells
a prefix already kept adds its mass to that prefix; the ``width`` prefixes
of highest total probability are kept. Imports nothing of the program.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG = -np.inf


def round_bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bfloat16 (nearest, ties to even), as float64."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def beam_search(logp: np.ndarray, width: int, blank: int = 0,
                rounding: Optional[Callable[[np.ndarray], np.ndarray]] = None
                ) -> Tuple[int, ...]:
    """(T, C) log-probabilities -> the best prefix's label ids. ``rounding``,
    for the control, rounds the log-probabilities and every score computed
    from them."""
    rnd = rounding or (lambda a: a)
    logp = rnd(logp)
    n_c = logp.shape[1]
    prefixes: List[Tuple[int, ...]] = [()]
    p_b = np.array([0.0])
    p_nb = np.array([NEG])
    for lp in logp:
        total = rnd(np.logaddexp(p_b, p_nb))
        last = np.array([p[-1] if p else -1 for p in prefixes])
        stay_b = rnd(total + lp[blank])
        stay_nb = rnd(np.where(last >= 0, p_nb + lp[np.maximum(last, 0)], NEG))
        ext = total[:, None] + lp[None, :]
        repeat = last >= 0
        ext[repeat, last[repeat]] = p_b[repeat] + lp[last[repeat]]
        ext = rnd(ext)
        ext[:, blank] = NEG
        index = {p: i for i, p in enumerate(prefixes)}
        for r, p in enumerate(prefixes):          # extend(q, c) spells kept prefix r
            q = index.get(p[:-1]) if p else None
            if q is not None:
                stay_nb[r] = rnd(np.logaddexp(stay_nb[r], ext[q, p[-1]]))
                ext[q, p[-1]] = NEG
        scores = np.concatenate([rnd(np.logaddexp(stay_b, stay_nb)), ext.ravel()])
        order = np.argsort(-scores, kind="stable")[:width]
        order = order[np.isfinite(scores[order])]
        new_prefixes, nb, nnb = [], [], []
        for k in order:
            if k < len(prefixes):
                new_prefixes.append(prefixes[k])
                nb.append(stay_b[k])
                nnb.append(stay_nb[k])
            else:
                q, c = divmod(int(k) - len(prefixes), n_c)
                new_prefixes.append(prefixes[q] + (c,))
                nb.append(NEG)
                nnb.append(ext[q, c])
        prefixes, p_b, p_nb = new_prefixes, np.array(nb), np.array(nnb)
    return prefixes[int(np.argmax(np.logaddexp(p_b, p_nb)))]


def log_likelihood(logp: np.ndarray, labels: Sequence[int], blank: int = 0) -> float:
    """log P(labels | posteriors) summed over every CTC alignment, float64."""
    lp = torch.from_numpy(np.ascontiguousarray(logp, np.float64))[:, None, :]
    target = torch.tensor([list(labels)], dtype=torch.int64)
    nll = F.ctc_loss(lp, target, torch.tensor([lp.shape[0]]), torch.tensor([len(labels)]),
                     blank=blank, reduction="sum", zero_infinity=False)
    return -float(nll)
