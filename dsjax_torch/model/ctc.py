"""Connectionist Temporal Classification loss: the counterpart of
dsjax/model/ctc.py (``ctc_loss``).

dsjax computes CTC as a log-semiring scan with an analytic VJP and has no
Pallas kernel for it (a Pallas twin was measured slower and removed,
dsjax/model/ctc.py:229-236), so the port runs PyTorch's own
``F.ctc_loss``, as it runs the other dense work dsjax leaves outside
Pallas. The signature is dsjax's: (B, T, C) log-probabilities, padded
(B, L) targets, ``reduction`` and ``zero_infinity``.

``F.ctc_loss``'s gradient with respect to its log-probabilities is
exp(lp) - posterior, which is the right gradient only through the
log-softmax that produced them; feed it log_softmax outputs, as the
trainer does. Infeasible rows (input shorter than the target needs) give
0 loss and 0 gradient under ``zero_infinity``, as in dsjax.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def ctc_loss(log_probs: Tensor, input_lengths: Tensor, targets: Tensor,
             target_lengths: Tensor, blank: int = 0, reduction: str = "sum",
             zero_infinity: bool = True) -> Tensor:
    """CTC loss with torch's semantics (reference: model.py:203).

    log_probs (B, T, C) float32 log-softmax outputs; input_lengths (B,);
    targets (B, L) padded label ids (masked by target_lengths);
    target_lengths (B,). reduction: 'sum' (the reference's), 'mean' (the
    target-length weighted mean), or 'none' (per-row nll, shape (B,)).
    """
    if reduction not in ("none", "sum", "mean"):
        raise ValueError(f"unknown reduction {reduction!r}")
    nll = F.ctc_loss(log_probs.float().transpose(0, 1), targets.long(), input_lengths.long(),
                     target_lengths.long(), blank=blank, reduction="none",
                     zero_infinity=zero_infinity)
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    return (nll / target_lengths.clamp(min=1).to(nll.dtype)).mean()
