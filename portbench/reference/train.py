"""Plain training steps of the reference: forward, CTC, backward, the
global-norm clip and AdamW, as deepspeech.pytorch trains (``model.py``'s
``training_step`` with Lightning's ``gradient_clip_val`` and
``torch.optim.AdamW``), written out so that nothing of the program runs.

The loss is the sum over the batch's rows of ``F.ctc_loss`` (blank 0,
``zero_infinity``) on the f32 log-softmax of the logits. The clip scales
every gradient by clip / norm when the global norm reaches clip. AdamW
decays each parameter by lr * weight_decay before its Adam step, with
bias-corrected moments.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from portbench.reference import ds2

Tensor = torch.Tensor
STATS = ("running_mean", "running_var")


class RefBatch(NamedTuple):
    audio: Tensor            # (B, L) int16 on the device
    n_samples: Sequence[int]
    targets: Tensor          # (B, L_max) int64, 0-padded
    target_lengths: Tensor   # (B,) int64


class Readings(NamedTuple):
    losses: List[float]             # each step's loss
    grad_norms: Dict[str, float]    # each leaf's clipped gradient at step 1
    change_norms: Dict[str, float]  # each leaf's |p_steps - p_0|
    grads: Dict[str, Tensor]        # the clipped gradients of step 1


def loss_of(params: Dict[str, Tensor], arch: Dict, batch: RefBatch, quant=None,
            checkpoint: bool = False) -> Tensor:
    with torch.no_grad():
        feats, n_frames = ds2.spectrogram(batch.audio, batch.n_samples)
    logits, out_len = ds2.forward(params, arch, feats, n_frames, train=True, quant=quant,
                                  checkpoint=checkpoint)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = F.ctc_loss(logp.transpose(0, 1), batch.targets, out_len, batch.target_lengths,
                     blank=0, reduction="none", zero_infinity=True)
    return nll.sum()


def train_steps(w0: Dict[str, Tensor], arch: Dict, batches: Sequence[RefBatch], optim: Dict,
                quant=None, divisor: float = 1.0, checkpoint: bool = False) -> Readings:
    """One step on each batch from weights ``w0``, which stay unchanged.
    ``optim``: lr, weight_decay, betas, eps, clip. The loss is the rows'
    sum over ``divisor``: data parallelism over D ranks trains on the
    global batch's sum over D, as dsjax's ``loss / dp`` and DDP's average
    of the ranks' gradients do. ``checkpoint``: ``ds2.forward``'s."""
    names = [k for k in w0 if not k.endswith(STATS)]
    params = {k: w0[k].detach().clone().requires_grad_(True) for k in names}
    stats = {k: v for k, v in w0.items() if k.endswith(STATS)}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    lr, wd, eps, clip = optim["lr"], optim["weight_decay"], optim["eps"], optim["clip"]
    b1, b2 = optim["betas"]
    losses, grad_norms, first = [], {}, {}
    for step, batch in enumerate(batches, start=1):
        with ds2.strict_f32():
            loss = loss_of({**params, **stats}, arch, batch, quant, checkpoint) / divisor
            grads = torch.autograd.grad(loss, [params[k] for k in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
            scale = float(clip / norm) if float(norm) >= clip else 1.0
            for k, g in zip(names, grads):
                g = g * scale
                if step == 1:
                    grad_norms[k] = float(torch.linalg.vector_norm(g.double()))
                    first[k] = g
                p = params[k]
                p.mul_(1.0 - lr * wd)
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[k] / (1 - b2 ** step)).sqrt_().add_(eps)
                p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** step))
        del grads
    change = {k: float(torch.linalg.vector_norm((params[k].detach() - w0[k]).double()))
              for k in names}
    return Readings(losses, grad_norms, change, first)


def median(values) -> float:
    s = sorted(values)
    n = len(s)
    return 0.5 * (s[(n - 1) // 2] + s[n // 2]) if n else math.nan
