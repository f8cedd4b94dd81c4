"""The comparisons that decide ``correct``, and the readings they take.

Training: the program's first steps against the reference's on the same
weights and batches. Four numbers, each a relative gap:

  loss_gap         |L_prog - L_ref| / |L_ref| of the first step's loss (the
                   later steps' losses part by Adam's sign steps on
                   round-off). It is read and printed, not compared: over
                   the batch's sum the control's float8 reads like bf16's
                   round-off, and no fault but a wrong loss moves it, so
                   no limit separates a sound run;
  grad_gap         over the leaves, the largest |(|g_prog| - |g_ref|)| /
                   max(|g_ref|, the median leaf's |g_ref|), g the clipped
                   gradient of step 1 as the optimizer took it;
  grad_dir_gap     the median over the leaves of |g_prog - g_ref| / |g_ref|:
                   the global-norm clip gives every step-1 gradient the
                   same norm and AdamW's first step is about lr x sign(g),
                   so the norms above hardly see a gradient taken from the
                   wrong rows; its direction does;
  change_gap       as grad_gap, of each leaf's change |p_n - p_0| after the
                   steps.

They take only the leaves whose reference gradient is at least a
thousandth of the median leaf's: a leaf whose gradient is zero to rounding,
such as a convolution's bias before its BatchNorm, has a gradient of
round-off alone, which Adam turns into a step of full size.

Evaluation: the program's posteriors and transcripts against the
reference's. Three numbers:

  probs_gap   the largest |p_prog - p_ref| over the valid frames and the
              classes of the sampled utterances;
  beam_gap    the largest, over the sampled utterances, of how far the
              program's transcript falls below the reference beam
              search's in CTC log-likelihood, both under the reference's
              posteriors (nats; 0 where it is not below): the reference's
              forward and beam against the program's forward and beam;
  beam_miss_share  the share of the sampled utterances whose transcript
              falls below the reference's by more than MISS_NATS: a
              near-tie parts the two searches now and then, a wrong
              decoder on most answers.

A run is correct when every number that the cell's traffic file gives a
limit is at or under it.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch

from portbench.reference.train import Readings, median

KEEP_SHARE = 1e-3
MISS_NATS = 1e-6


def _leaf_gap(prog: Mapping[str, float], ref: Mapping[str, float], leaves) -> float:
    leaves = list(leaves)
    floor = median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], floor) for k in leaves)


def moved_leaves(ref: Readings) -> List[str]:
    """The leaves whose reference gradient is at least KEEP_SHARE of the
    median leaf's."""
    floor = median(ref.grad_norms.values())
    return [k for k, g in ref.grad_norms.items() if g >= KEEP_SHARE * floor]


def train_numbers(prog: Readings, ref: Readings) -> Dict[str, float]:
    moved = moved_leaves(ref)

    def direction(k: str) -> float:
        g_r = ref.grads[k].double()
        g_p = prog.grads[k].to(g_r.device, torch.float64)
        return float(torch.linalg.vector_norm(g_p - g_r) / torch.linalg.vector_norm(g_r))

    return {
        "loss_gap": abs(prog.losses[0] - ref.losses[0]) / abs(ref.losses[0]),
        "grad_gap": _leaf_gap(prog.grad_norms, ref.grad_norms, moved),
        "grad_dir_gap": median(direction(k) for k in moved),
        "change_gap": _leaf_gap(prog.change_norms, ref.change_norms, moved),
    }


def worst_leaves(prog: Readings, ref: Readings) -> Dict[str, str]:
    """Which leaf sets grad_gap and change_gap, the leaves left out, and
    every step's loss gap."""
    moved = moved_leaves(ref)
    out = {"left_out": ",".join(k for k in ref.grad_norms if k not in moved),
           "step_loss_gaps": [abs(p - r) / abs(r) for p, r in zip(prog.losses, ref.losses)]}
    for name, p, r in (("grad", prog.grad_norms, ref.grad_norms),
                       ("change", prog.change_norms, ref.change_norms)):
        floor = median(r[k] for k in moved)
        out[f"{name}_gap_leaf"] = max(moved, key=lambda k: abs(p[k] - r[k]) / max(r[k], floor))
    return out


def judge(numbers: Mapping[str, float], limits: Mapping[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {name: {value, limit}}): correct when every number is a
    number at or under its limit."""
    checks = {k: {"value": float(numbers[k]), "limit": float(limits[k])} for k in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())   # NaN fails
    return ok, checks
