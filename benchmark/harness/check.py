"""The numbers that decide ``correct``, each worked out from a reading of
the program and one of the reference.

Training (three steps from the same weights on the same rows):

- ``loss_gap``: the largest relative gap of a step's loss, over the
  cell's first ``loss_steps`` steps (default all);
- ``grad_gap``: the worst parameter's gap between the norms of its first
  gradient as the optimizer got it (program: its first moment after one
  step over 1 - b1; reference: the clipped gradient), over the larger of
  the reference's norm of that parameter and the median parameter's;
- ``change_gap``: the same for the norm of each parameter's change after
  the three steps, taken on both sides over the elements whose first
  gradient in the reference is at least a thousandth of the median
  parameter's root-mean-square one, and over the parameters whose first
  gradient in the reference is at least a thousandth of the median
  parameter's (what is left out moves by weight decay and round-off
  alone: ``reference/optim.py``).

Serving: ``logprob_gap``, the largest gap between the program's and the
reference's log-probability of a class over a sample of the rows served,
over classes the reference gives at least 1e-3.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence, Tuple

LEAF_FLOOR = 1e-3


def _worst(prog: Dict[str, float], ref: Dict[str, float],
           names: Sequence[str]) -> Tuple[float, str]:
    med = statistics.median(ref[n] for n in names)
    worst, at = 0.0, ""
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if not math.isfinite(gap):
            return float("inf"), n
        if gap > worst:
            worst, at = gap, n
    return worst, at


def train_numbers(prog: dict, ref: dict, loss_steps: int = 0
                  ) -> Tuple[Dict[str, float], Dict[str, str]]:
    """(numbers, the parameter each was worst at)."""
    steps = loss_steps or len(ref["losses"])
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(prog["losses"][:steps],
                                   ref["losses"][:steps]))
    if not all(math.isfinite(p) for p in prog["losses"]):
        loss_gap = float("inf")
    names = list(ref["first_grad"])
    grad_gap, grad_at = _worst(prog["first_grad"], ref["first_grad"], names)
    med = statistics.median(ref["first_grad"][n] for n in names)
    moving = [n for n in names if ref["first_grad"][n] >= LEAF_FLOOR * med]
    change_gap, change_at = _worst(prog["change"], ref["change"], moving)
    return ({"loss_gap": loss_gap, "grad_gap": grad_gap,
             "change_gap": change_gap},
            {"grad_gap": grad_at, "change_gap": change_at,
             "left_out_of_change": str(len(names) - len(moving))})


def logprob_gap(prog_probs: Sequence[Sequence[float]],
                ref_logp: Sequence[Sequence[float]]) -> float:
    worst = 0.0
    for p_row, r_row in zip(prog_probs, ref_logp):
        for p, r in zip(p_row, r_row):
            if r < math.log(1e-3):
                continue
            gap = abs(math.log(max(float(p), 1e-12)) - float(r))
            if not math.isfinite(gap):
                return float("inf")
            worst = max(worst, gap)
    return worst


def lines(checks: List[Tuple[str, float, float]]) -> List[str]:
    return [f"{name} {value!r} limit {lim!r}" for name, value, lim in checks]
