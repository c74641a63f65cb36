"""The comparison that decides ``correct`` for the training cells.

The program's first steps against the reference's from the same weights on
the same rows:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: by the worst leaf, the gap between the norms of the
  program's and the reference's first gradient, over the larger of the
  reference leaf's norm and the median leaf's;
* ``change_gap``: the same for each leaf's change over the steps.  Leaves
  whose reference gradient is under a thousandth of the median leaf's are
  left out: Adam moves them by round-off alone.
"""

from __future__ import annotations

import torch


def _by_leaf(got: dict, want: dict, keep) -> float:
    norms = {k: float(want[k].double().norm()) for k in want}
    median = float(torch.tensor(list(norms.values()), dtype=torch.float64).median())
    worst = 0.0
    for k in want:
        if keep(k):
            gap = abs(float(got[k].double().norm()) - norms[k]) / max(norms[k], median)
            worst = max(worst, gap)
    return worst


def numbers(got: tuple, want: tuple, p0: dict) -> dict:
    """``got``/``want``: (losses (S,), first gradient {leaf}, parameters
    after the last step {leaf})."""
    g_loss, g_grad, g_end = got
    w_loss, w_grad, w_end = want
    loss_gap = float(((g_loss.double() - w_loss.double()).abs() / w_loss.double().abs()).max())
    grad_gap = _by_leaf(g_grad, w_grad, lambda k: True)
    gnorm = {k: float(v.double().norm()) for k, v in w_grad.items()}
    gmed = float(torch.tensor(list(gnorm.values()), dtype=torch.float64).median())
    moved = lambda k: gnorm[k] >= 1e-3 * gmed
    change_gap = _by_leaf({k: g_end[k] - p0[k] for k in p0}, {k: w_end[k] - p0[k] for k in p0}, moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def compare(got: tuple, want: tuple, p0: dict, limits: dict) -> list:
    vals = numbers(got, want, p0)
    return [(k, vals[k], float(lim)) for k, lim in limits.items()]
