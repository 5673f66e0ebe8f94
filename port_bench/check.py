"""The numbers that decide ``correct``, and their comparison with limits.

Training (the program's first three steps against the reference's):

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: over the leaves, the largest gap between the norms of the
  program's and the reference's first gradient, against the reference's
  norm of that leaf or of the median leaf, whichever is larger;
- ``change_gap``: the same for the parameters' change after the third
  step, over the leaves whose reference gradient is at least a thousandth
  of the median leaf's (below that a leaf moves under Adam by round-off);
- ``stats_gap``: over the BatchNorms, the worst gap of the first step's
  batch statistics (the program's read back from its running buffers).

Serving: ``label_gap``, the widest gap by which a served label's reference
logit lies below the reference's best, over a sample of the finished
requests.

A number is within its limit when it is finite and at most the limit; a
cell without a limit for a number it reads is not correct.
"""

from __future__ import annotations

import math
import statistics

CHANGE_FLOOR = 1e-3    # share of the median leaf's reference gradient


def _norm_gap(program: dict, reference: dict, leaves) -> float:
    median = statistics.median(reference[k] for k in reference)
    gaps = [abs(program.get(k, 0.0) - reference[k]) / max(reference[k], median)
            for k in leaves]
    return max((g if math.isfinite(g) else float("inf") for g in gaps),
               default=float("inf"))


def _stats_gap(program: dict, reference: dict) -> float:
    """Over the BatchNorms, the worst of the first step's batch statistics:
    the mean's deviation in units of the reference's standard deviation,
    and the variance's relative deviation, each as a norm over channels."""
    worst = 0.0
    for name, (mean_r, var_r) in reference.items():
        if name not in program:
            return float("inf")
        mean_p, var_p = program[name]
        dm = float((mean_p - mean_r).norm() / var_r.sqrt().norm())
        dv = float((var_p - var_r).norm() / var_r.norm())
        worst = max(worst, dm if math.isfinite(dm) else float("inf"),
                    dv if math.isfinite(dv) else float("inf"))
    return worst


def left_out(reference: dict) -> list:
    """The leaves ``change_gap`` leaves out: reference first gradient under
    ``CHANGE_FLOOR`` of the median leaf's."""
    ref_g = reference["grad1"]
    median_g = statistics.median(ref_g.values())
    return sorted(k for k in ref_g if ref_g[k] < CHANGE_FLOOR * median_g)


def training_numbers(program: dict, reference: dict) -> dict:
    """``program`` and ``reference``: ``loss`` (a list), ``grad1`` and
    ``change`` (leaf -> norm), as ``reference.train.follow`` returns them."""
    loss_gap = max((abs(p - r) / abs(r) if math.isfinite(p) else float("inf"))
                   for p, r in zip(program["loss"], reference["loss"]))
    if len(program["loss"]) != len(reference["loss"]):
        loss_gap = float("inf")
    ref_g = reference["grad1"]
    skip = set(left_out(reference))
    moving = [k for k in reference["change"] if k not in skip]
    return {"loss_gap": loss_gap,
            "grad_gap": _norm_gap(program["grad1"], ref_g, ref_g),
            "change_gap": _norm_gap(program["change"], reference["change"], moving),
            "stats_gap": _stats_gap(program["stats1"], reference["stats1"])}


def judge(numbers: dict, limits: dict):
    """``(correct, checks)``: ``checks`` maps each number to its value and
    limit, in the order of ``numbers``."""
    checks, correct = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not (math.isfinite(value) and value <= limit):
            correct = False
    return correct, checks
