"""The comparison that decides ``correct`` for a training cell.

The program's first steps (the ones set-up drives through the window's own
call and feed) are held against the plain reference's run of the same steps
from the same weights on the same rows. Three numbers, each with its limit
from ``benchmark/limits/<cell>.json``:

  * ``loss_gap``: the largest |program loss - reference loss| over the
    checked steps;
  * ``grad_norm_gap``: over the leaves, the largest gap between the norm of
    the first step's gradient as the optimizer got it (the program's worked
    out from its first moment after one step) and the reference's, over the
    larger of that leaf's reference norm and the median leaf's;
  * ``update_norm_gap``: the same for the norm of each parameter's change
    over the checked steps, taken over the elements whose first reference
    gradient is at least a thousandth of the median leaf's root-mean-square
    one (the others, as a key's bias under the softmax, move under Adam by
    round-off alone; the reference picks them, ``reference/gpt2.py``).
"""

from __future__ import annotations

import math
import statistics


def _worst(prog: dict, ref: dict, names) -> tuple:
    names = list(names)
    floor = statistics.median(ref[n] for n in names)
    worst, leaf = 0.0, None
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], floor)
        if not math.isfinite(gap):
            return math.inf, n
        if gap >= worst:
            worst, leaf = gap, n
    return worst, leaf


def readings(prog: dict, ref: dict) -> dict:
    """The numbers compared, from the program's readings ``prog`` and the
    reference's ``ref`` (each {"loss": [...], "grad": {leaf: norm},
    "change": {leaf: norm}}; ``ref`` also has "raw_grad")."""
    if set(prog["grad"]) != set(ref["grad"]) or len(prog["loss"]) != len(ref["loss"]):
        raise ValueError("program and reference readings cover different leaves or steps")
    loss_gap = max(abs(a - b) for a, b in zip(prog["loss"], ref["loss"]))
    if not all(math.isfinite(x) for x in prog["loss"]):
        loss_gap = math.inf
    grad_gap, grad_leaf = _worst(prog["grad"], ref["grad"], ref["grad"])
    upd_gap, upd_leaf = _worst(prog["change"], ref["change"], ref["change"])
    return {"loss_gap": loss_gap, "grad_norm_gap": grad_gap, "update_norm_gap": upd_gap,
            "worst_grad_leaf": grad_leaf, "worst_update_leaf": upd_leaf,
            "left_out": ref.get("left_out", {})}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) for the numbers that the cell's
    limits file names, each against its limit; a number that is not finite
    fails."""
    checks = {}
    ok = True
    for name in limits["limits"]:
        value, limit = numbers[name], float(limits["limits"][name])
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks
