"""The comparison that decides ``correct``: the program's first training
steps against the reference's, by the numbers below, each that the cell's
limits file (``hvdbench/limits/<workload>.json``) names held to its
limit.

* ``loss_gap``: the largest relative gap of the three steps' losses;
* ``grad_gap``: the first step's gradient, as the optimizer holds it after
  one step, by the worst leaf: the gap between the program's norm and the
  reference's, over the larger of the reference's norm of that leaf and of
  the median leaf;
* ``late_grad_gap``: the same for the last step's gradient, from the
  optimizer's moments before and after it. The first step runs eagerly;
  the last is a replay of the captured step with the exchange armed, as
  every step of the window is;
* ``change_gap``: the parameters' change over the three steps, by the
  worst leaf in the same way.

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of both leaf numbers: such a gradient is nought to
rounding, and Adam moves its leaf by round-off alone.
"""

from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_gap", "grad_gap", "late_grad_gap", "change_gap")
KEEP = 1e-3


def _gaps(prog, ref, kept) -> list[float]:
    """Each kept leaf's gap: ``|prog - ref|`` over the larger of the
    reference's norm of the leaf and of the median kept leaf; infinite
    where the program has no reading."""
    if prog is None:
        return [math.inf]
    floor = statistics.median(ref[i] for i in kept)
    gaps = [abs(prog[i] - ref[i]) / max(ref[i], floor) for i in kept]
    return gaps if all(math.isfinite(g) for g in gaps) else [math.inf]


def numbers(prog: dict, ref: dict) -> dict:
    """The numbers from the program's readings and the reference's, each
    ``{"losses", "first", "late", "change"}`` (lists of floats; the
    program's ``first`` and ``late`` None where its optimizer holds no
    state)."""
    med = statistics.median(ref["first"])
    kept = [i for i, g in enumerate(ref["first"]) if g >= KEEP * med]
    loss = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                ref["losses"])]
    return {"loss_gap": (max(loss) if all(math.isfinite(x) for x in loss)
                         else math.inf),
            **{name: max(_gaps(prog[k], ref[k], kept)) for name, k in (
                ("grad_gap", "first"), ("late_grad_gap", "late"),
                ("change_gap", "change"))}}


def judge(found: dict, limits: dict) -> bool:
    """Every number that has a limit at or under it (NaN fails)."""
    return all(found[k] <= limit for k, limit in limits.items())


def lines(found: dict, limits: dict) -> list[str]:
    """One line a compared number: its name, its value and its limit."""
    return [f"check {k} {found[k]!r} limit {limits[k]!r}" for k in limits]
