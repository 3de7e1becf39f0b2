"""The numbers that decide ``correct`` for a training step, each the
worst over its parts (see ``PERF.md`` for the readings behind each limit):

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: over the leaves, the gap between the norms of the first
  clipped gradient, over the larger of the reference leaf's norm and the
  median leaf's;
* ``change_gap``: the same for each leaf's change over the steps, leaving
  out leaves whose reference gradient is under a thousandth of the median
  leaf's (a key's bias under softmax, a leaf the loss never reads): they
  move by round-off alone."""
from __future__ import annotations

import statistics

EXCLUDE_BELOW = 1e-3


def _worst(prog: dict, ref: dict, names) -> float:
    names = list(names)
    med = statistics.median(ref[n] for n in names) if names else 0.0
    worst = 0.0
    for n in names:
        den = max(ref[n], med)
        if den > 0:
            worst = max(worst, abs(prog[n] - ref[n]) / den)
    return worst


def gaps(prog: dict, ref: dict) -> dict:
    """`prog`/`ref`: {"loss": [...], "grad": {leaf: norm}, "change":
    {leaf: norm}}."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    med = statistics.median(ref["grad"].values())
    moving = [n for n, g in ref["grad"].items() if g >= EXCLUDE_BELOW * med]
    return {"loss_gap": loss,
            "grad_gap": _worst(prog["grad"], ref["grad"], ref["grad"]),
            "change_gap": _worst(prog["change"], ref["change"], moving)}
