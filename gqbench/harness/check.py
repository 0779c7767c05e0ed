"""The comparison that decides ``correct``: the program's readings of its
first steps against the reference's.

A leaf's (or running statistic's) gap is the difference between the
program's norm and the reference's (not the norm of the difference), over
the larger of the reference's norm of it and the median of the reference's
norms, so a gradient that is all but zero is weighed against the median
leaf.  The leaves fall into the leaf families that the model's family
gives (``reference.model.leaf_families``; the image families': ``k7``, the
kernels of the stride-1 convolutions whose per-user weight gradient the
program's own kernel computes, ``conv``, every other conv and dense leaf,
``bn``, the batch norms' scales and biases).  Each leaf family is compared
apart, so a fault inside one layer is not lost in the median of all.  The
numbers of a cell (``cell_numbers``), each against its limit
(``gqbench/limits/<workload>.json``, which lists exactly these):
  loss         the gap of the first step's loss, over the reference's;
  grad.<f>     the median leaf of leaf family f's gaps between the norms of
               the first step's aggregated gradient (the program's read
               from its momentum), for each f that has leaves;
  change.<f>   the median leaf of leaf family f's gaps between the norms of
               the parameters' change over the three steps;
  bn_stats     the median statistic's gap between the norms of the running
               statistics' change over the three steps, where the model
               keeps running statistics.
The median leaf of a leaf family, not its worst: on sound runs the worst leaf
reads about as much as a family whose gradients all come out a tenth short
(in bf16 a batch norm's scale or bias, a sum over the batch, 0.13-0.43; the
stem, whose input is rounded to bf16, up to 0.06), the median leaf a
twentieth of that.  Only the first step's gradient and the change after
three steps are compared, not every step's loss: from the second step on
the training from random weights at lr 0.1 carries any rounding on (the
stochastic compressors turn it into other codes), and the float32 reference
itself reads a worst leaf's change 0.04-0.27 from the float64 one.
``look`` gives the other readings beside them.  The leaves whose first
reference gradient is under a thousandth of the median leaf's (a conv bias
before batch norm, which the weight decay alone moves) are left out of
both.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Sequence, Tuple

READINGS = ("grad", "change")
NOUGHT = 1e-3


def names(leaf_families: Sequence[str], running: bool) -> Tuple[str, ...]:
    """The compared numbers, in order, of a model with leaves in each of
    ``leaf_families`` and, if ``running``, running statistics."""
    return (("loss",) + tuple(f"{r}.{f}" for r in READINGS for f in leaf_families)
            + (("bn_stats",) if running else ()))


#: the numbers of a model with k7, conv and bn leaves and running
#: statistics, as the image families have (every cell of the benchmark's
#: own manifest so far); a run takes its cell's from ``cell_numbers``
NUMBERS = names(("k7", "conv", "bn"), True)


def cell_numbers(families: Dict[str, str], order: Sequence[str],
                 running: bool) -> Tuple[str, ...]:
    """The compared numbers of a cell: ``families`` {path: leaf family},
    ``order`` the model family's leaf families in the order they are
    reported, ``running`` whether it keeps running statistics."""
    present = set(families.values())
    if present - set(order):
        raise ValueError(f"leaf families {sorted(present - set(order))} are not in the "
                         f"family's order {tuple(order)}")
    return names([f for f in order if f in present], running)


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keys=None) -> Dict[str, float]:
    keys = sorted(ref) if keys is None else keys
    if set(prog) != set(ref):
        return {k: math.inf for k in keys}
    med = statistics.median(ref.values())
    out = {}
    for k in keys:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        out[k] = gap if math.isfinite(gap) else math.inf
    return out


def _moved(ref: dict):
    med = statistics.median(ref["grad"].values())
    return [k for k in sorted(ref["change"]) if ref["grad"][k] >= NOUGHT * med]


def _loss_gap(p: float, r: float) -> float:
    return abs(p - r) / abs(r) if math.isfinite(p) else math.inf


def family_gaps(prog: dict, ref: dict, families: Dict[str, str]) -> Dict[str, Dict[str, list]]:
    """{reading: {family: [gap of each leaf]}} for ``grad`` and ``change``,
    the leaves with no gradient of their own left out."""
    moved = _moved(ref)
    gaps = {"grad": _gaps(prog["grad"], ref["grad"], moved),
            "change": _gaps(prog["change"], ref["change"], moved)}
    out = {}
    for reading, by_leaf in gaps.items():
        out[reading] = {}
        for leaf, gap in by_leaf.items():
            out[reading].setdefault(families[leaf], []).append(gap)
    return out


def numbers(prog: dict, ref: dict, families: Dict[str, str], order: Sequence[str],
            running: bool) -> Dict[str, float]:
    """The compared numbers of a run, ``cell_numbers``'s (``inf`` where the
    program's reading is missing or not finite, or where every leaf of a
    leaf family was left out)."""
    fam = family_gaps(prog, ref, families)
    out = {"loss": _loss_gap(prog["losses"][0], ref["losses"][0])}
    for name in cell_numbers(families, order, running)[1:]:
        if name == "bn_stats":
            out[name] = statistics.median(_gaps(prog["bn_stats"], ref["bn_stats"]).values())
        else:
            reading, family = name.split(".", 1)
            gaps = fam[reading].get(family)
            out[name] = statistics.median(gaps) if gaps else math.inf
    return out


def look(prog: dict, ref: dict, families: Dict[str, str]) -> Dict[str, float]:
    """The readings beside the compared ones, for the record: every step's
    loss, each family's worst and median leaf, the worst statistic."""
    out = {"loss_every_step": max(_loss_gap(p, r) for p, r in zip(prog["losses"], ref["losses"]))}
    for reading, by_family in family_gaps(prog, ref, families).items():
        for family, gaps in sorted(by_family.items()):
            out[f"{reading}.{family}.worst"] = max(gaps)
            out[f"{reading}.{family}.median"] = statistics.median(gaps)
    if ref["bn_stats"]:
        out["bn_stats_worst"] = max(_gaps(prog["bn_stats"], ref["bn_stats"]).values())
    return out


def judge(values: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """{number: {"value", "limit"}} for the run's numbers that the limits
    file lists; a number it marks ``"compared": false`` is reported with
    limit None.  Where the file lists a number the run does not give, or
    lacks one it gives, ``limits_unmatched`` counts them, against 0."""
    out = {}
    for name, value in values.items():
        if name in limits:
            entry = limits[name]
            out[name] = {"value": value,
                         "limit": entry["limit"] if entry.get("compared", True) else None}
    unmatched = unmatched_limits(values, limits)
    if unmatched:
        out["limits_unmatched"] = {"value": len(unmatched), "limit": 0}
    return out


def unmatched_limits(values: Dict[str, float], limits: dict):
    """The numbers that the run gives or the limits file lists, not both."""
    return sorted(set(values) ^ set(limits))


def passed(judged: Dict[str, dict]) -> bool:
    return all(v["limit"] is None or v["value"] <= v["limit"] for v in judged.values())
