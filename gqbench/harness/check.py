"""The comparison that decides ``correct``: the program's readings of its
first steps against the reference's.

A leaf's (or running statistic's) gap is the difference between the
program's norm and the reference's (not the norm of the difference), over
the larger of the reference's norm of it and the median of the reference's
norms, so a gradient that is all but zero is weighed against the median
leaf.  The leaves fall into families (``reference.model.leaf_families``):
``k7``, the kernels of the stride-1 convolutions whose per-user weight
gradient the program's own kernel computes; ``conv``, every other conv and
dense leaf; ``bn``, the batch norms' scales and biases.  Each family is
compared apart, so a fault inside one layer is not lost in the median of
all.  The numbers, each against its limit (``gqbench/limits/<workload>.json``):
  loss         the gap of the first step's loss, over the reference's;
  grad.<f>     the median leaf of family f's gaps between the norms of the
               first step's aggregated gradient (the program's read from
               its momentum);
  change.<f>   the median leaf of family f's gaps between the norms of the
               parameters' change over the three steps;
  bn_stats     the median statistic's gap between the norms of the running
               statistics' change over the three steps.
The median leaf of a family, not its worst: on sound runs the worst leaf
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
from typing import Dict

#: each compared number after the loss: (reading, family)
PARTS = {f"{reading}.{family}": (reading, family)
         for reading in ("grad", "change") for family in ("k7", "conv", "bn")}
NUMBERS = ("loss",) + tuple(PARTS) + ("bn_stats",)
NOUGHT = 1e-3


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


def numbers(prog: dict, ref: dict, families: Dict[str, str]) -> Dict[str, float]:
    """The compared numbers of a run (``inf`` where the program's reading
    is missing or not finite)."""
    fam = family_gaps(prog, ref, families)
    out = {"loss": _loss_gap(prog["losses"][0], ref["losses"][0])}
    for name, (reading, family) in PARTS.items():
        out[name] = statistics.median(fam[reading][family])
    out["bn_stats"] = statistics.median(_gaps(prog["bn_stats"], ref["bn_stats"]).values())
    return out


def look(prog: dict, ref: dict, families: Dict[str, str]) -> Dict[str, float]:
    """The readings beside the compared ones, for the record: every step's
    loss, each family's worst and median leaf, the worst statistic."""
    out = {"loss_every_step": max(_loss_gap(p, r) for p, r in zip(prog["losses"], ref["losses"]))}
    for reading, by_family in family_gaps(prog, ref, families).items():
        for family, gaps in sorted(by_family.items()):
            out[f"{reading}.{family}.worst"] = max(gaps)
            out[f"{reading}.{family}.median"] = statistics.median(gaps)
    out["bn_stats_worst"] = max(_gaps(prog["bn_stats"], ref["bn_stats"]).values())
    return out


def judge(values: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """{number: {"value", "limit"}} for the numbers the limits file
    compares; a number it marks ``"compared": false`` is reported with
    limit None."""
    out = {}
    for name in NUMBERS:
        entry = limits[name]
        out[name] = {"value": values[name],
                     "limit": entry["limit"] if entry.get("compared", True) else None}
    return out


def passed(judged: Dict[str, dict]) -> bool:
    return all(v["limit"] is None or v["value"] <= v["limit"] for v in judged.values())
