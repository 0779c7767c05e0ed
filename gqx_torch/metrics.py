"""Metric logging (counterpart of ``gqx/metrics.py``): CSV scalars (always)
+ TensorBoard events (when torch.utils.tensorboard is importable), with the
reference's tag/cadence parity — tags ``loss`` and ``accuracy(%)`` at step
``iteration * (epoch-1) + batch_idx`` (reference main.py:207-211,
logger.py:17-20) — plus gqx's extras (bytes on the wire).

File names, columns and tags are gqx's, so gqx's tools read the port's
logs and the other way round.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, logdir: Optional[str]):
        self.logdir = logdir
        self._csv = None
        self._writer = None
        self._tb = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self._csv = open(os.path.join(logdir, "scalars.csv"), "a", newline="")
            self._writer = csv.writer(self._csv)
            if self._csv.tell() == 0:
                self._writer.writerow(["tag", "value", "step", "wall_time"])
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:   # tensorboard is not installed: CSV only
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir=logdir)

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer:
            self._writer.writerow([tag, float(value), int(step), time.time()])
            self._csv.flush()
        if self._tb:
            self._tb.add_scalar(tag, float(value), int(step))

    def scalars(self, values: Dict[str, float], step: int) -> None:
        for tag, v in values.items():
            self.scalar(tag, v, step)

    def close(self) -> None:
        if self._csv:
            self._csv.close()
        if self._tb:
            self._tb.close()


def export_csv(logdir: str, out_path: Optional[str] = None) -> str:
    """Export scalars.csv to one CSV per tag (the reference's converter.py
    produces one CSV per tag from TB events); returns the written paths as
    a JSON list."""
    src = os.path.join(logdir, "scalars.csv")
    rows: Dict[str, list] = {}
    with open(src) as f:
        for rec in csv.DictReader(f):
            rows.setdefault(rec["tag"], []).append((int(rec["step"]), float(rec["value"])))
    out_path = out_path or logdir
    written = []
    for tag, vals in rows.items():
        safe = tag.replace("/", "_").replace("(", "").replace(")", "").replace("%", "pct")
        p = os.path.join(out_path, f"{safe}.csv")
        with open(p, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["step", tag])
            w.writerows(sorted(vals))
        written.append(p)
    return json.dumps(written)


def export_tree(root: str) -> list:
    """Walk a logs tree (the reference converter.py:54-68 walks
    ``logs/{model}/{dataset}/{quantizer}/``) and export per-tag CSVs for
    every run directory containing a scalars.csv."""
    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        if "scalars.csv" in filenames:
            out.extend(json.loads(export_csv(dirpath)))
    return out


if __name__ == "__main__":
    import sys

    root = sys.argv[1] if len(sys.argv) > 1 else "logs"
    for p in export_tree(root):
        print(p)
