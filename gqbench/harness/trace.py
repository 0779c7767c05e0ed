"""A profiled window of steady steps and what the per-layer metrics read from
it.

The window runs under torch.profiler (host ops and device activity) and is
read from its chrome trace.  Each device event is tied to the host call
that launched it by its correlation id, and so to the host ops round that
call (innermost first) and to the benchmark's range (``gqbench::...``)
whose interval holds the launch, on any thread: the backward runs on the
autograd engine's thread while the benchmark's range stays open.  A device
event whose launch the trace does not hold takes the range and ops of the
device event before it on its stream.

torch.profiler drops a window's leading device events (up to about 3 ms on
the H100), so the window opens with ``PAD_CALLS`` spin kernels, left out of
every sum; a window that shows none of them is profiled again with longer
spins.  The first profiled step is a lead-in; the window measured is the
device time from the first event of the second step to the last event of
the last step.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from typing import Dict, List, Optional

import torch
from torch.autograd.profiler import record_function

from gqbench.harness import families
from gqbench.harness.program import STEP_SPAN, Session, bn_ranges

PAD_CALLS = 64
PAD_KEY = "spin_kernel"
PAD_CYCLES = (100_000, 1_000_000, 10_000_000)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")


class View:
    """What a metric reader may read: the measured steps' device events and
    ranges, the cell's configuration and mix, and the run's window."""

    def __init__(self, events: List[dict], steps: int, window_us: float, busy_us: float,
                 spec: dict, traffic: dict, run: dict):
        self.events = events          # dicts: name, start, dur (us), family, span, ops
        self.steps = steps
        self.window_us = window_us
        self.busy_us = busy_us
        self.spec = spec
        self.traffic = traffic
        self.run = run                # the measured run: samples_per_s, data_ms

    def span_ms(self, span: str) -> Optional[float]:
        """Device ms a step of the events launched under ``span``."""
        hit = [e["dur"] for e in self.events if e["span"] == span]
        return sum(hit) / self.steps / 1e3 if hit else None

    def family_ms(self, names) -> Optional[float]:
        hit = [e["dur"] for e in self.events if e["family"] in names]
        return sum(hit) / self.steps / 1e3 if hit else None

    def kernel_ms(self, names) -> Optional[float]:
        """Device ms a step of the kernels whose name holds one of ``names``."""
        hit = [e["dur"] for e in self.events
               if set(families.kernel_tokens(e["name"])) & set(names)]
        return sum(hit) / self.steps / 1e3 if hit else None


def _pad_window(cycles: int) -> None:
    for _ in range(PAD_CALLS):
        torch.cuda._sleep(cycles)
    torch.cuda.synchronize()


def profile(session: Session, steps: int, directory: str) -> dict:
    """``steps`` + 1 steps of ``session`` under the profiler, with the
    batch norms' ranges (the layers' are entered before the session is
    built: ``program.layer_spans``); returns the parsed trace (``parse``)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for cycles in PAD_CYCLES:
        with bn_ranges(session.model):
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _pad_window(cycles)
                for _ in range(steps + 1):
                    with record_function(STEP_SPAN):
                        session.step(spans=True)
                torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json", dir=directory)
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.remove(path)
        parsed = parse(trace["traceEvents"])
        if parsed["pads"] and parsed["events"]:
            return parsed
    raise RuntimeError(f"the profiler lost the device events of {len(PAD_CYCLES)} windows")


class _Ranges:
    """Host ranges of one thread, nested, for 'which ranges hold time t'."""

    def __init__(self, ranges):
        ranges.sort(key=lambda r: (r[0], -r[1]))
        self.starts = [r[0] for r in ranges]
        self.ranges = ranges
        self.parent = [-1] * len(ranges)
        stack = []
        for i, (s, e, _) in enumerate(ranges):
            while stack and ranges[stack[-1]][1] < e:
                stack.pop()
            self.parent[i] = stack[-1] if stack else -1
            stack.append(i)

    def chain(self, t: float) -> List[str]:
        """Names of the ranges holding ``t``, innermost first."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ranges[i][1] < t:
            i = self.parent[i]
        out = []
        while i >= 0:
            out.append(self.ranges[i][2])
            i = self.parent[i]
        return out


def parse(trace_events: List[dict]) -> dict:
    """Device events of a chrome trace with their launches' host ops and
    benchmark range and the index of the step that launched them."""
    launches, by_tid, spans = {}, collections.defaultdict(list), []
    device = []
    for e in trace_events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), ts)
        elif cat in HOST_CATS:
            name = e.get("name", "")
            by_tid[e.get("tid")].append((ts, ts + dur, name))
            if cat == "user_annotation" and name.startswith("gqbench::"):
                spans.append((ts, ts + dur, name))
    ranges = {tid: _Ranges(r) for tid, r in by_tid.items()}
    steps = sorted(s for s in spans if s[2] == STEP_SPAN)
    layer = [s for s in spans if s[2] not in (STEP_SPAN, families.BN_FORWARD)]
    device.sort(key=lambda e: float(e["ts"]))
    out, pads = [], 0
    last: Dict[object, dict] = {}
    for e in device:
        name = e.get("name", "")
        if PAD_KEY in name:
            pads += 1
            continue
        stream = (e.get("args") or {}).get("stream")
        launch = launches.get((e.get("args") or {}).get("correlation"))
        rec = dict(name=name, start=float(e["ts"]), dur=float(e.get("dur", 0.0)))
        if launch is not None:
            tid, t = launch
            rec["ops"] = ranges[tid].chain(t) if tid in ranges else []
            rec["span"] = next((n for s, f, n in layer if s <= t <= f), None)
            rec["step"] = next((i for i, (s, f, _) in enumerate(steps) if s <= t <= f), None)
        elif stream in last:
            prev = last[stream]
            rec.update(ops=prev["ops"], span=prev["span"], step=prev["step"])
        else:
            rec.update(ops=[], span=None, step=None)
        rec["family"] = families.classify(name, rec["ops"])
        last[stream] = rec
        out.append(rec)
    return dict(events=out, pads=pads, steps=len(steps))


def measured(parsed: dict, spec, traffic, run) -> View:
    """The View of the steps after the lead-in."""
    events = [e for e in parsed["events"] if e["step"] is not None and e["step"] >= 1]
    steps = parsed["steps"] - 1
    if not events or steps < 1:
        raise RuntimeError("the profiled window holds no device event of a measured step")
    start = min(e["start"] for e in events)
    end = max(e["start"] + e["dur"] for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for e in sorted(events, key=lambda e: e["start"]):
        s, f = e["start"], e["start"] + e["dur"]
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, f
        else:
            cur_e = max(cur_e, f)
    busy += cur_e - cur_s
    return View(events, steps, end - start, busy, spec, traffic, run)


def _label(e: dict, with_span: bool) -> str:
    op = e["ops"][0] if e["ops"] else "no_op"
    head = (e["span"] or "no_span") if with_span else e["family"]
    return f"{head}:{op}".replace(" ", "_")


def breakdown(view: View, top: int = 10) -> dict:
    """The device ops that took most time (by family and innermost op), and
    the longest idle gaps by the range and op that launched the event that
    ended them; seconds over the measured window."""
    ops = collections.Counter()
    for e in view.events:
        key = e["family"] if e["family"].startswith("K") else _label(e, False)
        ops[key.replace(" ", "_")] += e["dur"] / 1e6
    gaps = collections.Counter()
    end = None
    for e in sorted(view.events, key=lambda e: e["start"]):
        if end is not None and e["start"] > end:
            gaps[_label(e, True)] += (e["start"] - end) / 1e6
        f = e["start"] + e["dur"]
        end = f if end is None else max(end, f)
    return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
            "idle_gaps": [[k, v] for k, v in gaps.most_common(top)]}

