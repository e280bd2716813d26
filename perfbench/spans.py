"""The program's own spans and counters (``qldpc_tpu_torch.utils.telemetry``)
read beside the device trace of a traced window.

A span's times are on the host's ``perf_counter_ns``; the telemetry's
anchor pair maps them onto the profiler trace's time base (``ts`` in
microseconds, ``baseTimeNanoseconds`` from the trace file). Spans nest, so
at every instant one program span is innermost. The reduction charges:

- each device idle gap of the window (the same gaps as ``trace.Trace``:
  the union of device operations clipped to the window) to the innermost
  span open at its middle (``idle_by_span``; "no span" where none is);
- each device operation, matched to its launch by correlation id, to the
  innermost span open when it was launched (device seconds and kernel
  launches by span).

It reads the trace file itself and leaves ``trace.Trace`` as it is.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

from .trace import PREFIX, STAGES, WINDOW, _DEVICE_CATS

NO_SPAN = "no span"


def load(path) -> tuple:
    """(events, baseTimeNanoseconds or 0) of a Chrome trace file."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        return data["traceEvents"], int(data.get("baseTimeNanoseconds", 0))
    return data, 0


def innermost(intervals) -> list:
    """Properly nested (start, end, key) -> sorted, disjoint (start, end,
    key) segments, each under the innermost interval open there."""
    segs, stack, cur = [], [], None

    def close_until(t):
        nonlocal cur
        while stack and stack[-1][1] <= t:
            _, e, k = stack.pop()
            if cur < e:
                segs.append((cur, e, k))
            cur = e

    for s, e, k in sorted(intervals, key=lambda x: (x[0], -x[1])):
        close_until(s)
        if stack and cur < s:
            segs.append((cur, s, stack[-1][2]))
        stack.append((s, e, k))
        cur = s
    close_until(float("inf"))
    return segs


class Timeline:
    """The innermost program span at a trace time."""

    def __init__(self, export: dict, base_ns: int = 0):
        self.spans = export["spans"]
        self.to_us = lambda t: export["to_trace_us"](t, base_ns)
        self.segs = innermost(
            (self.to_us(s["start_ns"]),
             self.to_us(s["end_ns"]) if s["end_ns"] is not None
             else float("inf"), i) for i, s in enumerate(self.spans))
        self.starts = [s for s, _, _ in self.segs]

    def at(self, t):
        """Index of the innermost span open at ``t`` (us), or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.segs[i][0] <= t <= self.segs[i][1]:
            return self.segs[i][2]
        return None

    def name(self, t) -> str:
        i = self.at(t)
        return NO_SPAN if i is None else self.spans[i]["name"]


def _window(events):
    for e in events:
        if e.get("name") == WINDOW and e.get("cat") == "user_annotation":
            return e["ts"], e["ts"] + e["dur"]
    raise ValueError("the trace holds no window range")


def idle_gaps(events) -> list:
    """The window's device idle gaps (start, end) in us, as
    ``trace.Trace`` finds them."""
    w0, w1 = _window(events)
    intervals = sorted(
        (max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1))
        for e in events if e.get("cat") in _DEVICE_CATS
        and e["ts"] + e.get("dur", 0) >= w0 and e["ts"] <= w1)
    gaps, end = [], w0
    for s, t in intervals:
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    if end < w1:
        gaps.append((end, w1))
    return gaps


class SpanTrace:
    """A traced window's device idle time and device work by program span
    (seconds), the idle time under the OSD stage's profiler range, and
    ``clock_offsets_us``: from each OSD stage range's start to the nearest
    ``osd`` span's, which opens just outside it (the mapping's check)."""

    def __init__(self, events: list, base_ns: int, export: dict):
        line = Timeline(export, base_ns)
        self.spans = line.spans
        self.idle = defaultdict(float)            # span name -> s
        self.idle_by_index = defaultdict(float)   # span index -> s
        stage = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                 for e in events if e.get("cat") == "user_annotation"
                 and e["name"] in {PREFIX + s for s in STAGES.values()}]
        stages = Timeline({"spans": [dict(name=n, start_ns=s, end_ns=t)
                                     for s, t, n in stage],
                           "to_trace_us": lambda t, b=0: t})
        # idle under the OSD stage's range, by whether an osd span is
        # innermost (trace.Trace names these gaps "osd: ...")
        self.osd_stage_idle = self.osd_stage_idle_in_osd_spans = 0.0
        for s, t in idle_gaps(events):
            mid, dur = (s + t) / 2, (t - s) / 1e6
            i = line.at(mid)
            name = NO_SPAN if i is None else self.spans[i]["name"]
            self.idle[name] += dur
            if i is not None:
                self.idle_by_index[i] += dur
            if stages.name(mid) == PREFIX + "osd":
                self.osd_stage_idle += dur
                if name == "osd" or name.startswith("osd.") or \
                        name == "elim":
                    self.osd_stage_idle_in_osd_spans += dur
        # the clock's check: each OSD stage range opens just inside an osd
        # span (us from the nearest osd span's start to the range's)
        starts = sorted(line.to_us(sp["start_ns"]) for sp in self.spans
                        if sp["name"] == "osd")
        self.clock_offsets_us = []
        for t0, _, name in stage:
            j = bisect.bisect_left(starts, t0)
            near = [starts[k] for k in (j - 1, j) if 0 <= k < len(starts)]
            if name == PREFIX + "osd" and near:
                self.clock_offsets_us.append(
                    min((t0 - x for x in near), key=abs))
        launch = {}
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver"):
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch[corr] = e["ts"]
        self.device = defaultdict(float)      # span index -> device s
        self.launches = defaultdict(int)      # span index -> kernels
        for e in events:
            if e.get("cat") not in _DEVICE_CATS:
                continue
            at = launch.get((e.get("args") or {}).get("correlation"))
            i = None if at is None else line.at(at)
            if i is None:
                continue
            self.device[i] += e.get("dur", 0) / 1e6
            self.launches[i] += e.get("cat") == "kernel"

    def idle_by_span(self, top: int = 10) -> list:
        """``[[span name, seconds], ...]``, most first, as
        ``Trace.breakdown`` gives its lists."""
        return [[k, v] for k, v in sorted(self.idle.items(),
                                          key=lambda kv: -kv[1])[:top]]


def in_dispatches(export: dict, ids) -> list:
    """Indices of the spans of the dispatches ``ids``."""
    ids = set(ids)
    return [i for i, s in enumerate(export["spans"]) if s["dispatch"] in ids]


def self_ns(export: dict) -> list:
    """Each span's host time less its children's (ns)."""
    spans = export["spans"]
    out = [0 if s["end_ns"] is None else s["end_ns"] - s["start_ns"]
           for s in spans]
    for s, own in zip(spans, list(out)):
        if s["parent"] >= 0:
            out[s["parent"]] -= own
    return out


def table(window: dict, unprofiled: dict, reduced, window_ids,
          unprofiled_ids) -> list:
    """Per span name: calls, host self ms (unprofiled pass), kernel
    launches, device ms and device idle ms while innermost (window), and
    the counters (window), each per dispatch. Rows in order of first
    appearance."""
    rows = {}
    nw, nu = max(1, len(set(window_ids))), max(1, len(set(unprofiled_ids)))
    own = self_ns(unprofiled)
    for i in in_dispatches(unprofiled, unprofiled_ids):
        s = unprofiled["spans"][i]
        r = rows.setdefault(s["name"], defaultdict(float))
        r["calls"] += 1 / nu
        r["host_self_ms"] += own[i] / 1e6 / nu
    for i in in_dispatches(window, window_ids):
        s = window["spans"][i]
        r = rows.setdefault(s["name"], defaultdict(float))
        if reduced is not None:
            r["launches"] += reduced.launches.get(i, 0) / nw
            r["device_ms"] += reduced.device.get(i, 0.0) * 1e3 / nw
            r["idle_ms"] += reduced.idle_by_index.get(i, 0.0) * 1e3 / nw
        for k, v in s["counters"].items():
            r[k] += v / nw
    return [dict(span=name, **r) for name, r in rows.items()]


def format_table(rows: list) -> str:
    cols = ("calls", "host_self_ms", "launches", "device_ms", "idle_ms")
    out = ["span            " + " ".join(f"{c:>12}" for c in cols)
           + "  counters (per dispatch)"]
    for r in rows:
        extra = ", ".join(f"{k} {v:.6g}" for k, v in r.items()
                          if k not in cols and k != "span")
        out.append(f"{r['span']:<16}" + " ".join(
            f"{r.get(c, 0.0):>12.4f}" for c in cols) + "  " + extra)
    return "\n".join(out)
