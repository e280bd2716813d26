"""Tracing of a ``--trace 1`` run: profiler ranges around the program's
stages, and the reduction of the profiler's trace to per-dispatch numbers.

The ranges are installed from the benchmark's side, in traced runs only:
``engine.trial_batch`` (sampling), ``_bp_one_basis`` (BP),
``_osd_fallback`` (OSD) and ``_logical_readout`` (readout) are each
wrapped in a ``torch.profiler.record_function`` of their stage's name; the
rest of ``engine`` is left as it is. A name the engine no longer has is
reported, and the metrics that read its stage are left out. The harness
adds a range around each dispatch's issue and one around the window.

The reduction reads the trace the profiler exports (Chrome's JSON format):
each device operation (kernel, copy, set) is charged, whole and wherever
it ran, to the stage range and to the dispatch range that were open on the
host when it was launched (matched through the launch's correlation id);
the device's busy time is the union of the operations' intervals inside
the window;
an idle gap is named after what the host was doing in its middle.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import json
from collections import defaultdict

STAGES = {"trial_batch": "sampling", "_bp_one_basis": "bp",
          "_osd_fallback": "osd", "_logical_readout": "readout"}
PREFIX = "perfbench."
WINDOW = PREFIX + "window"
DISPATCH = PREFIX + "dispatch."
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def stage_ranges(engine):
    """Wrap the engine's stage functions in profiler ranges for the body of
    the ``with``; yields the names the engine lacks."""
    from torch.profiler import record_function

    def wrap(fn, label):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return inner

    saved, missing = {}, []
    for name, stage in STAGES.items():
        fn = getattr(engine, name, None)
        if fn is None:
            missing.append(name)
            continue
        saved[name] = fn
        setattr(engine, name, wrap(fn, PREFIX + stage))
    try:
        yield missing
    finally:
        for name, fn in saved.items():
            setattr(engine, name, fn)


class _Ranges:
    """Non-overlapping host ranges of one kind, found by time."""

    def __init__(self, items):
        self.items = sorted(items)                 # (start, end, label)
        self.starts = [s for s, _, _ in self.items]

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.items[i][0] <= t <= self.items[i][1]:
            return self.items[i][2]
        return None


def _outermost(spans):
    """The spans (start, end, label) that no other span holds."""
    out, end = [], float("-inf")
    for s, e, label in sorted(spans, key=lambda x: (x[0], -x[1])):
        if s >= end:
            out.append((s, e, label))
            end = e
    return out


class Trace:
    """Per-dispatch numbers of a traced window (seconds)."""

    def __init__(self, events: list, stages_missing=()):
        window = [e for e in events if e.get("name") == WINDOW
                  and e.get("cat") == "user_annotation"]
        if not window:
            raise ValueError("the trace holds no window range")
        w = window[0]
        self.w0, self.w1 = w["ts"], w["ts"] + w["dur"]
        self.missing = {STAGES[n] for n in stages_missing}
        launch = {}                                 # correlation -> host ts
        annotations = []
        cpu_ops = []
        device = []
        for e in events:
            cat = e.get("cat")
            if cat in ("cuda_runtime", "cuda_driver"):
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch[corr] = e["ts"]
            elif cat == "user_annotation":
                annotations.append((e["ts"], e["ts"] + e.get("dur", 0),
                                    e["name"]))
            elif cat == "cpu_op":
                cpu_ops.append((e["ts"], e["ts"] + e.get("dur", 0),
                                e["name"]))
            elif cat in _DEVICE_CATS:
                device.append(e)
        self.dispatches = _Ranges(
            (s, t, int(n[len(DISPATCH):])) for s, t, n in annotations
            if n.startswith(DISPATCH))
        stage_names = {PREFIX + s for s in STAGES.values()}
        stages = _Ranges(a for a in annotations if a[2] in stage_names)
        # what the host ran, outermost: PyTorch ops and the program's ranges
        ops = _Ranges(_outermost(cpu_ops + [
            a for a in annotations if not a[2].startswith(PREFIX)]))
        # per dispatch: stage -> [device s, kernel launches]; kernel -> s
        self.stage = defaultdict(lambda: defaultdict(lambda: [0.0, 0]))
        self.kernels = defaultdict(lambda: defaultdict(float))
        self.device_ops = defaultdict(float)
        intervals = []
        for e in device:
            s, t = e["ts"], e["ts"] + e.get("dur", 0)
            if t >= self.w0 and s <= self.w1:
                intervals.append((max(s, self.w0), min(t, self.w1)))
                self.device_ops[e["name"]] += (min(t, self.w1)
                                               - max(s, self.w0)) / 1e6
            # a dispatch's operations are its own wherever they ran: the
            # window's first dispatch was issued before the window opened,
            # and part of its work may have run before then
            at = launch.get((e.get("args") or {}).get("correlation"))
            if at is None:
                continue
            d = self.dispatches.at(at)
            if d is None:
                continue
            self.kernels[d][e["name"]] += e.get("dur", 0) / 1e6
            label = stages.at(at)
            if label is not None:
                rec = self.stage[d][label[len(PREFIX):]]
                rec[0] += e.get("dur", 0) / 1e6
                rec[1] += e.get("cat") == "kernel"
        intervals.sort()
        busy, gaps, end = 0.0, [], self.w0
        for s, t in intervals:
            if s > end:
                gaps.append((end, s))
            if t > end:
                busy += t - max(s, end)
                end = t
        if end < self.w1:
            gaps.append((end, self.w1))
        self.busy_s = busy / 1e6
        self.window_s = (self.w1 - self.w0) / 1e6
        # idle time by what the host was doing in each gap's middle: the
        # stage (or whether a dispatch was being issued) and the host op
        idle = defaultdict(float)
        for s, t in gaps:
            mid = (s + t) / 2
            stage = stages.at(mid)
            where = (stage[len(PREFIX):] if stage else "between dispatches"
                     if self.dispatches.at(mid) is None else "dispatch")
            idle[f"{where}: {ops.at(mid) or 'python'}"] += (t - s) / 1e6
        self.idle = idle

    @classmethod
    def from_file(cls, path, stages_missing=()):
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events, stages_missing)

    def stage_mean(self, stage: str, dispatch_ids, field: int = 0):
        """Mean per dispatch of a stage's device seconds (``field`` 0) or
        kernel launches (1); None when the stage was not traced."""
        if stage in self.missing or not dispatch_ids:
            return None
        return sum(self.stage[d][stage][field]
                   for d in dispatch_ids) / len(dispatch_ids)

    def breakdown(self, top: int = 10) -> dict:
        def best(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(self.device_ops),
                "idle_gaps": best(self.idle)}
