"""Spans and counters inside the decode round, on the host's clock.

Off by default. ``enable()`` turns it on for the process; from then on
``span(name, **attrs)`` records, for each ``with`` block it opens, the name,
its start and end on ``time.perf_counter_ns()``, the innermost span open
around it (its parent) and the current dispatch, which
``dispatch(i, replay=False)`` sets for every span opened inside it.
``count(name, value)`` attaches a counter to the innermost open span: an
int, or a device tensor held by reference and never read while the round
is issued (no host read, no launch), reduced on the host by ``export()``
after the caller's window (by default to the sum of its elements).

Off, ``span`` and ``dispatch`` return one shared no-op object, and
``count`` returns at once: nothing is recorded, held or timed, and no
profiler range is entered. Spans are never profiler ranges; ``export()``
gives an anchor pair taken at ``enable()``, (``perf_counter_ns``,
``time_ns``), and ``to_trace_us``, which maps a span's time onto a
``torch.profiler`` Chrome trace's time base (its ``ts`` in microseconds;
the trace's ``ts + baseTimeNanoseconds / 1e3`` is Unix time in
microseconds), so the spans can be laid over the device's timeline.

At most ``cap`` spans are kept; past it a span is counted in ``dropped``
and its counters are discarded. One host thread issues the round; the
module is not thread-safe.
"""
from __future__ import annotations

import time
from typing import Optional

class _Off:
    """The shared span and dispatch of disabled telemetry."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()

_on = False
cap = 200_000
_spans: list = []     # [name, start, end, parent, dispatch, replay, attrs,
                      #  held counters, reduced counters]
_stack: list = []     # indices of the open spans, -1 for a dropped one
_dispatch: tuple = (None, False)
_dropped = 0
_anchor = (0, 0)


def enable():
    """Record from now on; takes the anchor pair."""
    global _on, _anchor
    _anchor = (time.perf_counter_ns(), time.time_ns())
    _on = True


def disable():
    """Stop recording; what was recorded stays until :func:`reset`."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset():
    """Forget every span and counter (open spans are closed unrecorded)."""
    global _dropped, _dispatch
    _spans.clear()
    _stack.clear()
    _dropped = 0
    _dispatch = (None, False)


class _Span:
    __slots__ = ("name", "attrs", "index")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        global _dropped
        if len(_spans) >= cap:
            _dropped += 1
            self.index = -1
        else:
            self.index = len(_spans)
            parent = _stack[-1] if _stack else -1
            _spans.append([self.name, time.perf_counter_ns(), None, parent,
                           _dispatch[0], _dispatch[1], self.attrs, None,
                           None])
        _stack.append(self.index)
        return self

    def __exit__(self, *exc):
        if self.index >= 0 and self.index < len(_spans):
            _spans[self.index][2] = time.perf_counter_ns()
        if _stack:
            _stack.pop()
        return False


def span(name: str, **attrs):
    """A context manager recording one span (the shared no-op when off)."""
    if not _on:
        return _OFF
    return _Span(name, attrs)


class _Dispatch:
    __slots__ = ("key", "saved")

    def __init__(self, key):
        self.key = key

    def __enter__(self):
        global _dispatch
        self.saved, _dispatch = _dispatch, self.key
        return self

    def __exit__(self, *exc):
        global _dispatch
        _dispatch = self.saved
        return False


def dispatch(i: int, replay: bool = False):
    """Spans opened inside carry dispatch ``i`` (and whether it is a
    replay); the shared no-op when off."""
    if not _on:
        return _OFF
    return _Dispatch((i, replay))


def count(name: str, value, reduce=None):
    """Add ``value`` (an int, or a tensor held as it is) to the innermost
    open span's counter ``name``. ``reduce`` maps a tensor's host copy to
    a number in :func:`export`; None sums its elements."""
    if not _on or not _stack or _stack[-1] < 0:
        return
    rec = _spans[_stack[-1]]
    if rec[7] is None:
        rec[7] = []
    rec[7].append((name, value, reduce))


def live_shots(pair) -> int:
    """``reduce`` of a device pair [lo, hi) of live shots: hi - lo, or 0."""
    lo, hi = (int(v) for v in pair.tolist())
    return max(0, hi - lo)


def _number(value, reduce):
    if hasattr(value, "cpu"):
        host = value.cpu()
        value = reduce(host) if reduce is not None else host.sum().item()
    return int(value) if float(value).is_integer() else float(value)


def to_trace_us(t_ns: int, base_ns: int = 0,
                anchor: Optional[tuple] = None) -> float:
    """A ``perf_counter_ns`` time as a profiler trace's ``ts`` (us), given
    the trace's ``baseTimeNanoseconds`` (0 where it has none)."""
    pc, epoch = _anchor if anchor is None else anchor
    return (t_ns - pc + epoch - base_ns) / 1e3


def export() -> dict:
    """The spans, each as a dict (name, start_ns, end_ns (None while open),
    parent (index or -1), dispatch, replay, attrs, counters), with
    ``dropped``, ``anchor`` and ``to_trace_us``. Held tensors are reduced
    here, once (the call waits for the device), and let go."""
    out = []
    for rec in _spans:
        if rec[7]:
            totals = rec[8] if rec[8] is not None else {}
            for name, value, reduce in rec[7]:
                totals[name] = totals.get(name, 0) + _number(value, reduce)
            rec[7], rec[8] = None, totals
        out.append(dict(name=rec[0], start_ns=rec[1], end_ns=rec[2],
                        parent=rec[3], dispatch=rec[4], replay=rec[5],
                        attrs=dict(rec[6]), counters=dict(rec[8] or {})))
    anchor = _anchor
    return dict(spans=out, dropped=_dropped, anchor=anchor,
                to_trace_us=lambda t_ns, base_ns=0: to_trace_us(
                    t_ns, base_ns, anchor))
