"""The pipelined throughput-measurement loop of the benchmarks.

Counterpart of the JAX package's ``utils/benchloop.py``: keep ``depth``
rounds in flight, align every timing window to a round completion so work
carried over from before its start is never credited to it, and take the
best of ``windows`` windows, returned with every window's rate. A fetch
materialises the round's outputs on the host (``.cpu()`` of every tensor,
the counterpart of ``jax.device_get``), so no window closes before the
outputs it counts exist.

A round here is issued by the host: ``launch(i)`` runs the round's host
code and queues its kernels. The engine's dispatches read nothing back
(their OSD is gated on device counts, ops/osd.py), so with ``depth`` 2 the
host issues the next round while the card runs the one before, and the
fetch of the oldest is where the host waits for the card. ``depth`` bounds
how many rounds are issued ahead of the oldest unfetched one.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, List, Optional, Tuple

import torch


def _to_host(out):
    """``out`` with every tensor copied to the host (dicts, lists and
    tuples are walked)."""
    if isinstance(out, torch.Tensor):
        return out.cpu()
    if isinstance(out, dict):
        return {k: _to_host(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_to_host(v) for v in out)
    return out


def timed_windows(launch: Callable, shots_per_round: int, *,
                  windows: int = 3, seconds: float = 8.0, depth: int = 2,
                  min_rounds: int = 3, on_round: Optional[Callable] = None,
                  rates: Optional[List[float]] = None) -> Tuple[float, int]:
    """Best-of-``windows`` pipelined throughput measurement.

    Args:
      launch: launch(i) -> the outputs of round i, possibly still being
        computed on the device (the caller seeds its own generators).
      shots_per_round: decoded shots per fetched round (for the rate).
      on_round: optional callback receiving every fetched round's host
        values (warm-up and alignment rounds included).
      rates: optional list that receives every window's rate, in order.

    Returns (best_shots_per_sec, total_rounds_fetched)."""
    inflight: deque = deque()
    launched = 0
    fetched = 0

    def pump():
        nonlocal launched
        while len(inflight) < depth:
            inflight.append(launch(launched))
            launched += 1

    def fetch():
        nonlocal fetched
        out = _to_host(inflight.popleft())
        fetched += 1
        if on_round is not None:
            on_round(out)
        return out

    pump()
    fetch()  # the first fetch carries the kernel builds; never timed
    got = []
    for _ in range(windows):
        pump()
        fetch()  # align the window start to a round boundary
        t0 = time.time()
        rounds = 0
        while time.time() - t0 < seconds or rounds < min_rounds:
            pump()
            fetch()
            rounds += 1
        got.append(rounds * shots_per_round / (time.time() - t0))
    if rates is not None:
        rates.extend(got)
    return max(got), fetched
