"""Kernel-study entry points of the port, the counterparts of the JAX
package's ``scripts/pallas_gather_bench.py``, ``pallas_gather_probe.py`` and
``bp_pallas_breakdown.py``:

    python -m qldpc_tpu_torch.scripts.gather_bench
    python -m qldpc_tpu_torch.scripts.gather_probe
    python -m qldpc_tpu_torch.scripts.bp_breakdown

Each runs on ``cuda`` by default and raises without a GPU; ``--device cpu``
runs the plain versions (times are then host times, not device metrics).
``gather_timing.py`` times P1 and P2 alone on the card (CUDA graphs), for
this checkout or, with ``--root``, another one's package;
``handoff_timing.py`` does the same for the OSD's hand-off: G1 and K2, K4
and K5 on G1's output, and the host's time a call of G1 and K2.
"""
from __future__ import annotations

import statistics
import subprocess
import time

import torch


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or a
    note that the run is on the CPU."""
    if device.type != "cuda":
        return "device: cpu (plain versions; no device metric)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return f"card: {smi[0].strip() if smi else 'unknown'}"


def device_ms(fn, reps: int, device: torch.device) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls after one warm-up
    call: CUDA events around the run on a GPU, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int, device: torch.device) -> float:
    """Median host ms per call of ``fn`` over ``reps`` calls, the device
    synchronised after each (so each includes the fixed per-call floor),
    after one warm-up call. The median, because host clocks on a shared
    machine have outliers."""
    def call():
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) * 1e3
    call()
    return statistics.median(call() for _ in range(reps))
