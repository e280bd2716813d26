"""Kernel-alone and per-call times of P1 and P2, for one checkout or two.

``device_ms`` times back-to-back wrapper calls, which at P2's shapes (and
P1's smaller ones) measures the host's issue rate, not the card. Here a
kernel's time is read apart from its host issue: ``graph_ms`` captures
``reps`` wrapper calls into one CUDA graph and replays it between CUDA
events. P1 is read at every case of ``gather_bench``'s ladder: the call
(``kernel_ms``), the same launch with no round (``load_store_ms``: the load,
the column sums and the store) and one round (``round_us``). P2 is read at
``P2_SHAPES``, float32, both axes: the kernel alone, a synchronised call on
the host clock (``wall_ms``), and ``torch.take_along_dim`` read both ways.

Usage (from the root of a checkout, on a machine with a GPU):

    python qldpc_tpu_torch/scripts/gather_timing.py [--root DIR]
        [--label NAME]

``--root`` imports ``qldpc_tpu_torch`` from another checkout (for instance
a parent commit unpacked by ``git archive``), which builds its own kernels
there, so that two versions are compared on one card in one call, in turns.
Prints the card's name and power limit, then one JSON object a case.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

# P2: the probe's largest and smallest float32 cases (the launch floor), and
# one large enough to be bound by its bytes
P2_SHAPES = ((1024, 128), (8, 128), (4096, 1024))


def graph_ms(fn, reps: int, device) -> float:
    """Mean device ms per call of ``fn`` with the host's issue taken out:
    one warm-up call, ``reps`` calls captured into a CUDA graph, one
    warm-up replay, then one replay between CUDA events."""
    fn()
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def p1_times(gather, x, idx, iters: int, device, reps: int = 20) -> dict:
    """P1's call, its load and store alone (no round) and one round."""
    kernel_ms = graph_ms(lambda: gather.gather_iterate(x, idx, iters), reps,
                         device)
    load_store_ms = graph_ms(lambda: gather.gather_iterate(x, idx, 0), reps,
                             device)
    return dict(kernel_ms=kernel_ms, load_store_ms=load_store_ms,
                round_us=(kernel_ms - load_store_ms) / iters * 1e3)


def p2_times(gather, wall_ms, x, idx, axis: int, device,
             reps: int = 100) -> dict:
    """P2 and ``torch.take_along_dim``, each alone on the card (graph) and
    per synchronised call on the host clock (``wall_ms``, the median)."""
    index = idx.long()

    def p2():
        return gather.take_along(x, idx, axis)

    def lib():
        return torch.take_along_dim(x, index, axis)

    return dict(kernel_ms=graph_ms(p2, reps, device),
                wall_ms=wall_ms(p2, 2 * reps, device),
                library_kernel_ms=graph_ms(lib, reps, device),
                library_wall_ms=wall_ms(lib, 2 * reps, device))


def round_wavefronts(idx, L: int, itemsize: int) -> int:
    """Shared-memory wavefronts of one P1 round in its busiest block, with
    the offsets in registers: a warp reads the gathered elements of 32
    consecutive tile elements (row * Lb + lane), which costs as many
    wavefronts as the most distinct 4-byte words any one of the 32 banks
    must serve (lanes on one word share it), and writes them back in one
    (32 elements of at most 4 bytes). At one wavefront a clock this is the
    round's conflict-aware floor."""
    idx = np.asarray(idx, dtype=np.int64)
    rows, lanes = idx.shape
    worst, seen = 0, None
    for l0 in range(0, lanes, L):
        cols = idx[:, l0:l0 + L]
        if seen is not None and np.array_equal(cols, seen[0]):
            continue  # the same columns cost the same
        Lb = cols.shape[1]
        n = rows * Lb
        i = np.arange(n)
        word = np.full(-(-n // 32) * 32, -1, np.int64)
        word[:n] = (cols[i // Lb, i % Lb] * Lb + i % Lb) * itemsize // 4
        w = np.sort(word.reshape(-1, 32), axis=1)
        first = np.ones_like(w, dtype=bool)
        first[:, 1:] = w[:, 1:] != w[:, :-1]
        keep = first & (w >= 0)
        group = np.broadcast_to(np.arange(len(w))[:, None], w.shape)
        per_bank = np.bincount((group * 32 + w % 32)[keep],
                               minlength=w.size).reshape(-1, 32)
        cost = int(per_bank.max(axis=1).sum()) + len(w)
        worst = max(worst, cost)
        seen = (cols, cost)
    return worst


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]),
                    help="checkout whose qldpc_tpu_torch to time")
    ap.add_argument("--label", default="",
                    help="name printed with every result")
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    from qldpc_tpu_torch import resolve_device
    from qldpc_tpu_torch.ops import gather
    from qldpc_tpu_torch.scripts import (card_line, gather_bench,
                                         gather_probe, wall_ms)
    dev = resolve_device("cuda")
    print(card_line(dev), flush=True)
    out = []
    for dtype, x, idx in gather_bench.ladder_inputs(device=dev):
        rec = dict(label=args.label, kernel="P1", shape=list(x.shape),
                   dtype=str(dtype).replace("torch.", ""),
                   **p1_times(gather, x, idx, args.iters, dev))
        print(json.dumps(rec), flush=True)
        out.append(rec)
    for shape in P2_SHAPES:
        for axis in (0, 1):
            x, idx = gather_probe.probe_inputs(shape, torch.float32, axis,
                                               dev)
            rec = dict(label=args.label, kernel="P2", shape=list(shape),
                       axis=axis,
                       **p2_times(gather, wall_ms, x, idx, axis, dev))
            print(json.dumps(rec), flush=True)
            out.append(rec)
    return out


if __name__ == "__main__":
    main()
