"""Throughput of P1, the iterated gather over a tile kept on-chip, against
the torch.gather loop.

Counterpart of the JAX package's ``scripts/pallas_gather_bench.py``: the
same ladder of (rows, lanes), float32 and bfloat16, ``iters`` 30, and
inputs drawn from numpy's ``default_rng(0)`` in that script's order (x
standard normal, one row-index vector broadcast over the lanes). For each
case it prints the time of ``ops.gather.gather_iterate`` (kernel P1) and of
``gather_iterate_plain`` (the script's XLA line in PyTorch: ``iters``
torch.gather calls, adds and a column sum), each with the script's
GB/s-equivalent, rows * lanes * itemsize * iters / time.

Usage (from the root of a checkout):

    python -m qldpc_tpu_torch.scripts.gather_bench [--device cuda|cpu]
        [--shapes 1024x128,8192x128] [--iters 30] [--reps 20]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..ops.gather import gather_iterate, gather_iterate_plain
from . import card_line, device_ms

LADDER = ((1024, 128), (8192, 128), (32768, 128), (8192, 512), (35280, 128))
DTYPES = (torch.float32, torch.bfloat16)
ITERS = 30


def ladder_inputs(shapes=LADDER, device="cpu", seed: int = 0):
    """(dtype, x, idx) per case, dtypes outer and shapes inner, drawn in the
    JAX script's order; idx is int32 (rows, lanes)."""
    rng = np.random.default_rng(seed)
    for dtype in DTYPES:
        for rows, lanes in shapes:
            x = torch.as_tensor(rng.standard_normal((rows, lanes)),
                                device=device).to(dtype)
            idx_vec = rng.integers(0, rows, size=rows).astype(np.int32)
            idx = torch.as_tensor(idx_vec, device=device)[:, None] \
                .expand(rows, lanes).contiguous()
            yield dtype, x, idx


def _shapes(text: str):
    return tuple(tuple(int(v) for v in s.split("x")) for s in text.split(","))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shapes", type=_shapes, default=LADDER,
                    help="comma-separated ROWSxLANES (default: the ladder)")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    rows_out = []
    for dtype, x, idx in ladder_inputs(args.shapes, dev):
        rows, lanes = x.shape
        moved = rows * lanes * x.element_size() * args.iters
        name = str(dtype).replace("torch.", "")
        row = dict(dtype=name, rows=rows, lanes=lanes)
        for label, fn in (("P1", gather_iterate),
                          ("gather", gather_iterate_plain)):
            ms = device_ms(lambda: fn(x, idx, args.iters), args.reps, dev)
            row[f"{label}_ms"] = ms
            print(f"{label:6s} {name:9s} ({rows:6d},{lanes:4d}) "
                  f"{ms:8.3f} ms  {moved / ms / 1e6:8.1f} GB/s-equiv",
                  flush=True)
        rows_out.append(row)
    return rows_out


if __name__ == "__main__":
    main()
