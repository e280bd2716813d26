"""Where OSD-0 validity is reached in the reliability column order.

Counterpart of the JAX package's ``scripts/osd_margin_probe.py``. OSD-0
needs the residual syndrome (after BP's hard decisions) inside the span of
the pivot columns, not full rank: once it is, the reduced syndrome is
frozen and every later pivot carries correction bit 0, which is what lets
the eliminators exit early. On real BP-failed shots this reports the
fraction valid within the first K columns for each K of ``K_GRID``: the
prefix budget and the depth the validity exit should reach. Each K is its
own G1 pack of the first K columns in |LLR| order and one eliminator
launch on the residual (``scripts.eliminate``). BP is the padded-CSR
PyTorch-op decoder (``ops/bp.py``, bfloat16 messages, maxIter 20), as the
JAX script runs its XLA ``decode_batch``.

Usage (from the root of a checkout):

    python -m qldpc_tpu_torch.scripts.osd_margin_probe [code]
        [p=0.004] [batch=512] [rounds=4] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import resolve_device
from ..ops.bp import decode_batch
from ..ops.sampler import trial_batch
from . import build, card_line, eliminate, residual_order, unsatisfied

K_GRID = (256, 512, 768, 1024, 1280, 1536, 2048)
MAX_ITER, OSD_ORDER = 20, 2
SEED = 0


def valid_within(dec, order, residual, k_grid, device) -> dict:
    """{K: (B,) bool, the shot is valid after eliminating its first
    min(n, K) columns of ``order``}."""
    m, n = dec.H.shape
    out = {}
    for K in k_grid:
        s_red, used, _cf, _ms = eliminate(dec, order, residual, min(n, K),
                                          True, 0, device)
        out[K] = unsatisfied(s_red, used, m) == 0
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("code", nargs="?", default="[[144, 12, 12]]")
    ap.add_argument("p", nargs="?", type=float, default=0.004)
    ap.add_argument("batch", nargs="?", type=int, default=512)
    ap.add_argument("rounds", nargs="?", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B, p = args.batch, args.p
    print(card_line(dev), flush=True)
    circ, _M, (dz,) = build(args.code, p, MAX_ITER, OSD_ORDER, dev,
                            which="Z")
    m, n = dz.H.shape
    print(f"{args.code} p={p} B={B} m={m} n={n} rank={dz.rank}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    acc = {K: 0 for K in K_GRID}
    unconv = 0
    for r in range(args.rounds):
        t0 = time.time()
        syn = trial_batch(gen, p, dz.maps, dz.maps, circ.num_error_locs,
                          B)["syndrome_z"]
        bp = decode_batch(dz.graph, syn, dz.prior, dz.alpha_seq, MAX_ITER,
                          msg_dtype=torch.bfloat16)
        residual, order = residual_order(dz, syn, bp["values"], bp["hard"])
        valids = valid_within(dz, order, residual, K_GRID, dev)
        sel = ~bp["converged"]
        unconv += int(sel.sum())
        for K in K_GRID:
            acc[K] += int(valids[K][sel].sum())
        print(f"round {r}: {int(sel.sum())} unconverged, "
              f"{time.time() - t0:.1f}s", flush=True)
    print(f"\n{unconv} failed-BP shots")
    out = {}
    for K in K_GRID:
        frac = acc[K] / max(unconv, 1)
        p32 = 1.0 - frac ** 32   # a 32-shot block must scan past K
        p64 = 1.0 - frac ** 64   # a 64-chunk would need a basis rerun
        out[K] = frac
        print(f"K={K:5d}: valid={frac:8.4%}  P(32-block scans past)={p32:7.2%}"
              f"  P(64-chunk not all valid)={p64:7.2%}", flush=True)
    return dict(failed=unconv, valid_frac=out)


if __name__ == "__main__":
    main()
