"""[[288,12,18]] OSD elimination probe: exit depths, width scaling, staged
coverage.

Counterpart of the JAX package's ``scripts/osd288_probe.py``. On one
batch's shots at p=0.005 it measures, for the posteriors of both BP
schedules (flooding, kernel K1; layered, kernel K3; maxIter sweeps):

1. the validity-exit depth distribution: the deepest column a shot
   pivoted on before its residual entered its pivot span, over the full
   prefix of K columns (mean, p50, p90, max), and the shots the prefix
   leaves uncovered;
2. the eliminator's time against the width: the full prefix and the
   stage-1 prefixes of ``PREFIXES`` (G1 packs each width; the eliminator's
   launch alone is timed, ``scripts.eliminate``);
3. prefix coverage: the shots each stage-1 prefix leaves uncovered (those
   the staged scan rescans at full width);
4. flooding against layered posteriors: better ordering, earlier exits.

The port's eliminators exit per shot, so a depth is the shot's own; the
JAX kernel's exit is its block's. The eliminator's own plan
(``osd_cuda.elim_launch_info``: shots a block, where the columns live)
replaces the JAX script's block sizing and row padding, and is printed for
each width.

Usage (from the root of a checkout):

    python -m qldpc_tpu_torch.scripts.osd288_probe [batch=256]
        [maxIter=50] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..ops import osd_cuda
from ..ops.bp_lift_cuda import decode_batch_lift_cuda
from ..ops.bp_lift_layered_cuda import decode_batch_lift_layered_cuda
from ..ops.sampler import trial_batch
from . import (build, card_line, eliminate, exit_depth, residual_order,
               timed, unsatisfied)

CODE, P = "[[288, 12, 18]]", 0.005
PREFIXES = (768, 1536)
REPS = 3
SEED = 0


def exit_stats(dec, cols, residual, Kx: int, reps: int, device) -> tuple:
    """(unsatisfied checks (B,), exit depth (B,), the eliminator's ms)
    after eliminating each shot's first ``Kx`` columns of ``cols``."""
    s_red, used, cf, ms = eliminate(dec, cols, residual, Kx, True, reps,
                                    device)
    return unsatisfied(s_red, used, dec.H.shape[0]), exit_depth(used, cf), ms


def plan_line(B: int, Kx: int, m: int, device) -> str:
    """The eliminator's plan for B shots of ``Kx`` columns by m rows."""
    W = -(-Kx // 32)
    S = osd_cuda.column_stride(W, m, device)
    txt = f"K={Kx}: {W} words, column stride {S}"
    if device.type == "cuda":
        info = osd_cuda.elim_launch_info(B, W, m, device,
                                         kernel=osd_cuda.selected_kernel())
        txt += (f", {info['shots_per_block']} shots a block, "
                f"{info['blocks']} blocks, columns in {info['columns_in']}")
    return txt


def probe(dec, syn, values, hard, prefixes, reps: int, device) -> dict:
    """Items 1-3 of the module docstring for one set of posteriors:
    {"depth": (B,) np, "unsat": (B,) np, "prefix": {K1: uncovered}, and the
    ms of the prep and of each elimination}."""
    B = syn.shape[0]
    K = dec.K
    (residual, order), t_prep = timed(
        "  prep: residual+sort+G1 pack",
        lambda: _prep(dec, syn, values, hard, K), reps, device, stat="mean",
        width=46)
    unsat, depth, ms = exit_stats(dec, order, residual, K, reps, device)
    print(f"{f'  eliminate full K={K}':46s} {ms:9.2f} ms", flush=True)
    d = depth.cpu().numpy()
    u = int((unsat != 0).sum())
    print(f"    exit depth: mean={d.mean():.0f} "
          f"p50={np.percentile(d, 50):.0f} p90={np.percentile(d, 90):.0f} "
          f"max={d.max()} uncovered={u}/{B}", flush=True)
    res = dict(depth=d, unsat=unsat.cpu().numpy(), prep_ms=t_prep,
               full_ms=ms, prefix={}, prefix_ms={})
    for K1 in prefixes:
        if K1 >= K:
            continue
        u1, _d1, ms1 = exit_stats(dec, order, residual, K1, reps, device)
        print(f"{f'  eliminate prefix K1={K1}':46s} {ms1:9.2f} ms",
              flush=True)
        res["prefix"][K1] = int((u1 != 0).sum())
        res["prefix_ms"][K1] = ms1
        print(f"    K1={K1}: uncovered {res['prefix'][K1]}/{B}", flush=True)
    return res


def _prep(dec, syn, values, hard, K: int) -> tuple:
    """Residual, reliability order and G1's pack of the K-column prefix:
    the OSD's work before its first elimination."""
    residual, order = residual_order(dec, syn, values, hard)
    osd_cuda.gather_pack(dec.col_index, order[:, :K], -(-K // 32) * 32)
    return residual, order


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=256)
    ap.add_argument("maxIter", nargs="?", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B, mi = args.batch, args.maxIter
    print(card_line(dev), flush=True)
    circ, _M, (dz,) = build(CODE, P, mi, 0, dev, which="Z")
    m, n = dz.H.shape
    print(f"{CODE} p={P} B={B} mi={mi} m={m} n={n} K={dz.K} "
          f"rank={dz.rank} eliminator {osd_cuda.selected_kernel()}")
    for Kx in (dz.K,) + tuple(k for k in PREFIXES if k < dz.K):
        print("  plan " + plan_line(B, Kx, m, dev), flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    syn = trial_batch(gen, P, dz.maps, dz.maps, circ.num_error_locs,
                      B)["syndrome_z"]
    out = {}
    for label, decode in (("flooding-f32 (K1)", decode_batch_lift_cuda),
                          ("layered-f32 (K3)",
                           decode_batch_lift_layered_cuda)):
        r = decode(dz.lifted, syn, dz.prior, dz.alpha_seq, mi)
        conv = float(r["converged"].sum()) / B
        print(f"--- {label} mi={mi}: converged {conv:.1%}", flush=True)
        out[label] = probe(dz, syn, r["values"], r["hard"], PREFIXES,
                           REPS, dev)
    return out


if __name__ == "__main__":
    main()
