"""Same-session A/B of the round schedules on one code configuration.

Counterpart of the JAX package's ``scripts/pooled_ab.py``. Configurations
(every one a dispatch of ``--rpd`` rounds, all drawn from one seed):

  scanned        - per-round OSD (``make_scanned_round_fn(make_round_fn)``)
  pooled         - cross-round OSD compaction (``make_pooled_round_fn``)
  pooled+layered - pooled, with the layered BP schedule (kernel K3)
  pooled@cN      - pooled with an OSD chunk of N shots (``osd_chunk=N``;
                   the default is ``engine.pooled_osd_chunk``'s)

The card's rate drifts with the host's share of a dispatch, so only deltas
within one session mean much: the configurations are interleaved
round-robin, ``--reps`` times, and each reports its best window
(``utils.benchloop.timed_windows``, two dispatches in flight). For each
pooled configuration the largest eliminator launch is printed (shots,
words, column bytes, and on the card the eliminator's plan), and on the
card each configuration's peak device memory. Prints the card's name and
power limit, a line a window, then one JSON line with the JAX script's
keys.

Usage (from the root of a checkout):

    python -m qldpc_tpu_torch.scripts.pooled_ab [--code "[[144, 12, 12]]"]
        [--p 0.004] [--batch 1024] [--rpd 4] [--maxiter 50]
        [--osd-order 2] [--seconds 8] [--reps 3] [--windows 3]
        [--configs ...] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from .. import resolve_device
from ..ops import osd_cuda
from ..parallel import engine
from ..utils.benchloop import timed_windows
from . import build, card_line, peak_gib, reset_peak

CONFIGS = ("scanned", "pooled", "pooled+layered")
SEED = 0


def osd_chunk(cfg: str):
    """The OSD chunk a ``pooled@cN`` configuration sets (None: the
    round's default, ``engine.pooled_osd_chunk``)."""
    return int(cfg.split("@c")[1].split("+")[0]) if "@c" in cfg else None


def make_config_fns(configs, dec_z, dec_x, n_locs: int, p: float,
                    batch: int, rpd: int, maxiter: int,
                    osd_order: int) -> dict:
    """{configuration: dispatch(gen, randoms=None)} for each name of
    ``configs`` (module docstring)."""
    fns = {}
    for cfg in configs:
        variant = "layered" if "layered" in cfg else "minsum"
        if cfg.startswith("pooled"):
            fns[cfg] = engine.make_pooled_round_fn(
                dec_z, dec_x, n_locs, p, batch, maxiter, osd_order, rpd,
                bp_variant=variant, osd_chunk=osd_chunk(cfg))
        else:
            base = engine.make_round_fn(dec_z, dec_x, n_locs, p, batch,
                                        maxiter, osd_order,
                                        bp_variant=variant)
            fns[cfg] = (base if rpd == 1
                        else engine.make_scanned_round_fn(base, rpd))
    return fns


def round_counts(out) -> tuple:
    """(shots with a logical error, shot-bases BP converged) of a round's
    flags."""
    return (int(out["any_err"].sum()),
            int(out["z_conv"].sum()) + int(out["x_conv"].sum()))


def osd_widths(dec) -> dict:
    """The OSD's eliminator widths in words: the staged scan's stage 1
    (``osd_batch``'s auto rule), the prefix, and the prefix with the
    column basis appended (the basis rerun)."""
    s1 = 768 if dec.K >= 2048 else 256 if dec.K >= 512 else 0
    out = {"stage1": -(-s1 // 32)} if 0 < s1 < dec.K else {}
    out["prefix"] = -(-dec.K // 32)
    out["full"] = -(-(dec.K + dec.basis_cols.numel()) // 32)
    return out


def chunk_plan(cfg: str, decs, pool: int, device, osd_order: int) -> str:
    """The largest eliminator launch of a pooled configuration: its chunk
    of shots at each width of each basis, the column bytes G1 writes for
    it, and on the card the eliminator's plan for it."""
    chunk = osd_chunk(cfg) or engine.pooled_osd_chunk(pool, decs, osd_order)
    chunk = min(chunk, pool)
    parts = []
    for name, dec in zip("ZX", decs):
        m = dec.H.shape[0]
        for width, W in osd_widths(dec).items():
            S = osd_cuda.column_stride(W, m, device)
            gb = chunk * 32 * W * S * 4 / 1e9
            txt = f"{name} {width} {W}w: {gb:.3f} GB"
            if device.type == "cuda":
                info = osd_cuda.elim_launch_info(
                    chunk, W, m, device, kernel=osd_cuda.selected_kernel())
                txt += (f" ({info['blocks']} blocks of "
                        f"{info['shots_per_block']} shots, columns in "
                        f"{info['columns_in']})")
            parts.append(txt)
    return f"{cfg}: chunk {chunk} of a {pool}-shot pool; " + "; ".join(parts)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--code", default="[[144, 12, 12]]")
    ap.add_argument("--p", type=float, default=0.004)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--rpd", type=int, default=4)
    ap.add_argument("--maxiter", type=int, default=50)
    ap.add_argument("--osd-order", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--windows", type=int, default=3,
                    help="timing windows a configuration takes per rep")
    ap.add_argument("--configs", nargs="*", default=list(CONFIGS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    circ, _M, decs = build(args.code, args.p, args.maxiter, args.osd_order,
                           dev)
    fns = make_config_fns(args.configs, *decs, circ.num_error_locs, args.p,
                          args.batch, args.rpd, args.maxiter, args.osd_order)
    for cfg in fns:
        if cfg.startswith("pooled"):
            print(chunk_plan(cfg, decs, args.batch * args.rpd, dev,
                             args.osd_order),
                  flush=True)

    best = {cfg: 0.0 for cfg in fns}
    convs, peaks = {}, {}
    for rep in range(args.reps):
        for cfg, fn in fns.items():
            errs = [0, 0]  # [errors, converged shot-bases]

            def on_round(out, errs=errs):
                e, c = round_counts(out)
                errs[0] += e
                errs[1] += c

            gen = torch.Generator(device=dev).manual_seed(SEED)
            reset_peak(dev)
            t0 = time.time()
            sps, nrounds = timed_windows(
                lambda i: fn(gen), args.batch * args.rpd,
                windows=args.windows, seconds=args.seconds,
                on_round=on_round)
            shots = nrounds * args.batch * args.rpd
            convs[cfg] = 1.0 - errs[1] / (2 * shots)
            best[cfg] = max(best[cfg], sps)
            peaks[cfg] = peak_gib(dev)
            mem = "" if peaks[cfg] is None else f", {peaks[cfg]:.2f} GiB peak"
            print(f"rep{rep} {cfg:16s}: {sps:9,.0f} shots/s "
                  f"({time.time() - t0:.0f}s, bp-unconv {convs[cfg]:.1%}"
                  f"{mem})", flush=True)
    out = {"config": vars(args), "best_shots_per_sec": best,
           "bp_unconverged_frac": convs, "card": card_line(dev),
           "peak_memory_gib": peaks}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
