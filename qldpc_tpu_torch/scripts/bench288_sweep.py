"""[[288,12,18]] same-session throughput sweep: batch x maxIter x rounds a
dispatch.

Counterpart of the JAX package's ``scripts/bench288_sweep.py``. The
[[288]] round is OSD-dominated, so the levers are more BP iterations (which
order the OSD's columns better, so the elimination exits earlier), a larger
batch over the fixed cost of a round, and rounds a dispatch. Every
configuration runs in one session, the OSD pooled over a dispatch's rounds
when there are several (the round's default chunk), each timed by
``utils.benchloop.timed_windows`` (best of ``--windows`` windows of
``--seconds``, two dispatches in flight). Prints the card's name and power
limit, a line a configuration with its peak device memory on the card,
then one JSON line with the JAX script's keys.

Usage (from the root of a checkout):

    python -m qldpc_tpu_torch.scripts.bench288_sweep [--p 0.005]
        [--seconds 10] [--windows 3] [--configs B,mi,rpd ...]
        [--device cuda|cpu]

(default configurations 256,200,2 512,200,2 512,400,1 256,400,2)
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from .. import resolve_device
from ..parallel import engine
from ..utils.benchloop import timed_windows
from . import bases, build, card_line, peak_gib, reset_peak

CODE = "[[288, 12, 18]]"
CONFIGS = ("256,200,2", "512,200,2", "512,400,1", "256,400,2")
SEED = 0


def make_fn(dec_z, dec_x, n_locs: int, p: float, B: int, mi: int,
            osd_order: int, rpd: int):
    """A configuration's dispatch: pooled OSD over ``rpd`` rounds, or one
    round."""
    if rpd > 1:
        return engine.make_pooled_round_fn(dec_z, dec_x, n_locs, p, B, mi,
                                           osd_order, rpd)
    return engine.make_round_fn(dec_z, dec_x, n_locs, p, B, mi, osd_order)


def round_stats(out) -> tuple:
    """(shots with a logical error, converged shot-bases, shots) of a
    round's flags."""
    return (int(out["any_err"].sum()),
            int(out["z_conv"].sum()) + int(out["x_conv"].sum()),
            out["any_err"].shape[0])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--p", type=float, default=0.005)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--osd-order", type=int, default=2)
    ap.add_argument("--configs", nargs="*", default=list(CONFIGS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    results = {}
    built = {}
    circ = M = None
    for cfg in args.configs:
        B, mi, rpd = (int(x) for x in cfg.split(","))
        if mi not in built:
            if M is None:
                circ, M, built[mi] = build(CODE, args.p, mi, args.osd_order,
                                           dev)
            else:
                built[mi] = bases(circ, M, mi, args.osd_order, dev)
        dec_z, dec_x = built[mi]
        fn = make_fn(dec_z, dec_x, circ.num_error_locs, args.p, B, mi,
                     args.osd_order, rpd)
        stats = [0, 0, 0]  # errors, converged shot-bases, shots

        def on_round(out, stats=stats):
            for i, v in enumerate(round_stats(out)):
                stats[i] += v

        gen = torch.Generator(device=dev).manual_seed(SEED)
        reset_peak(dev)
        t0 = time.time()
        sps, _n = timed_windows(lambda i: fn(gen), B * rpd,
                                windows=args.windows, seconds=args.seconds,
                                on_round=on_round)
        unconv = 1.0 - stats[1] / max(1, 2 * stats[2])
        ler = stats[0] / max(1, stats[2])
        peak = peak_gib(dev)
        results[cfg] = {"shots_per_sec": round(sps, 1),
                        "bp_unconverged": round(unconv, 3),
                        "ler": round(ler, 3), "peak_memory_gib": peak}
        mem = "" if peak is None else f", {peak:.2f} GiB peak"
        print(f"B={B} mi={mi} rpd={rpd}: {sps:8,.0f} shots/s  "
              f"unconv {unconv:.1%}  ler {ler:.3f}  "
              f"({time.time() - t0:.0f}s{mem})", flush=True)
    out = {"p": args.p, "results": results, "card": card_line(dev)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
