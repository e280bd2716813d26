"""Same-session maxIter throughput sweep.

Counterpart of the JAX package's ``scripts/maxiter_sweep.py``. More BP
iterations leave fewer shots to the OSD fallback; this measures, for each
maxIter, the decode throughput and the share of shot-bases BP left
unconverged in one session, pipelined as ``bench_cuda.py`` is (one window
of ``--seconds`` a configuration through ``utils.benchloop.timed_windows``,
two dispatches in flight, every configuration from one seed). Two
interleaved passes, so that drift of the card's rate hits every
configuration alike; then the best of the two.

An entry ``MI:VARIANT`` pins its own BP schedule (e.g. ``200:minsum
50:layered``); plain entries take every variant of ``--variant`` (a comma
list). ``--pooled`` runs the engine's default pooled schedule (OSD pooled
over the dispatch's rounds, chunk ``--osd-chunk`` or the round's
default), else the rounds of a dispatch run unpooled.

Usage (from the root of a checkout):

    python -m qldpc_tpu_torch.scripts.maxiter_sweep [maxIters...]
        [--code "[[144, 12, 12]]"] [--p 0.004] [--batch 1024] [--rpd 4]
        [--pooled] [--osd-chunk N] [--variant minsum[,layered]]
        [--seconds 6] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import torch

from .. import resolve_device
from ..parallel import engine
from ..utils.benchloop import timed_windows
from . import bases, build, card_line

MAXITERS = ("20", "30", "50")
OSD_ORDER = 2
SEED = 0


def parse_configs(maxiters, variants) -> list:
    """[(maxIter, variant)] in the order given: ``MI:VARIANT`` as pinned,
    a plain ``MI`` once for each of ``variants``."""
    configs = []
    for entry in maxiters:
        entry = str(entry)
        if ":" in entry:
            mi_s, v = entry.split(":")
            configs.append((int(mi_s), v))
        else:
            configs.extend((int(entry), v) for v in variants)
    return configs


def make_fn(dec_z, dec_x, n_locs: int, p: float, batch: int, mi: int,
            rpd: int, variant: str, pooled: bool, osd_chunk=None):
    """One configuration's dispatch(gen, randoms=None)."""
    if pooled and rpd > 1:
        return engine.make_pooled_round_fn(
            dec_z, dec_x, n_locs, p, batch, mi, OSD_ORDER, rpd,
            bp_variant=variant, osd_chunk=osd_chunk)
    base = engine.make_round_fn(dec_z, dec_x, n_locs, p, batch, mi,
                                OSD_ORDER, bp_variant=variant)
    return engine.make_scanned_round_fn(base, rpd)


def conv_counts(out) -> tuple:
    """(converged shot-bases, shot-bases) of a round's flags."""
    return (int(out["z_conv"].sum()) + int(out["x_conv"].sum()),
            len(out["z_conv"]) + len(out["x_conv"]))


def measure(fn, batch: int, rpd: int, seconds: float, device) -> tuple:
    """(shots/s of one window, unconverged share of every fetched
    round)."""
    stats = {"conv": 0, "tot": 0}

    def on_round(out):
        c, t = conv_counts(out)
        stats["conv"] += c
        stats["tot"] += t

    gen = torch.Generator(device=device).manual_seed(SEED)
    rate, _ = timed_windows(lambda i: fn(gen), batch * rpd, windows=1,
                            seconds=seconds, on_round=on_round)
    return rate, 1.0 - stats["conv"] / stats["tot"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("maxiters", nargs="*", default=None,
                    help="maxIter values; an entry may pin its own variant "
                         "as MI:VARIANT")
    ap.add_argument("--code", default="[[144, 12, 12]]")
    ap.add_argument("--p", type=float, default=0.004)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--rpd", type=int, default=4)
    ap.add_argument("--pooled", action="store_true",
                    help="the engine's default pooled schedule instead of "
                         "unpooled rounds")
    ap.add_argument("--osd-chunk", type=int, default=None,
                    help="pooled OSD chunk (None: the round's default)")
    ap.add_argument("--variant", default="minsum",
                    help="bp_variant: minsum | layered | tanh; a comma list "
                         "interleaves variants in the same session")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    configs = parse_configs(args.maxiters or MAXITERS,
                            args.variant.split(","))
    circ, M, _ = build(args.code, args.p, configs[0][0], OSD_ORDER, dev,
                       which="")
    fns = {}
    for mi, variant in configs:
        dz, dx = bases(circ, M, mi, OSD_ORDER, dev)
        fns[(mi, variant)] = make_fn(dz, dx, circ.num_error_locs, args.p,
                                     args.batch, mi, args.rpd, variant,
                                     args.pooled, args.osd_chunk)

    results = {c: [] for c in configs}
    uncs = {}
    for _ in range(2):
        for c in configs:
            rate, unc = measure(fns[c], args.batch, args.rpd, args.seconds,
                                dev)
            results[c].append(rate)
            uncs[c] = unc
            print(f"maxIter={c[0]} {c[1]}: {rate:8.1f} shots/s  "
                  f"unconverged={unc:.3f}", flush=True)
    print("\nbest-of-2 per config:")
    for c in configs:
        print(f"maxIter={c[0]} {c[1]}: {max(results[c]):8.1f} shots/s  "
              f"unconverged={uncs[c]:.3f}", flush=True)
    return {f"{mi}:{v}": dict(shots_per_sec=max(results[(mi, v)]),
                              unconverged=uncs[(mi, v)])
            for mi, v in configs}


if __name__ == "__main__":
    main()
