"""Multi-code decode throughput: [[90,8,10]] and [[108,8,10]] decoded in
one dispatch.

Counterpart of the JAX package's ``scripts/multicode_bench.py``: every
code's rounds in one dispatch (``engine.make_multi_code_pooled_round_fn``,
each code's OSD pooled over the dispatch's rounds; at one round a dispatch
``engine.make_multi_code_round_fn``), p=0.004, maxIter 20, OSD order 2,
each code at its distance in cycles, one ``torch.Generator`` a code, timed
by ``utils.benchloop.timed_windows`` with two dispatches in flight (the best
of ``--windows`` windows of ``seconds``). The first dispatch, which builds
the kernels, gives the LER sanity figures. Prints the card's name and power
limit, then one JSON line with the JAX script's keys: per-code and combined
decoded shots/s.

Usage (from the root of a checkout):

    python -m qldpc_tpu_torch.scripts.multicode_bench [batch=1024] [rpd=4]
        [seconds=8] [--windows 3] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json

from .. import resolve_device
from ..parallel import engine
from ..parallel.mesh import generator
from ..utils.benchloop import timed_windows
from . import bases, card_line, peak_gib

CODES = ("[[90, 8, 10]]", "[[108, 8, 10]]")
P, MAX_ITER, OSD_ORDER = 0.004, 20, 2
SEED = 0


def build_specs(codes, p: float, batch: int, maxIter: int, osd_order: int,
                device, cycles: int = None) -> list:
    """The round specs of ``engine.make_multi_code_pooled_round_fn``: each
    code at its distance in cycles (or ``cycles``), its matrices cached in
    ``matrix_cache/``."""
    from .. import get_code
    from .bp_breakdown import cached_matrices
    specs = []
    for name in codes:
        code = get_code(name)
        circ, M = cached_matrices(code, cycles or code.distance, p)
        dz, dx = bases(circ, M, maxIter, osd_order, device)
        specs.append(dict(dec_z=dz, dec_x=dx, n_locs=circ.num_error_locs,
                          error_rate=p, batch=batch, maxIter=maxIter,
                          osd_order=osd_order))
    return specs


def make_dispatch(specs, rpd: int):
    """One dispatch of every code: unpooled at one round, else each code's
    OSD pooled over its ``rpd`` rounds (the engine's default)."""
    if rpd == 1:
        return engine.make_multi_code_round_fn(specs)
    return engine.make_multi_code_pooled_round_fn(specs, rpd)


def ler_sanity(outs) -> list:
    """Each code's share of shots with a logical error in one dispatch."""
    return [round(float(o["any_err"].float().mean()), 4) for o in outs]


def metric_name(codes) -> str:
    """The JAX script's metric name, from the codes' lengths."""
    short = "+".join(f"[[{c.strip('[]').split(',')[0]}]]" for c in codes)
    return f"multi_code_single_launch_{short}"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=1024)
    ap.add_argument("rpd", nargs="?", type=int, default=4)
    ap.add_argument("seconds", nargs="?", type=float, default=8.0)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    specs = build_specs(CODES, P, args.batch, MAX_ITER, OSD_ORDER, dev)
    fn = make_dispatch(specs, args.rpd)
    gens = [generator(SEED, 0, i, device=dev) for i in range(len(specs))]
    lers = ler_sanity(fn(gens))  # the build, a warm-up and the LER sanity
    per_code, _ = timed_windows(lambda i: fn(gens), args.batch * args.rpd,
                                windows=args.windows, seconds=args.seconds)
    out = {
        "metric": metric_name(CODES),
        "p": P, "batch_per_code": args.batch,
        "rounds_per_dispatch": args.rpd,
        "shots_per_sec_per_code": round(per_code, 1),
        "shots_per_sec_combined": round(len(specs) * per_code, 1),
        "ler_sanity": lers,
        "card": card_line(dev), "peak_memory_gib": peak_gib(dev),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
