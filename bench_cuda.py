#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: decoded shots/s per GPU on
[[144,12,12]].

The counterpart of ``bench.py``: the same configuration ([[144,12,12]],
12 cycles, p=0.004, 1024 shots a round, 4 rounds a dispatch with pooled
OSD, maxIter 50, OSD order 2, dynamical alpha), measured by the port's
``timed_windows`` (``qldpc_tpu_torch/utils/benchloop.py``) around
``make_pooled_round_fn``: the best of ``--windows`` windows of
``--seconds`` each, after an untimed first dispatch that builds the
kernels, with ``--depth`` dispatches in flight (2 by default, as the JAX
bench; a dispatch reads nothing back, so the host issues the next while
the card runs this one).

Prints the headline JSON line (metric, value, unit, vs_baseline) the moment
it is measured, then the full line with ``extra`` last:

- every window's rate (min, median, max and all): the host's share of a
  dispatch makes the rate swing between and within runs, so one window
  alone means little;
- the stage split of a dispatch from CUDA events (sample, BP, OSD,
  readout; ``qldpc_tpu_torch/profile_round.py``);
- the [[288,12,18]] figure (p=0.005, 256 shots a round, 2 rounds a
  dispatch, maxIter 200, one whole-pool OSD chunk), unless ``BENCH_288=0``;
- the card's name and power limit.

``vs_baseline`` divides by the native single-core decoder's trials/s (min-
sum BP + OSD in C++, ``qldpc_tpu_torch/native``; a trial decodes both
bases), measured once a host and configuration and cached in
``.bench_native_baseline.json``; without g++ it falls back to a pure-Python
min-sum rate x 75, as ``bench.py`` does.

Environment (as ``bench.py``): BENCH_MAXITER (50), BENCH_BATCH (1024),
BENCH_RPD (4), BENCH_BP_VARIANT (minsum | layered), BENCH_POOLED (1; 0
runs the rounds of a dispatch unpooled, each with its own OSD phase),
BENCH_288 (1), BENCH_288_BATCH (256), BENCH_288_RPD (2),
BENCH_288_MAXITER (200), BENCH_288_OSD_CHUNK (the whole pool).

    python3 bench_cuda.py [--seconds 8] [--windows 3] [--device cuda|cpu]
        [--code "[[144, 12, 12]]"] [--p 0.004] [--depth 2]

``--code`` and ``--p`` measure another registry code at its distance in
cycles under the same settings (the metric names the code).

Runs on the GPU; without one it exits non-zero unless ``--device cpu``
asks for the plain versions (then every rate is the host's).
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HEADLINE_CODE, HEADLINE_P = "[[144, 12, 12]]", 0.004


def metric_name(code_name: str) -> str:
    """``bench.py``'s metric name for the headline code."""
    return f"decoded_shots_per_sec_per_chip_{code_name.replace(' ', '')}"


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def estimate_python_baseline(H, prior, syndromes, maxIter=20) -> float:
    """Single-core pure-Python normalized min-sum trials/s (a scalar loop
    with the reference's per-trial decode structure): the fallback
    baseline without a C++ toolchain."""
    H = np.asarray(H) != 0
    m, n = H.shape
    rows = [np.nonzero(H[i])[0] for i in range(m)]
    t0 = time.time()
    for syndrome in syndromes:
        sgn_syn = 1.0 - 2.0 * syndrome
        Q = {(i, j): prior[j] for i in range(m) for j in rows[i]}
        for it in range(maxIter):
            alpha = 1.0 - 2.0 ** (-(it + 1))
            Rsum = np.zeros(n)
            R = {}
            for i in range(m):
                sgn = sgn_syn[i]
                m1 = m2 = np.inf
                i1 = -1
                for j in rows[i]:
                    v = Q[(i, j)]
                    sgn *= 1.0 if v >= 0 else -1.0
                    a = abs(v)
                    if a < m1:
                        m2, m1, i1 = m1, a, j
                    elif a < m2:
                        m2 = a
                for j in rows[i]:
                    sj = 1.0 if Q[(i, j)] >= 0 else -1.0
                    R[(i, j)] = alpha * sgn * sj * (m2 if j == i1 else m1)
                    Rsum[j] += R[(i, j)]
            values = Rsum + prior
            for i in range(m):
                for j in rows[i]:
                    Q[(i, j)] = np.clip(values[j] - R[(i, j)], -20, 20)
            hard = (values < 0).astype(np.int8)
            if np.array_equal((H @ hard) % 2, syndrome):
                break
    return len(syndromes) / (time.time() - t0)


def build(code_name: str, p: float, maxIter: int, osd_order: int, dev):
    """Code, circuit, matrices (cached in ``matrix_cache/``, the JAX
    package's format) and both decode bases with the dynamical schedule
    (``qldpc_tpu_torch.scripts.build``), and the schedule."""
    from qldpc_tpu_torch.ops.bp import alpha_schedule
    from qldpc_tpu_torch.scripts import build as build_bases

    circ, M, decs = build_bases(code_name, p, maxIter, osd_order, dev)
    return circ, M, decs, alpha_schedule("dynamical", maxIter)


def bench_config(code_name, p, batch, rpd, maxIter, osd_order, dev,
                 bp_variant="minsum", seconds=8.0, windows=3,
                 osd_chunk=None, depth=2):
    """Measured decode throughput of one configuration. Returns (best
    shots/s, every window's rate, errors seen, rounds fetched, (circ, M,
    decs, seq))."""
    import torch

    from qldpc_tpu_torch.parallel import engine
    from qldpc_tpu_torch.utils.benchloop import timed_windows

    circ, M, decs, seq = build(code_name, p, maxIter, osd_order, dev)
    n_locs = circ.num_error_locs
    if os.environ.get("BENCH_POOLED", "1") != "0" and rpd > 1:
        fn = engine.make_pooled_round_fn(decs[0], decs[1], n_locs, p, batch,
                                         maxIter, osd_order, rpd,
                                         bp_variant=bp_variant,
                                         osd_chunk=osd_chunk)
    else:
        fn = engine.make_scanned_round_fn(
            engine.make_round_fn(decs[0], decs[1], n_locs, p, batch, maxIter,
                                 osd_order, bp_variant=bp_variant), rpd)
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = [0]
    rates = []
    best, rounds = timed_windows(
        lambda i: fn(gen), batch * rpd, windows=windows, seconds=seconds,
        depth=depth, rates=rates,
        on_round=lambda out: errs.__setitem__(
            0, errs[0] + int(out["any_err"].sum())))
    if not 0 < errs[0] < rounds * batch * rpd:
        raise RuntimeError(f"{code_name}: degenerate flags, {errs[0]} "
                           f"errors in {rounds * batch * rpd} shots")
    return best, rates, errs[0], rounds, (circ, M, decs, seq)


def native_baseline(cache_file, cache_key, M, seq, maxIter, osd_order,
                    n_syn=48) -> float:
    """Measured single-core native C++ baseline (trials/s, both bases),
    cached per host and configuration in ``cache_file``."""
    key = f"{socket.gethostname()}:{cache_key}"
    try:
        with open(cache_file) as f:
            cache = json.load(f)
    except (OSError, ValueError):
        cache = {}
    if key in cache:
        return cache[key]
    from qldpc_tpu_torch.models.builder import channel_llrs
    from qldpc_tpu_torch.native.build import baseline_decode_native
    H = (np.asarray(M["HdecZ"]) != 0).astype(np.uint8)
    prior = channel_llrs(M["channel_probsZ"])
    rng = np.random.default_rng(0)
    errs = (rng.random((n_syn, H.shape[1]))
            < M["channel_probsZ"]).astype(np.int8)
    syns = ((errs @ H.T) % 2).astype(np.uint8)
    num_test = (osd_order + 10) if osd_order > 0 else 0
    rates = []
    for _ in range(3):
        native = baseline_decode_native(H, prior, syns, maxIter, seq,
                                        order=osd_order, num_test=num_test)
        if native is None:  # no toolchain: the python x75 estimate
            rates.append(75.0 * estimate_python_baseline(H, prior, syns[:2],
                                                         maxIter))
            break
        rates.append(len(syns) / native[0])
    rate = max(rates) / 2.0  # a reference trial decodes BOTH bases
    cache[key] = rate
    with open(cache_file, "w") as f:
        json.dump(cache, f)
    return rate


def window_stats(rates) -> dict:
    return dict(min=min(rates), median=statistics.median(rates),
                max=max(rates), all=list(rates))


def stage_split(objs, p, batch, rpd, maxIter, osd_order, bp_variant, dev,
                osd_chunk=None, dispatches=3) -> dict:
    """ms per dispatch of each stage from CUDA events (the GPU only)."""
    import torch

    from qldpc_tpu_torch.profile_round import stage_split as split
    circ, _, decs, _ = objs
    cfg = dict(p=p, batch=batch, rpd=rpd, maxIter=maxIter,
               osd_order=osd_order, bp_variant=bp_variant,
               osd_chunk=osd_chunk)
    gen = torch.Generator(device=dev).manual_seed(1)
    stages, staged_ms = split(decs, circ.num_error_locs, gen, cfg,
                              dispatches)
    return dict(stage_ms_per_dispatch=stages, staged_dispatch_ms=staged_ms,
                dispatches=dispatches)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=8.0,
                    help="length of a timing window")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits non-zero without a GPU) or "
                         "cpu (the plain versions)")
    ap.add_argument("--code", default=HEADLINE_CODE)
    ap.add_argument("--p", type=float, default=HEADLINE_P)
    ap.add_argument("--depth", type=int, default=2,
                    help="dispatches in flight")
    ap.add_argument("--baseline-cache",
                    default=os.path.join(ROOT, ".bench_native_baseline.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from qldpc_tpu_torch import resolve_device
    from qldpc_tpu_torch.scripts import card_line
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"bench_cuda: {e}")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    maxIter = int(os.environ.get("BENCH_MAXITER", "50"))
    batch = int(os.environ.get("BENCH_BATCH", "1024"))
    rpd = int(os.environ.get("BENCH_RPD", "4"))
    osd_order = 2
    bp_variant = os.environ.get("BENCH_BP_VARIANT", "minsum")
    p = args.p
    tag = args.code.replace(" ", "")

    sps, rates, _errs, _rounds, objs = bench_config(
        args.code, p, batch, rpd, maxIter, osd_order, dev,
        bp_variant=bp_variant, seconds=args.seconds, windows=args.windows,
        depth=args.depth)
    baseline = native_baseline(
        args.baseline_cache, f"{tag}_p{p:g}_maxIter{maxIter}_osd{osd_order}",
        objs[1], objs[3], maxIter, osd_order)
    log(f"baseline: measured native single-core {baseline:.1f} trials/s "
        "(both-basis decode)")
    head = {"metric": metric_name(args.code), "value": round(sps, 1),
            "unit": "shots/s",
            "vs_baseline": round(sps / baseline, 1)}
    print(json.dumps(head), flush=True)

    extra = {"card": card_line(dev),
             "config": dict(code=tag, cycles=objs[0].num_cycles, p=p,
                            batch=batch, rounds_per_dispatch=rpd,
                            maxIter=maxIter, osd_order=osd_order,
                            bp_variant=bp_variant,
                            pooled=os.environ.get("BENCH_POOLED", "1") != "0",
                            seconds=args.seconds, windows=args.windows,
                            depth=args.depth),
             "windows_shots_per_sec": window_stats(rates),
             "baseline_trials_per_sec": baseline}
    if dev.type == "cuda":
        extra[f"stages_{tag}"] = stage_split(
            objs, p, batch, rpd, maxIter, osd_order, bp_variant, dev,
            osd_chunk=None)
    del objs

    if os.environ.get("BENCH_288", "1") != "0":
        b288 = int(os.environ.get("BENCH_288_BATCH", "256"))
        rpd288 = int(os.environ.get("BENCH_288_RPD", "2"))
        mi288 = int(os.environ.get("BENCH_288_MAXITER", "200"))
        ch288 = int(os.environ.get("BENCH_288_OSD_CHUNK",
                                   str(b288 * rpd288)))
        sps288, rates288, _e, _r, o288 = bench_config(
            "[[288, 12, 18]]", 0.005, b288, rpd288, mi288, osd_order, dev,
            bp_variant=bp_variant, seconds=args.seconds,
            windows=args.windows, osd_chunk=ch288, depth=args.depth)
        base288 = native_baseline(
            args.baseline_cache,
            f"[[288,12,18]]_p0.005_maxIter{mi288}_osd{osd_order}", o288[1],
            o288[3], mi288, osd_order, n_syn=6)
        extra["[[288,12,18]]_p0.005_shots_per_sec"] = round(sps288, 1)
        extra["[[288,12,18]]_windows_shots_per_sec"] = window_stats(rates288)
        extra["[[288,12,18]]_maxIter"] = mi288
        extra["[[288,12,18]]_vs_baseline"] = round(sps288 / base288, 1)
        log(f"[[288]] baseline: {base288:.2f} trials/s; {sps288:,.0f} "
            "shots/s")
        if dev.type == "cuda":
            extra["stages_[[288,12,18]]"] = stage_split(
                o288, 0.005, b288, rpd288, mi288, osd_order, bp_variant, dev,
                osd_chunk=ch288, dispatches=2)

    print(json.dumps(dict(head, extra=extra)), flush=True)


if __name__ == "__main__":
    main()
