"""Where the time of one pooled dispatch goes, on the GPU.

Runs the bench configuration of the port ([[144,12,12]], 12 cycles,
p=0.004, 1024 shots per round, 4 rounds per dispatch, maxIter 50, OSD
order 2) and reports, for a few steady dispatches:

* stage times from CUDA events around the pieces a pooled dispatch runs
  (the draws and S1's syndromes, BP, pooled OSD, readout), summed over the
  dispatch;
* for each ``--pipeline-depth``: dispatches issued in turn with up to that
  many in flight, the oldest consumed by reading its outputs to the host,
  as the stopping loop and the bench do. Without the profiler: ms per
  dispatch, and the host's time split into issuing (inside the dispatch
  calls) and consuming (inside the reads of the oldest round). Under
  ``torch.profiler``: the device's busy share, time per kernel name, and
  the host's time inside synchronising CUDA calls (stream, device and
  event synchronisations and memory copies, every place the host waits for
  the card, inside a dispatch or not) apart from the rest, its issue;
* the eliminator's launches and device time per dispatch at each width
  the OSD runs it at, from the profiler range its wrapper opens around each
  launch (``osd_cuda.K2_RANGE``, ``K4_RANGE`` or ``K5_RANGE`` for
  ``--osd-kernel`` 1, 2 or 3, named by the width in words and
  ``full_jordan``), and the gather-pack G1's device time per dispatch (its
  kernel, ``gather_pack_kernel``).

Usage (from the root of a checkout, on a machine with an NVIDIA GPU):

    python -m qldpc_tpu_torch.profile_round [--dispatches 3] [--json PATH]
        [--bp-variant minsum|layered] [--osd-kernel 1|2|3]
        [--alpha-mode dynamical|alvarado|alvarado-autoregressive]
        [--pipeline-depth 1 2]
    python -m qldpc_tpu_torch.profile_round --cumulative [code] [p=0.004]
        [batch=512] [inflight=2] [--max-iter 20] [--device cuda|cpu]

``--cumulative`` is the JAX package's ``scripts/round_breakdown.py``: one
unpooled round of ``batch`` shots (the registry code at its distance in
cycles, OSD order 2, the pooled round's OSD chunk,
``engine.pooled_osd_chunk``) in cumulative variants, null
dispatch -> + sampling and syndromes of both bases -> + BP of both bases
(K1) -> + the residual sort -> + the OSD chunks (G1 and the eliminator,
each chunk gated on the device) -> the full round with the readout
(``engine.make_round_fn``). Each variant is timed in this one process,
``inflight`` dispatches in flight as the bench keeps them, each reduced to
one device scalar and read back oldest first; successive differences give
each stage's share of a dispatch's wall time (the CUDA-event split above
gives device time only).

``--bp-variant`` picks the BP schedule (flooding K1, layered K3) and
``--osd-kernel`` the eliminator generation (K2, K4, K5), as
``run_simulation(bp_variant=...)`` and ``QLDPC_OSD_KERNEL`` do;
``--alpha-mode`` fits each basis's alpha sequence on the device first, as
``run_simulation(alpha_mode=...)`` does (default trials, seed
``--seed``), and reports the calibration's seconds. The script reads
nothing of the engine beyond ``make_pooled_round_fn``, ``_osd_fallback``
and the stage functions, so it also profiles an earlier checkout's package
when copied into it (``--cumulative``'s residual sort also calls
``osd_cuda.bp_residual``, R1). Prints a summary, and the full report as
JSON to PATH when given.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import deque

import torch

from . import build_decoding_matrices, get_code, SyndromeCircuit
from .ops import osd_cuda
from .ops.sampler import trial_batch
from .parallel import engine
from .utils.benchloop import _to_host

# CUDA runtime calls in which the host waits for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpyAsync", "cudaMemcpy")


def _timed_dispatch(decs, n_locs, gen, cfg, acc):
    """One pooled dispatch with a CUDA-event timer around each stage."""
    dz, dx = decs

    def timed(name, fn):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn()
        e.record()
        acc.setdefault(name, []).append((s, e))
        return out

    rounds = []
    for _ in range(cfg["rpd"]):
        trials = timed("sample", lambda: trial_batch(
            gen, cfg["p"], dz.maps, dx.maps, n_locs, cfg["batch"]))
        per = []
        for name, dec in (("z", dz), ("x", dx)):
            syn = trials[f"syndrome_{name}"]
            bp = timed("bp", lambda: engine._bp_one_basis(
                syn, dec, cfg["maxIter"], bp_variant=cfg["bp_variant"]))
            per.append(dict(syn=syn, true_log=trials[f"true_{name}"],
                            values=bp["values"], hard=bp["hard"],
                            conv=bp["converged"]))
        rounds.append(per)
    flat = [{k: torch.cat([r[b][k] for r in rounds]) for k in rounds[0][b]}
            for b in (0, 1)]
    pool = flat[0]["syn"].shape[0]
    chunk = cfg.get("osd_chunk") or engine.pooled_osd_chunk(
        pool, decs, cfg["osd_order"])
    for st, dec in zip(flat, decs):
        delta = timed("osd", lambda: engine._osd_fallback(
            st["syn"], st["values"], st["hard"], st["conv"], dec,
            cfg["osd_order"], chunk))[0]
        timed("readout", lambda: engine._logical_readout(
            st["hard"], st["conv"], delta, dec))


def stage_split(decs, n_locs, gen, cfg, dispatches: int) -> tuple:
    """Stage ms per pooled dispatch from CUDA events (sample, bp, osd,
    readout; ``cfg`` as :func:`main` builds it, ``osd_chunk`` optional),
    averaged over ``dispatches`` steady dispatches, and the staged
    dispatch's host ms. The kernels must be built and warm."""
    acc: dict = {}
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(dispatches):
        _timed_dispatch(decs, n_locs, gen, cfg, acc)
    torch.cuda.synchronize()
    staged_ms = (time.time() - t0) * 1e3 / dispatches
    return ({k: sum(s.elapsed_time(e) for s, e in v) / dispatches
             for k, v in acc.items()}, staged_ms)


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def pipelined(fn, gen, dispatches: int, depth: int) -> dict:
    """``dispatches`` dispatches of ``fn(gen)`` with up to ``depth`` in
    flight, each consumed (read to the host) oldest first; the last ones
    are drained, so every dispatch issued is consumed. Returns the wall ms
    per dispatch and the host ms per dispatch inside the dispatch calls
    (issue) and inside the consumption (reading the oldest round)."""
    inflight: deque = deque()
    issue = consume = 0.0
    _sync()
    t0 = time.perf_counter()
    issued = 0
    while issued < dispatches or inflight:
        while issued < dispatches and len(inflight) < depth:
            t = time.perf_counter()
            inflight.append(fn(gen))
            issue += time.perf_counter() - t
            issued += 1
        t = time.perf_counter()
        _to_host(inflight.popleft())
        consume += time.perf_counter() - t
    wall = time.perf_counter() - t0
    return dict(dispatch_ms=wall * 1e3 / dispatches,
                issue_ms=issue * 1e3 / dispatches,
                consume_ms=consume * 1e3 / dispatches)


def profiled(fn, gen, dispatches: int, depth: int, elim_range: str) -> dict:
    """:func:`pipelined` under ``torch.profiler``: wall ms per dispatch,
    device busy ms and idle share, the host's ms per dispatch inside
    synchronising CUDA calls (``SYNC_CALLS``: its wait) and the rest (its
    issue), device ms per kernel name, and the eliminator's launches and
    device ms by width (its ``elim_range`` ranges)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = pipelined(fn, gen, dispatches, depth)["dispatch_ms"]
    kernels, widths, wait_us = {}, {}, 0.0
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None)
        if dt is None:
            dt = getattr(ev, "cuda_time_total", 0.0)
        on_device = ev.device_type is not None and \
            str(ev.device_type).endswith("CUDA")
        if ev.key.startswith(elim_range):
            # the host range holds its launches' kernels; a device-side
            # annotation of the same range, where the profiler makes one,
            # spans them: either gives the range's device time
            r = widths.setdefault(ev.key[len(elim_range) + 2:],
                                  dict(launches=0.0, ms=0.0))
            if not on_device:
                r["launches"] += ev.count / dispatches
            r["ms"] = max(r["ms"], dt / 1e3 / dispatches)
        elif dt and on_device:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dt / 1e3
        elif not on_device and ev.key in SYNC_CALLS:
            wait_us += ev.cpu_time_total
    busy = sum(kernels.values()) / dispatches
    wait = wait_us / 1e3 / dispatches
    g1 = sum(v for k, v in kernels.items()
             if k.startswith("gather_pack")) / dispatches
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    return dict(dispatch_ms=wall, device_busy_ms=busy,
                device_idle_share=1 - busy / wall, host_wait_ms=wait,
                host_issue_ms=wall - wait,
                kernel_ms_per_dispatch={k: v / dispatches for k, v in top},
                elim_by_width=widths or None, g1_ms=g1)


CUMULATIVE = ("null dispatch", "sample+syndrome both bases",
              "+ BP both bases", "+ residual sort", "+ OSD chunks",
              "FULL round (engine round_fn)")


def cumulative_fn(level: int, decs, n_locs: int, p: float, batch: int,
                  maxIter: int, osd_order: int = 2):
    """Variant ``level`` of :data:`CUMULATIVE` as ``fn(gen)`` -> one 0-d
    device tensor (every output the variant computes, summed)."""
    if level == 5:
        full = engine.make_round_fn(decs[0], decs[1], n_locs, p, batch,
                                    maxIter, osd_order)
        return lambda gen: sum(v.sum() for v in full(gen).values())
    chunk = engine.pooled_osd_chunk(batch, decs, osd_order)

    def run(gen):
        dev = decs[0].H.device
        if level == 0:
            return torch.randint(0, 1 << 30, (8,), generator=gen,
                                 device=dev).sum()
        trials = trial_batch(gen, p, decs[0].maps, decs[1].maps, n_locs,
                             batch)
        acc = []
        for name, dec in zip("zx", decs):
            syn = trials[f"syndrome_{name}"]
            if level == 1:
                acc.append(syn.sum() + trials[f"true_{name}"].sum())
                continue
            bp = engine._bp_one_basis(syn, dec, maxIter)
            conv, hard, values = bp["converged"], bp["hard"], bp["values"]
            if level == 2:
                acc.append(conv.sum() + hard.sum() + values.sum())
                continue
            if level == 3:
                res_wt = osd_cuda.bp_residual(syn, hard, dec.HT,
                                              dec.col_index)[1]
                order = torch.sort(torch.where(conv, syn.shape[1] + 1,
                                               res_wt), stable=True).indices
                acc.append(syn[order].sum() + values[order].sum()
                           + hard[order].sum() + conv[order].sum())
                continue
            delta = engine._osd_fallback(syn, values, hard, conv, dec,
                                         osd_order, chunk)[0]
            acc.append(delta.sum() + conv.sum())
        return sum(acc)
    return run


def cumulative(args) -> dict:
    """``--cumulative``: the variants' ms per dispatch, the stage
    differences and the round's shots/s; printed, and returned."""
    from . import resolve_device
    from .scripts import build, card_line
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    circ, _M, decs = build(args.code, args.p, args.max_iter, 2, dev)
    B = args.batch
    print(f"{args.code} p={args.p} B={B} inflight={args.inflight} "
          f"maxIter={args.max_iter}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    ms = []
    for level, name in enumerate(CUMULATIVE):
        fn = cumulative_fn(level, decs, circ.num_error_locs, args.p, B,
                           args.max_iter)
        _to_host(fn(gen))  # warm-up
        ms.append(pipelined(fn, gen, args.reps, args.inflight)["dispatch_ms"])
        print(f"{name:44s} {ms[-1]:9.2f} ms", flush=True)
    stages = ("sample", "BP", "sort", "OSD", "readout")
    deltas = {k: ms[i + 1] - ms[i] for i, k in enumerate(stages)}
    print("\ndeltas: " + " | ".join(f"{k} {v:.1f}"
                                    for k, v in deltas.items()) + " ms")
    print("shares of the full round: " + " | ".join(
        f"{k} {v / ms[-1]:.1%}" for k, v in deltas.items()))
    print(f"round throughput: {B / ms[-1] * 1e3:,.0f} shots/s", flush=True)
    return dict(variant_ms=dict(zip(CUMULATIVE, ms)), delta_ms=deltas,
                shots_per_s=B / ms[-1] * 1e3)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cumulative", action="store_true",
                    help="the cumulative variants of one round (the JAX "
                         "package's scripts/round_breakdown.py)")
    ap.add_argument("code", nargs="?", default="[[144, 12, 12]]")
    ap.add_argument("p", nargs="?", type=float, default=0.004)
    ap.add_argument("batch", nargs="?", type=int, default=512)
    ap.add_argument("inflight", nargs="?", type=int, default=2)
    ap.add_argument("--max-iter", type=int, default=20)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dispatches", type=int, default=3)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--json", help="write the full report here")
    ap.add_argument("--bp-variant", default="minsum",
                    choices=("minsum", "layered"))
    ap.add_argument("--osd-kernel", type=int, default=1, choices=(1, 2, 3))
    ap.add_argument("--alpha-mode", default="dynamical",
                    choices=("dynamical", "alvarado",
                             "alvarado-autoregressive"))
    ap.add_argument("--pipeline-depth", type=int, nargs="+", default=[1, 2],
                    help="dispatches in flight; each depth is measured")
    args = ap.parse_args(argv)
    if args.cumulative:
        return cumulative(args)
    if not torch.cuda.is_available():
        raise SystemExit("profile_round needs a CUDA GPU")
    dev = torch.device("cuda")
    cfg = dict(code="[[144, 12, 12]]", cycles=12, p=0.004, batch=1024, rpd=4,
               maxIter=50, osd_order=2, bp_variant=args.bp_variant,
               osd_kernel=args.osd_kernel, alpha_mode=args.alpha_mode)
    osd_cuda._KERNEL_VERSION = args.osd_kernel
    code = get_code(cfg["code"])
    circ = SyndromeCircuit(code, num_cycles=cfg["cycles"])
    M = build_decoding_matrices(circ, code.Lx, code.Lz, cfg["p"])
    torch.cuda.synchronize()
    t0 = time.time()
    seq_z, seq_x, _ = engine._calibrate_basis_sequences(
        M, cfg["p"], cfg["alpha_mode"], None, cfg["maxIter"],
        base_seed=args.seed, device=dev)
    torch.cuda.synchronize()
    calibration_s = time.time() - t0
    decs = [engine._make_basis(circ, M, b, seq, osd_order=cfg["osd_order"],
                               device=dev)
            for b, seq in (("Z", seq_z), ("X", seq_x))]
    n_locs = circ.num_error_locs
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    fn = engine.make_pooled_round_fn(decs[0], decs[1], n_locs, cfg["p"],
                                     cfg["batch"], cfg["maxIter"],
                                     cfg["osd_order"], cfg["rpd"],
                                     bp_variant=cfg["bp_variant"])
    fn(gen)  # warm-up: kernel builds, allocator
    torch.cuda.synchronize()

    stages, staged_ms = stage_split(decs, n_locs, gen, cfg, args.dispatches)

    elim = {1: "K2", 2: "K4", 3: "K5"}[args.osd_kernel]
    elim_range = osd_cuda._ELIM_KERNELS[elim][2]
    depths = {}
    for depth in args.pipeline_depth:
        pipelined(fn, gen, depth, depth)  # the allocator at this depth
        depths[depth] = dict(
            pipelined(fn, gen, args.dispatches, depth),
            profiled=profiled(fn, gen, args.dispatches, depth, elim_range))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    shots = cfg["batch"] * cfg["rpd"]
    report = dict(
        card=smi, config=cfg, dispatches=args.dispatches,
        calibration_s=calibration_s,
        alpha_seq={"z": [float(a) for a in seq_z],
                   "x": [float(a) for a in seq_x]},
        staged_dispatch_ms=staged_ms, stage_ms=stages, eliminator=elim,
        pipeline={d: dict(r, shots_per_s=shots / r["dispatch_ms"] * 1e3)
                  for d, r in depths.items()})
    print(f"card: {smi}")
    if cfg["alpha_mode"] != "dynamical":
        print(f"calibration ({cfg['alpha_mode']}) {calibration_s:.2f} s; "
              f"alpha z {min(seq_z):.4f}-{max(seq_z):.4f}, x "
              f"{min(seq_x):.4f}-{max(seq_x):.4f}")
    print("stages (ms per dispatch, CUDA events): " + ", ".join(
        f"{k} {v:.1f}" for k, v in stages.items())
        + f"; staged dispatch wall {staged_ms:.1f} ms")
    for depth, r in depths.items():
        pr = r["profiled"]
        print(f"depth {depth}: dispatch {r['dispatch_ms']:.1f} ms "
              f"({shots / r['dispatch_ms'] * 1e3:.0f} shots/s), host in "
              f"dispatch calls {r['issue_ms']:.1f} ms, in consumption "
              f"{r['consume_ms']:.1f} ms; profiled: dispatch "
              f"{pr['dispatch_ms']:.1f} ms, device busy "
              f"{pr['device_busy_ms']:.1f} ms, idle share "
              f"{pr['device_idle_share']:.3f}, host wait (synchronising "
              f"calls) {pr['host_wait_ms']:.1f} ms, host issue "
              f"{pr['host_issue_ms']:.1f} ms, G1 {pr['g1_ms']:.3f} ms")
        for k, v in pr["kernel_ms_per_dispatch"].items():
            print(f"  {v:9.3f} ms  {k[:90]}")
        widths = pr["elim_by_width"]
        if widths:
            print(f"  {elim} per dispatch by width (launches, device ms): "
                  + "; ".join(f"{w} {x['launches']:.1f}, {x['ms']:.3f}"
                              for w, x in widths.items())
                  + f"; total "
                  f"{sum(x['launches'] for x in widths.values()):.1f}, "
                  f"{sum(x['ms'] for x in widths.values()):.3f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
