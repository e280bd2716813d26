#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (qldpc_tpu_torch).

Builds the hand-written CUDA kernels from qldpc_tpu_torch/csrc, holds each
against its plain PyTorch version on the card at the [[144,12,12]] shapes
of the main path, drives the port's paths (pooled BP+OSD Monte-Carlo rounds
and run_simulation at the bench configuration: [[144,12,12]], 12 cycles,
p=0.004, 1024 shots per round, 4 rounds per dispatch, maxIter 50, OSD
order 2) with the flooding and the layered BP schedule, under each
eliminator generation, with calibrated alpha sequences, damping and tanh
BP, and prints one JSON result line last.

Run from the root of a checkout on a machine with an NVIDIA GPU and the CUDA
toolkit:

    python3 chip_smoke.py

Phases: (1) device and build of all ten kernels (an eliminator, G1, P1
or R1 instance that spills fails), (2) the sampling kernel S1 vs its plain
version (fault bits and the float32 signature product, both frames) bit
for bit, with its time beside its byte bound and the two products alone,
then flooding BP kernel
K1 vs its plain version, with its registers, state bytes and shots per SM,
then the BP residual kernel R1 vs its plain version (the float32 product)
bit for bit on K1's hard decisions of a pool of 4x1024 shots, both bases,
with its time alone beside its byte bound, the plain version's and the
product's,
(3) GF(2) elimination kernel K2 on G1's column pack vs its plain
(words-major) version at the stage-1, prefix and full widths, with and
without the reduced matrix, with its launch shape, its time per column
step and the share of its load and store, its device-memory branch
(G1's output eliminated in place) forced at stage 1 vs its shared-memory
launch, and K2
at [[288,12,18]] (B=37, three row words a lane, device memory) vs its plain
version at stage 1, the prefix and the basis rerun's width (the prefix with
the column basis appended), (4) main path (flooding, S1 + K1 + R1 + K2;
one S1 launch a round, one R1 launch a basis; its flags equal to those of
the same dispatch through every plain version, which launches no kernel),
(5) layered
BP kernel K3 vs its plain version and vs K1 on the same syndromes, with
K3's shape and ms per sweep, then K1's and K3's device-memory branch
(forced) vs their shared-memory launches, and K1 and K3 at [[288,12,18]]
(state in shared memory, one block per SM) vs their plain versions, (6)
eliminator kernels
K4 (four pivots per team barrier) and K5 (two shots a team) vs their plain
versions and K2's at the three widths, with their launch shapes, times per
column step beside K2's, their device-memory branch forced at stage 1, and
both at [[288,12,18]] (B=37, stage 1 and prefix), (7) layered path (K3 +
K2), (8) the
main path (a pooled dispatch and run_simulation) under QLDPC_OSD_KERNEL=2
and 3 (K1 + K4, K1 + K5), (9) the gather_bench entry point (P1, the
iterated on-chip gather) and P1 vs its plain version at every case of its
ladder, with its time alone on the card (CUDA graphs), its load and store
(no round), its round beside the conflict-free bound and the
conflict-aware floor of this run's indices, its plan (lanes a block,
cluster size, threads) and the clusters the card holds at once, and every
cluster size at (35280, 128), (10) the gather_probe entry point (P2,
take-along-axis) and P2 vs its plain version and torch.take_along_dim at
every probe case, with P2 and take_along_dim alone on the card, P2's launch
floor at (8, 128) and a call on the host clock, (11) the
bp_breakdown entry point at [[144,12,12]], B=1024 (K1), (12) the main
path's run_simulation against two matched JAX LER records ([[144,12,12]]
p=0.004 maxIter 20 to 200 errors, [[72,12,6]] p=0.004 maxIter 50 to 100),
within 3 sigma, (13) the padded-CSR BP decoder (ops/bp.py) on the card
against itself on the CPU at [[144,12,12]] basis Z (iid p=0.004 errors,
B=128, maxIter 50): float32 bit for bit, damping 0.8 and tanh on every
decision, bfloat16 by its count of differing shots; and K1 against its
plain version under a fitted Alvarado alpha, (14) the slice's full-width
path: run_simulation with alpha_mode="alvarado-autoregressive" (calibration
on the card, then K1 + K2 with the fitted sequences) against the matched
JAX record (0.119, 200/1686) within 3 sigma, K1 against its plain version
under the fitted sequence, alpha_mode="alvarado" with scopt=True (alpha in
(0.05, 1.5), beta < 0), and one 4096-shot dispatch each with damping 0.8
and with tanh BP (K2 and no K1), (15) the multi-code path at full width
([[90,8,10]] + [[108,8,10]], 10 cycles, p=0.004, maxIter 20, OSD order 2,
1024 shots a round, 4 rounds a dispatch): K1 (both bases) and K2 (stage 1,
prefix, full width) of each code against their plain versions, one pooled
multi-code dispatch against each code's own dispatch on the same seeds,
run_multi_code_simulation to 200 errors a code against the JAX records
(VALIDATION.md:15, :17) within 3 sigma, launching K1, R1 and K2 only
(R1 once a basis and code a dispatch), and a
fixed three-dispatch run for the steady shots/s, (16) the shot mesh on the
card: multihost_smoke --device cuda (two processes sharing the card in one
gloo group against one process holding two shards, dynamical and
calibrated), and a one-rank NCCL group whose run_simulation (all_reduce,
all_gather and broadcast on CUDA tensors) equals the run without a group,
(17) BatchDecoder at the bench configuration: phase 4's dispatch randoms
decoded through BatchDecoder.decode in each basis (batch_size 1024), with
the flooding and the layered schedule, equal to the pooled dispatches of
phases 4 and 7 shot for shot (error, converged, rank_deficient), K1 or K3,
R1 and K2 alone, (18) run_code_capacity on the Steane code (p=0.005, 10,000
shots: LER < 0.01, converged > 0.9) and the code-capacity round on the
card against the CPU on the same draws (Steane, and [[144,12,12]]'s Hz
with Lx at p=0.05, B=1024; K2 launched), (19) bench_cuda.py as a
subprocess (two 2-second windows, no [[288]]): its headline line first and
its full line last, (20) python -m qldpc_tpu_torch on [[72,12,6]] p=0.006
maxIter 20 to 100 errors against the JAX record (VALIDATION.md:12) within
3 sigma, its results.npz loaded, and the explainer gallery on the card,
(21) the LER validation sweep's entry point (scripts/validate_ler.py's
main, gated autoregressive alpha, maxIter 50) at two points held against
the JAX package's records within 3 sigma: [[288,12,18]] p=0.005 to 200
errors end to end (calibration, K1, K2 with its basis rerun, the stopping
loop) and [[144,12,12]] p=0.004 with layered BP to 150 errors (K3 and
K2), with no rank-deficient shot-basis, (22) the asynchronous round: the
gather-pack kernel G1 (every OSD path packs its eliminator input with it,
in the eliminators' column bitsets) against its plain version at the
stage-1, prefix and full widths of [[144,12,12]] and at [[288,12,18]]'s
basis-rerun width, over whole batches and partial ranges, gated to nothing
(it writes nothing), alone on the card beside its byte bound, and the
host's time a call of G1 and K2; K2, K4 and K5 gated to a
range of shots against their ungated launch on the live shots, and a
launch gated to nothing timed (the gate's cost); one steady pooled
dispatch under torch.cuda.set_sync_debug_mode("error") (no host read),
its flags equal to phase 4's shot for shot, and again with the program's
telemetry on (its spans and held counters: no host read, no launch, the
same flags), and the eliminators' profiler ranges under a profiler; and
run_simulation at the
bench configuration with one and with two dispatches in flight, on one
seed, with identical tallies, (23) the bench sweeps and the OSD studies
(the entry points of qldpc_tpu_torch/scripts that port the JAX package's
scripts of the same names), each at full width for a short time, its
output captured and its result line and launches printed:
multicode_bench (K1, G1, K2), pooled_ab (scanned, pooled, pooled+layered,
pooled@c512: K1, K3, G1, K2), maxiter_sweep, bench288_sweep (256,200,2),
scaling_bench (1 and 2 shards), osd144_stage_ab and osd288_ab (one
maxIter, two stage-1 widths, sums independent of the width),
osd288_probe (K1, K3, G1, K2), osd_margin_probe at [[144,12,12]] and
[[288,12,18]] (G1, K2), osd_microbench under QLDPC_OSD_KERNEL=1, 2 and 3
(G1 with K2, K4, K5; equal valid counts) and bp_lift_bench (K1); the
studies' statistics (stage sums, exit depths, stage-1 coverage, valid
shots within each K, the basis rerun's outputs) on the card against the
plain versions on the same BP-failed posteriors at [[144,12,12]] and
[[288,12,18]]; and every pooled@cN flag equal to the default chunk's on one
dispatch's draws, (24) the last JAX-side scripts: ler_oracle's decode of
the committed reference-sampled [[90,8,10]] trials (4,000, maxIter 20 and
50; K1, G1, K2) against the JAX package's per-trial flags (|z| <= 3), the
first 64 trials equal to the plain path's; profile_round --cumulative at
the bench configuration (its BP and OSD chunks equal to the plain
versions on 256 shots); osd_batch's prefixes (osd_microbench) on the card
equal to the plain versions on 16 failed shots; osd_post_micro (its ops
equal on the card and the CPU); bp_microbench (K1 and the padded-CSR loop
equal to the plain versions); and bp_lift_bench --layered at
[[288,12,18]] (K1 and K3 equal to their plain versions there), (25) the
eliminators' block shape: K2, K4 and K5 at block_shots 1, 2, 4 and 8 (K5
also 16) and at shared-memory budgets of one team and below one team on
phase 3's inputs ([[144,12,12]] stage 1, prefix and full width,
[[288,12,18]]'s basis rerun), every output equal to the plain version's
and the default plan's and the library's plan equal to make_plan's clamps,
each setting's launch alone at [[144]]; every eliminator launch of phase
4's pooled dispatch under K2, K4 and K5 asking for no block shape and
taking make_plan's old rule (its flags phase 4's), and pick_block_shots
equal to the library's plan there; and the four entry points that set the
block shape or were left out, at full width for one short pass each:
osd_blockshots_sweep ([[144]], K1, G1, K2; consumed outputs identical
across block shapes), osd288_tailblock_ab ([[288]], the default, one-team
and 64-KB tail budgets; identical outputs), osd_panel_probe (K2 at 8, 16
and 40 words; the panel-entry transform's bfloat16 products equal to its
integer XOR version on the card) and bp_grid_experiment (the grid decoder
on the card against the padded-CSR decoder there: hard decisions,
convergence and iterations equal).
Each path runs with every launch count set to 0 just before it and read
just after; every path that runs OSD launches G1 beside its eliminator.
Exits non-zero, and prints
no result, without a GPU, outside a checkout, or when any phase fails.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import torch

SEED = 2024
CODE, CYCLES, P = "[[144, 12, 12]]", 12, 0.004
BATCH, RPD, MAXITER, OSD_ORDER = 1024, 4, 50, 2
MAX_TRIALS = 16384
# the largest code K1 and K3 run from shared memory, checked on a small batch
CODE_288, CYCLES_288, BATCH_288 = "[[288, 12, 18]]", 18, 37
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
K1_OPS_PER_EDGE_ITER = 17   # float32 ops per live edge per iteration
# K1's first design (one 1024-thread block per shot, R stored in shared
# memory, neighbour tables read from L2), timed by this script at B=1024,
# maxIter 50 (ms per basis call) and by bp_breakdown (ms per iteration) on
# NVIDIA H100 80GB HBM3, 700.00 W
K1_EARLIER_MS = {"Z": 7.105, "X": 7.368}
K1_EARLIER_PER_ITER_MS = 0.1847
K2_OPS_PER_ROW_STEP = 5     # int ops per row per column step (the scan)
K2_OPS_PER_XOR_WORD = 1     # int ops per word a pivot row is XORed into
SMEM_BYTES_PER_CLK_SM = 128  # H100 shared-memory bandwidth per SM
# float32 ops per live edge per sweep: one check update (~14), two
# posterior rebuilds (2 adds) and one parity test (2)
K3_OPS_PER_EDGE_SWEEP = 18
# [[144,12,12]] p=0.004 dynamical, the reference's archived LER
ARCHIVE_LER, ARCHIVE_TRIALS = 200 / 1135, 1135
LER_MAX_TRIALS = 200_000  # phase 12's cap; its targets take a few thousand
GENERIC_B = 128  # phase 13's shots (the calibration input, iid errors)
BF16_MAX_DIFFERING = 6  # phase 13: bfloat16 shots allowed to differ
# [[144,12,12]] p=0.004 gated autoregressive alpha, maxIter 50, OSD order 2:
# the JAX package's record (VALIDATION.md:106)
AR_REF_ERRS, AR_REF_TRIALS = 200, 1686
# phase 15: the multi-code configuration (scripts/multicode_bench.py), and
# the JAX package's dynamical maxIter-20 records of its two codes
MC_CODES = ("[[90, 8, 10]]", "[[108, 8, 10]]")
MC_CYCLES, MC_MAXITER = 10, 20
MC_REF = {"[[90, 8, 10]]": (200, 918, "VALIDATION.md:15"),
          "[[108, 8, 10]]": (200, 1191, "VALIDATION.md:17")}
MC_STEADY_DISPATCHES = 3  # the fixed-length run that gives steady shots/s
# phase 20: the CLI at the JAX package's dynamical maxIter-20 record
# (VALIDATION.md:12: [[72,12,6]] p=0.006, 0.595 = 200/336)
CLI_CODE, CLI_P, CLI_ERRORS = "[[72, 12, 6]]", 0.006, 100
CLI_REF_ERRS, CLI_REF_TRIALS = 200, 336
# phase 21: two points of the LER validation sweep (validate_ler's main,
# gated autoregressive alpha, maxIter 50) and the JAX package's records of
# them: (code, p, BP schedule, target errors, JAX errors, JAX trials, file)
SWEEP_POINTS = (
    (CODE_288, 0.005, "minsum", 200, 200, 527, "validation_rest_mi50.json"),
    (CODE, 0.004, "layered", 150, 150, 1458, "validation_layered_mi50.json"),
)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(nbytes: float, ops: float) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device visible")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import numpy as np

        import qldpc_tpu_torch as qt
        from qldpc_tpu_torch import _kernels
        from qldpc_tpu_torch.models import gf2
        from qldpc_tpu_torch.ops import (bp, bp_lift_cuda,
                                         bp_lift_layered_cuda, calibrate,
                                         gather, osd, osd_cuda, sampler)
        from qldpc_tpu_torch.ops.bp import alpha_schedule
        from qldpc_tpu_torch.ops.bp_lift import LiftedGraph
        from qldpc_tpu_torch.ops.sampler import (fault_bits,
                                                 sample_gate_randoms,
                                                 signature_matrix,
                                                 trial_batch,
                                                 trial_syndromes,
                                                 trial_syndromes_plain)
        from qldpc_tpu_torch.parallel import engine, mesh
        from qldpc_tpu_torch.scripts import (bp_breakdown, device_ms,
                                             gather_bench, gather_probe,
                                             gather_timing, handoff_timing,
                                             multihost_smoke, wall_ms)
        from qldpc_tpu_torch.utils.caching import (compute_cache_key,
                                                   save_matrices)
    except ImportError as e:
        fail(f"run from the root of a checkout: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    def cuda_ms(fn, reps: int) -> float:
        """Mean ms per call over ``reps`` calls after one warm-up call."""
        return device_ms(fn, reps, dev)

    # ---- phase 1: device and build ----
    def smi(query: str) -> str:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.splitlines()
        return out[0].strip() if out else "unknown"

    card = smi("name,power.limit")
    sm_clock = smi("clocks.max.sm")  # e.g. "1980 MHz"
    t_start = time.time()
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    t0 = time.time()
    try:
        _kernels.build_all()
    except RuntimeError as e:
        fail(f"phase 1 (build): {e}")
    print(f"phase 1: built {', '.join(_kernels.SOURCES)} in "
          f"{time.time() - t0:.1f} s", flush=True)
    for name in _kernels.SOURCES:
        for line in _kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
            # the eliminators K2, K4, K5, G1, P1 and R1 must not spill in
            # any instantiation
            spills = re.findall(r"(\d+) bytes spill", line)
            if (name.startswith("gf2_elim")
                    or name in ("gather_iter", "gather_pack", "bp_residual")) \
                    and any(int(x) for x in spills):
                fail(f"phase 1: {name} spills: {line.strip()}")

    code = qt.get_code(CODE)
    circ = qt.SyndromeCircuit(code, num_cycles=CYCLES)
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, P)
    seq = alpha_schedule("dynamical", MAXITER)
    decs = [engine._make_basis(circ, M, b, seq, osd_order=OSD_ORDER,
                               device=dev) for b in "ZX"]
    n_locs = circ.num_error_locs
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err, pauli, cat2 = sample_gate_randoms(gen, BATCH, n_locs, P)
    wrappers = dict(k1=bp_lift_cuda.decode_batch_lift_cuda,
                    k2=osd_cuda.eliminate_blocks_v1,
                    k3=bp_lift_layered_cuda.decode_batch_lift_layered_cuda,
                    k4=osd_cuda.eliminate_blocks_fused,
                    k5=osd_cuda.eliminate_blocks_pair,
                    g1=osd_cuda.gather_pack,
                    p1=gather.gather_iterate, p2=gather.take_along,
                    s1=trial_syndromes, r1=osd_cuda.bp_residual)

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def counts() -> dict:
        return {k: w.launches for k, w in wrappers.items()}

    # ---- phase 2: S1 and K1 against their plain versions ----
    maps = (decs[0].maps, decs[1].maps)
    s1_out = trial_syndromes(err, pauli, cat2, *maps)
    torch.cuda.synchronize()
    for key, v in trial_syndromes_plain(err, pauli, cat2, *maps).items():
        if not torch.equal(s1_out[key], v):
            fail(f"phase 2: S1 {key} differs from the plain version")
    bits = [fault_bits(err, pauli, cat2, m, b) for m, b in zip(maps, "ZX")]
    floats = [b.to(torch.float32) for b in bits]
    dense = [signature_matrix(m) for m in maps]  # (R, L), outside the timing
    erring = int(err.sum())
    s1 = dict(
        ms=cuda_ms(lambda: trial_syndromes(err, pauli, cat2, *maps), 20),
        kernel_ms=gather_timing.graph_ms(
            lambda: trial_syndromes(err, pauli, cat2, *maps), 20, dev),
        plain_ms=cuda_ms(
            lambda: trial_syndromes_plain(err, pauli, cat2, *maps), 3),
        # the plain version's two float32 signature products alone
        library_ms=gather_timing.graph_ms(
            lambda: [a @ f for a, f in zip(dense, floats)], 3, dev),
        erring_per_shot=erring / BATCH,
        flips_per_shot_frame=sum(int(b.sum()) for b in bits) / (2 * BATCH))
    del bits, floats, dense
    # the least S1 moves: each shot's err row, pauli and cat2 at the erring
    # gate locations, its four outputs and its tables, each once
    s1["bound_ms"], s1["bound_by"] = bound(
        nbytes(err, *s1_out.values(), *(
            t for m in maps
            for t in (m.loc_ptr, m.loc_entry, m.sig_ptr, m.sig_row)))
        + (pauli.element_size() + cat2.element_size()) * erring, 0)
    print(f"phase 2: S1 at {CODE} (B={BATCH}, both frames): exact; "
          f"{s1['ms']:.4f} ms a call, {s1['kernel_ms']:.4f} ms alone (bound "
          f"{s1['bound_ms']:.4f} ms by {s1['bound_by']}), plain "
          f"{s1['plain_ms']:.3f} ms, its two products alone "
          f"{s1['library_ms']:.3f} ms; {s1['erring_per_shot']:.1f} erring "
          f"gate locations a shot, {s1['flips_per_shot_frame']:.1f} flipped "
          f"locations a shot and frame", flush=True)

    k1 = {}
    failed = {}
    syns = {}
    shape = bp_lift_cuda.flood_launch_info(decs[0].lifted, dev)
    print(f"phase 2: K1 shape at {CODE}: {shape['registers']} registers and "
          f"{shape['local_bytes']} spilled bytes a thread, {shape['threads']} "
          f"threads a block (one shot), {shape['state_bytes']} state bytes a "
          f"shot in {shape['state_in']}, {shape['smem_bytes']} bytes of "
          f"shared memory a block, {shape['blocks_per_sm']} blocks (shots) "
          f"per SM", flush=True)
    if shape["blocks_per_sm"] < 1:
        fail(f"phase 2: K1 cannot be resident: {shape}")
    for basis, dec in zip("ZX", decs):
        syn = s1_out[f"syndrome_{basis.lower()}"]
        syns[basis] = syn
        args = (dec.lifted, syn, dec.prior, dec.alpha_seq, MAXITER)
        a = bp_lift_cuda.decode_batch_lift_cuda(*args)
        torch.cuda.synchronize()
        b = bp_lift_cuda.decode_batch_lift_plain(*args)
        for key in ("hard", "converged", "iterations"):
            if not torch.equal(a[key], b[key]):
                fail(f"phase 2: K1 {key} differs from the plain version "
                     f"(basis {basis})")
        unconv = ~b["converged"]
        if not torch.equal(a["values"][unconv], b["values"][unconv]):
            fail(f"phase 2: K1 values of unconverged shots differ "
                 f"(basis {basis})")
        err_abs = float((a["values"] - b["values"]).abs().max())
        ms = cuda_ms(lambda: bp_lift_cuda.decode_batch_lift_cuda(*args), 5)
        plain_ms = cuda_ms(
            lambda: bp_lift_cuda.decode_batch_lift_plain(*args), 1)
        tabs = bp_lift_cuda.flood_tables(dec.lifted, dev)
        geo = bp_lift_cuda.flood_geometry(dec.lifted, dev)
        edges = int(dec.H.sum())
        shot_iters = int((a["iterations"].long() + 1).sum())
        kb, bb = bound(
            nbytes(syn, a["values"], a["hard"], a["converged"],
                   a["iterations"], dec.prior, dec.alpha_seq,
                   geo["pos_info"], geo["wrap_words"], tabs["prior_grid"],
                   tabs["out_gather"], tabs["residual"]),
            K1_OPS_PER_EDGE_ITER * edges * shot_iters)
        k1[basis] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err_abs,
                         bound_ms=kb, bound_by=bb, edges=edges,
                         converged=int(a["converged"].sum()),
                         mean_iters=shot_iters / BATCH)
        failed[basis] = (syn[unconv], b["values"][unconv],
                         b["hard"][unconv])
        k1[basis]["out"] = a
        print(f"phase 2: K1 basis {basis}: exact; {ms:.3f} ms (first "
              f"design {K1_EARLIER_MS[basis]} ms, plain {plain_ms:.1f} ms, "
              f"bound {kb:.4f} ms by {bb}); "
              f"{k1[basis]['converged']}/{BATCH} converged, mean "
              f"{k1[basis]['mean_iters']:.2f} iterations", flush=True)

    # R1 against its plain version on K1's hard decisions of a pool of RPD
    # rounds, as the pooled OSD reads them (its own generator: the phases
    # below draw from gen as before)
    POOL = RPD * BATCH
    pool_syn = trial_syndromes(*sample_gate_randoms(
        torch.Generator(device=dev).manual_seed(SEED + 2), POOL, n_locs, P),
        *maps)
    r1 = {}
    for basis, dec in zip("ZX", decs):
        syn = pool_syn[f"syndrome_{basis.lower()}"]
        hard = bp_lift_cuda.decode_batch_lift_cuda(
            dec.lifted, syn, dec.prior, dec.alpha_seq, MAXITER)["hard"]
        index = dec.col_index
        got = osd_cuda.bp_residual(syn, hard, dec.HT, index)
        torch.cuda.synchronize()
        for nm, g, w in zip(("residual", "weight"), got,
                            osd_cuda.bp_residual_plain(syn, hard, dec.HT)):
            if not torch.equal(g, w):
                fail(f"phase 2: R1 {nm} differs from the plain version "
                     f"(basis {basis})")
        hard_f = hard.to(torch.float32)  # the product's input, untimed
        # the least R1 moves: the hard decision and the syndrome read once,
        # the residual and the weight written once, H's CSC read once
        kb, bb = bound(nbytes(hard, syn, *got, index.colptr, index.rows), 0)
        r1[basis] = dict(
            ms=cuda_ms(lambda: osd_cuda.bp_residual(syn, hard, dec.HT,
                                                    index), 20),
            kernel_ms=gather_timing.graph_ms(
                lambda: osd_cuda.bp_residual(syn, hard, dec.HT, index), 50,
                dev),
            plain_ms=gather_timing.graph_ms(
                lambda: osd_cuda.bp_residual_plain(syn, hard, dec.HT), 5,
                dev),
            # the float32 product the round ran twice a basis before R1
            library_ms=gather_timing.graph_ms(lambda: hard_f @ dec.HT, 5,
                                              dev),
            bound_ms=kb, bound_by=bb,
            hard_ones_per_shot=int((hard & 1).sum()) / POOL)
        del hard_f
        r = r1[basis]
        print(f"phase 2: R1 basis {basis} at {CODE} (B={POOL}): exact; "
              f"{r['ms']:.4f} ms a call, {r['kernel_ms']:.4f} ms alone "
              f"(bound {kb:.4f} ms by {bb}), plain {r['plain_ms']:.3f} ms, "
              f"the float32 product alone {r['library_ms']:.3f} ms; "
              f"{r['hard_ones_per_shot']:.1f} set columns a shot",
              flush=True)
    del pool_syn

    # ---- phase 3: K2 against its plain version ----
    dec = decs[0]
    syn_f, vals_f, hard_f = failed["Z"]
    m, K, KT_basis = dec.H.shape[0], dec.K, dec.basis_cols.shape[0]
    residual = osd_cuda.bp_residual(syn_f, hard_f, dec.HT,
                                    dec.col_index)[0]
    cols = torch.sort(vals_f.abs(), dim=1, stable=True).indices[:, :K]
    HT_u8 = dec.H.T.contiguous()
    Rp = -(-KT_basis // 32) * 32
    Hb = torch.zeros((m, Rp), dtype=torch.uint8, device=dev)
    Hb[:, :KT_basis] = dec.H[:, dec.basis_cols]
    HbT = osd._pack_columns(Hb).T.contiguous()
    pref = osd._gather_pack(HT_u8, cols, K, words_major=True)
    widths = {
        "stage1": (osd._gather_pack(HT_u8, cols[:, :256], 256,
                                    words_major=True), 256),
        "prefix": (pref, K),
        "full": (torch.cat([pref, HbT[None].expand(len(cols), *HbT.shape)],
                           1), K + KT_basis),
    }
    k2 = {}
    k2_err = 0.0
    names = ("Hp", "s_red", "prow_of_col", "used", "colofrow", "steps")

    def colsof(Hp):
        """Words-major Hp (B, W, M) in the eliminators' column layout, by
        the plain bit transpose (G1's plain version of the same matrix):
        the eliminators' input where no column indices make it."""
        return osd_cuda.words_to_columns(Hp, osd_cuda.column_stride(
            Hp.shape[1], Hp.shape[2], dev))

    def elim_exact(kname, fn_k, plain, Hp, s, Kw, m, where, src=None,
                   count=False, **kw):
        """Eliminator ``kname`` on fresh column input (``src()``: G1's
        pack; by default the plain transpose of Hp), with and without the
        reduced matrix, against its plain version on the words-major Hp,
        every output; returns both (the plain one with its XOR count when
        ``count``)."""
        b = plain(Hp, s, Kw, m, return_steps=True,
                  **(dict(count_xor_words=True) if count else {}), **kw)
        for want_matrix in (True, False):
            x = src() if src is not None else colsof(Hp)
            got = fn_k(x, s, Kw, m, return_steps=True,
                       want_matrix=want_matrix, **kw)
            torch.cuda.synchronize()
            if not want_matrix and got[0] is not None:
                fail(f"{where}: {kname} wrote a matrix without want_matrix")
            for nm, g, y in zip(names, got, b):
                if (want_matrix or nm != "Hp") and not torch.equal(g, y):
                    fail(f"{where}: {kname} {nm} differs from its plain "
                         f"version (want_matrix={want_matrix}, {kw})")
            if want_matrix:
                a = got
        return a, b

    def k2_exact(Hp, s, Kw, m, where, src=None, **kw):
        """K2 against its plain version on every output; returns both."""
        return elim_exact("K2", osd_cuda.eliminate_blocks_v1,
                          osd_cuda.eliminate_blocks_plain, Hp, s, Kw, m,
                          where if where.startswith("phase")
                          else f"phase 3: {where}", src, count=True, **kw)

    def launch_ms(launch, x, src, reps: int) -> float:
        """A prepared launch's ms by CUDA events; one that consumes its
        input x gets it back from ``src`` before each launch, the copies'
        time taken away."""
        if not launch.consumes_input:
            return cuda_ms(launch, reps)
        return (cuda_ms(lambda: (x.copy_(src), launch()), reps)
                - cuda_ms(lambda: x.copy_(src), reps))

    def wrapper_ms(fn_k, hc, s, Kw, m, kname="K2", **kw) -> float:
        """ms a wrapper call on G1's output hc; where the kernel consumes
        its input (device memory) each call takes a copy, the copies' time
        taken away."""
        if not osd_cuda.elim_sizes(hc.shape[1] // 32, s.shape[1],
                                   kname)["device_memory"]:
            return cuda_ms(lambda: fn_k(hc, s, Kw, m, **kw), 5)
        return (cuda_ms(lambda: fn_k(hc.clone(), s, Kw, m, **kw), 5)
                - cuda_ms(hc.clone, 5))

    def elim_shape(Hp, s, Kw, m, steps, kernel="K2", **kw):
        """An eliminator's (K2 by default) launch shape and kernel-only
        times on words-major Hp's column layout: the whole launch, the
        load and store alone (the same launch with no column), and per
        column step of the longest shot."""
        info = osd_cuda.elim_launch_info(*Hp.shape, dev, kernel)
        src = colsof(Hp)
        times = []
        for k in (Kw, 0):
            x = src.clone()
            launch, _ = osd_cuda.prepare_elim_launch(x, s, k, m,
                                                     kernel=kernel, **kw)
            times.append(launch_ms(launch, x, src, 5))
        kernel_ms, layout_ms = times
        info.update(kernel_ms=kernel_ms, layout_ms=layout_ms,
                    us_per_step=kernel_ms * 1e3 / max(int(steps.max()), 1))
        return info

    def shape_line(info) -> str:
        return (f"{info['registers']} registers, {info['local_bytes']} "
                f"spilled bytes; {info['shot_bytes']} column bytes a shot "
                f"({info['words_per_lane']} row words a lane) in "
                f"{info['columns_in']}, {info['warps_per_shot']} warps a "
                f"team of {info['shots_per_team']} shot(s), "
                f"{info['shots_per_block']} shots a "
                f"block, {info['smem_bytes']} bytes of shared memory a block, "
                f"{info['blocks']} blocks, {info['blocks_per_sm']} blocks "
                f"({info['shots_per_sm']} shots) per SM; kernel "
                f"{info['kernel_ms']:.4f} ms, load and store "
                f"{info['layout_ms']:.4f} ms (share "
                f"{info['layout_ms'] / info['kernel_ms']:.3f}), "
                f"{info['us_per_step']:.3f} us per step of the longest shot")

    def g1_fed_ms(kname, src, s, Kw, m, **kw) -> dict:
        """The eliminator alone on G1's output ``src()``, with and without
        the reduced matrix (CUDA graphs)."""
        res = {}
        hc = src()
        for want in (True, False):
            x = hc.clone()
            launch, _ = osd_cuda.prepare_elim_launch(
                x, s, Kw, m, kernel=kname, want_matrix=want, **kw)
            res["matrix" if want else "no matrix"] = \
                handoff_timing.alone_ms(
                    launch, 10, dev, (lambda: x.copy_(hc))
                    if launch.consumes_input else None)
        return res

    def fed_line(r: dict) -> str:
        return ", ".join(f"{k} {v:.4f}" for k, v in r.items()) + " ms"

    # G1's pack of each width (the OSD's hand-off), for K2 here and K4 and
    # K5 in phase 6: a fresh output a call, which a device-memory launch
    # consumes
    cols_full = torch.cat([cols, dec.basis_cols[None].expand(
        len(cols), len(dec.basis_cols))], 1)
    g1_widths = {"stage1": (cols[:, :256], 256, widths["stage1"][0]),
                 "prefix": (cols, K, widths["prefix"][0]),
                 "full": (cols_full, -(-cols_full.shape[1] // 32) * 32,
                          widths["full"][0])}

    def g1_pack(index, cl, Kx):
        return lambda: osd_cuda.gather_pack(index, cl, Kx)

    g1_src = {w: g1_pack(dec.col_index, cl, Kx)
              for w, (cl, Kx, _) in g1_widths.items()}

    plain25 = {}  # phase 25: the plain versions' outputs, validity exit on
    for width, (Hp, Kw) in widths.items():
        for exit_on_valid in (False, True):
            a, b = k2_exact(Hp, residual, Kw, m, width, g1_src[width],
                            rank=dec.rank, exit_on_valid=exit_on_valid)
            xor_words = int(b[6].sum())  # data-dependent work of the run
            k2_err = max(k2_err, max(float((x.long() - y.long()).abs().max())
                                     for x, y in zip(a, b)))
        plain25["K2", width] = b[:6]
        hc = g1_src[width]()
        ms = wrapper_ms(osd_cuda.eliminate_blocks_v1, hc, residual, Kw, m,
                        rank=dec.rank)
        steps = a[5]
        k2_bytes = 2 * nbytes(Hp, residual) + nbytes(a[4], steps)
        scan_ops = K2_OPS_PER_ROW_STEP * m * int(steps.long().sum())
        scan_kb, _ = bound(k2_bytes, scan_ops)
        kb, bb = bound(k2_bytes, scan_ops + K2_OPS_PER_XOR_WORD * xor_words)
        k2[width] = dict(ms=ms, words=Hp.shape[1], shots=len(Hp),
                         bound_ms=kb, bound_by=bb, scan_bound_ms=scan_kb,
                         xor_words=xor_words, steps=steps,
                         mean_steps=float(steps.float().mean()),
                         max_steps=int(steps.max()),
                         shape=elim_shape(Hp, residual, Kw, m, steps,
                                        rank=dec.rank),
                         alone=g1_fed_ms("K2", g1_src[width], residual, Kw,
                                         m, rank=dec.rank))
        print(f"phase 3: K2 {width} ({Hp.shape[1]} words, {len(Hp)} shots):"
              f" on G1's pack, exact with and without the validity exit and "
              f"the reduced matrix; {ms:.3f} ms through the wrapper (bound "
              f"{kb:.4f} ms by {bb}: row scans {scan_ops} ops + {xor_words} "
              f"word XORs; scan alone {scan_kb:.4f} ms); steps mean "
              f"{k2[width]['mean_steps']:.1f} max {k2[width]['max_steps']}; "
              + shape_line(k2[width]["shape"]) + "; alone on G1's output: "
              + fed_line(k2[width]["alone"]), flush=True)
    del hc
    Hp, Kw = widths["stage1"]
    k2["stage1"]["plain_ms"] = cuda_ms(
        lambda: osd_cuda.eliminate_blocks_plain(Hp, residual, Kw, m,
                                                rank=dec.rank), 1)
    k2_exact(widths["full"][0], residual, widths["full"][1], m, "full",
             g1_src["full"], rank=dec.rank, full_jordan=True)
    print(f"phase 3: K2 full_jordan at full width exact; stage-1 plain "
          f"{k2['stage1']['plain_ms']:.1f} ms", flush=True)

    # the device-memory branch (the one wider matrices take), forced at
    # stage-1 width: bit-identical to the shared-memory launch, on G1's
    # output eliminated in place
    ref = osd_cuda.eliminate_blocks_v1(g1_src["stage1"](), residual, Kw, m,
                                       rank=dec.rank, return_steps=True)
    saved_limit = osd_cuda._SMEM_LIMIT
    osd_cuda._SMEM_LIMIT = 0
    try:
        a = osd_cuda.eliminate_blocks_v1(g1_src["stage1"](), residual, Kw,
                                         m, rank=dec.rank, return_steps=True)
        torch.cuda.synchronize()
        for nm, x, y in zip(names, a, ref):
            if not torch.equal(x, y):
                fail(f"phase 3: K2's device-memory branch {nm} differs from "
                     "its shared-memory launch (stage1)")
        k2_exact(Hp, residual, Kw, m, "stage1, device memory",
                 g1_src["stage1"], rank=dec.rank)
        dm = elim_shape(Hp, residual, Kw, m, a[5], rank=dec.rank)
        dm_alone = g1_fed_ms("K2", g1_src["stage1"], residual, Kw, m,
                             rank=dec.rank)
    finally:
        osd_cuda._SMEM_LIMIT = saved_limit
    k2["stage1_device_memory_alone"] = dm_alone
    print(f"phase 3: K2 device-memory branch forced at stage1 (G1's output "
          f"eliminated in place): every output identical to the "
          f"shared-memory launch and the plain version; " + shape_line(dm)
          + "; alone: " + fed_line(dm_alone), flush=True)

    # K2 at [[288,12,18]], B=37: 2880 rows, three row words a lane, every
    # width on the device-memory branch, a regime [[144]] does not reach.
    # Sampled errors, columns in |prior| order with a little noise; no BP,
    # so the residual is the syndrome. rank=None: the rank exit (m pivots)
    # cannot fire, the validity exit and the last column stop the shots.
    t0 = time.time()
    code288 = qt.get_code(CODE_288)
    circ288 = qt.SyndromeCircuit(code288, num_cycles=CYCLES_288)
    M288 = qt.build_decoding_matrices(circ288, code288.Lx, code288.Lz, P)
    H288 = (np.asarray(M288["HdecZ"]) != 0).astype(np.uint8)
    prior288 = qt.channel_llrs(M288["channel_probsZ"]).astype(np.float32)
    rng = np.random.default_rng(SEED)
    errs = rng.random((BATCH_288, H288.shape[1])) < M288["channel_probsZ"]
    syn288 = ((torch.as_tensor(errs, dtype=torch.float32, device=dev)
               @ torch.as_tensor(H288.T, dtype=torch.float32, device=dev))
              % 2).to(torch.int8)
    build288_s = time.time() - t0
    m288, n288 = H288.shape
    K288 = osd.choose_K(m288, n288)
    noise = torch.as_tensor(rng.standard_normal((BATCH_288, n288)),
                            dtype=torch.float32, device=dev)
    llr288 = torch.as_tensor(prior288, device=dev) * (1 + 0.1 * noise)
    cols288 = torch.sort(llr288.abs(), dim=1, stable=True).indices
    HT288 = torch.as_tensor(H288.T.copy(), device=dev)
    res288 = syn288.to(torch.int32)
    index288 = osd_cuda.column_index(H288, dev)
    w288 = {}  # phase 6 runs K4 and K5 on the same inputs
    for width, Kw in (("stage1", 768), ("prefix", K288)):
        Hp = osd._gather_pack(HT288, cols288[:, :Kw], Kw, words_major=True)
        w288[width] = (Hp, Kw, g1_pack(index288, cols288[:, :Kw], Kw))
        for exit_on_valid in (False, True):
            a, _ = k2_exact(Hp, res288, Kw, m288, f"{CODE_288} {width}",
                            w288[width][2], exit_on_valid=exit_on_valid)
        info = elim_shape(Hp, res288, Kw, m288, a[5])
        if info["columns_in"] != "device memory" or \
                info["words_per_lane"] != 3:
            fail(f"phase 3: K2 at {CODE_288} {width} took another branch: "
                 f"{info}")
        print(f"phase 3: K2 at {CODE_288} {width} ({Hp.shape[1]} words, "
              f"B={BATCH_288}): on G1's pack, in place in device memory, "
              f"exact with and without the validity exit; "
              f"steps mean {float(a[5].float().mean()):.1f} max "
              f"{int(a[5].max())}; " + shape_line(info), flush=True)
    # the basis rerun's width: the prefix with the column basis appended,
    # which osd_batch launches for the shots the prefix leaves uncovered
    # (here every shot), with the rank exit of run_simulation's decoder
    basis288 = gf2.column_basis(H288)
    rank288 = gf2.rank_fast(H288)
    R288 = len(basis288)
    Hb288 = torch.zeros((m288, -(-R288 // 32) * 32), dtype=torch.uint8,
                        device=dev)
    Hb288[:, :R288] = torch.as_tensor(H288[:, basis288], device=dev)
    HbT288 = osd._pack_columns(Hb288).T.contiguous()
    Hp = torch.cat([w288["prefix"][0],
                    HbT288[None].expand(BATCH_288, *HbT288.shape)], 1)
    Kw = K288 + R288
    cols288E = torch.cat([cols288[:, :K288], torch.as_tensor(
        basis288, device=dev)[None].expand(BATCH_288, R288)], 1)
    Kx288 = -(-Kw // 32) * 32
    w288["basis rerun"] = (Hp, Kw, g1_pack(index288, cols288E, Kx288))
    for exit_on_valid in (False, True):
        a, b = k2_exact(Hp, res288, Kw, m288, f"{CODE_288} basis rerun",
                        w288["basis rerun"][2], rank=rank288,
                        exit_on_valid=exit_on_valid)
        err288 = max(float((x.long() - y.long()).abs().max())
                     for x, y in zip(a, b))
        k2_err = max(k2_err, err288)
    plain25["K2", "basis rerun 288"] = b[:6]
    k2["basis_rerun_288_alone"] = g1_fed_ms(
        "K2", w288["basis rerun"][2], res288, Kw, m288, rank=rank288)
    info = elim_shape(Hp, res288, Kw, m288, a[5], rank=rank288)
    if info["columns_in"] != "device memory" or info["words_per_lane"] != 3:
        fail(f"phase 3: K2 at {CODE_288} basis rerun took another branch: "
             f"{info}")
    print(f"phase 3: K2 at {CODE_288} basis rerun ({K288} prefix columns + "
          f"{R288} basis columns = {Hp.shape[1]} words, rank {rank288}, "
          f"B={BATCH_288}): every output exact with and without the validity "
          f"exit (max abs error {err288:g}); steps mean "
          f"{float(a[5].float().mean()):.1f} max {int(a[5].max())}; "
          + shape_line(info), flush=True)
    print(f"phase 3: K2 at {CODE_288} basis rerun alone on G1's output: "
          + fed_line(k2["basis_rerun_288_alone"]), flush=True)
    del HT288, Hb288, HbT288, Hp
    print(f"phase 3: {CODE_288} matrices built in {build288_s:.1f} s",
          flush=True)

    # ---- phase 4: main path ----
    osd_cuda._KERNEL_VERSION = 1  # the main path's eliminator, K2
    randoms = [sample_gate_randoms(gen, BATCH, n_locs, P)
               for _ in range(RPD)]
    fn = engine.make_pooled_round_fn(decs[0], decs[1], n_locs, P, BATCH,
                                     MAXITER, OSD_ORDER, RPD)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    out_k = fn(None, randoms=randoms)
    torch.cuda.synchronize()
    dispatch_s = time.time() - t0
    per_dispatch = counts()

    def eliminate_plain_from_columns(Hp, s, K, m, want_matrix=True, **kw):
        """K2's plain version on column input, as the OSD hands it over."""
        out = osd_cuda.eliminate_blocks_plain(
            osd_cuda.columns_to_words(Hp, s.shape[1]), s, K, m, **kw)
        return out if want_matrix else (None,) + out[1:]

    def residual_plain(syndrome, hard, HT, index):
        """R1's plain version on R1's arguments."""
        return osd_cuda.bp_residual_plain(syndrome, hard, HT)

    @contextlib.contextmanager
    def plain_versions():
        saved = (engine.decode_batch_lift_cuda,
                 engine.decode_batch_lift_layered_cuda, osd.eliminate_blocks,
                 osd.gather_pack, sampler.trial_syndromes,
                 engine.bp_residual, osd.bp_residual)
        sampler.trial_syndromes = trial_syndromes_plain
        engine.decode_batch_lift_cuda = bp_lift_cuda.decode_batch_lift_plain
        engine.decode_batch_lift_layered_cuda = \
            bp_lift_layered_cuda.decode_batch_lift_layered_plain
        osd.eliminate_blocks = eliminate_plain_from_columns
        osd.gather_pack = osd_cuda.gather_pack_plain
        engine.bp_residual = osd.bp_residual = residual_plain
        try:
            yield
        finally:
            (engine.decode_batch_lift_cuda,
             engine.decode_batch_lift_layered_cuda,
             osd.eliminate_blocks, osd.gather_pack,
             sampler.trial_syndromes, engine.bp_residual,
             osd.bp_residual) = saved

    reset_counts()
    t0 = time.time()
    with plain_versions():
        out_p = fn(None, randoms=randoms)
    torch.cuda.synchronize()
    plain_dispatch_s = time.time() - t0
    if any(counts().values()):
        fail(f"phase 4: the dispatch through the plain versions launched "
             f"kernels: {counts()}")
    for key, v in out_k.items():
        if v.shape != (RPD * BATCH,) or not torch.equal(v, out_p[key]):
            fail(f"phase 4: pooled dispatch flag {key} differs between the "
                 "kernels and the plain versions")
    print(f"phase 4: pooled dispatch ({RPD}x{BATCH} shots) identical "
          f"through kernels ({dispatch_s:.2f} s) and plain versions "
          f"({plain_dispatch_s:.2f} s); launches per dispatch "
          f"S1 {per_dispatch['s1']} K1 {per_dispatch['k1']} R1 "
          f"{per_dispatch['r1']} K2 {per_dispatch['k2']} G1 "
          f"{per_dispatch['g1']}; BP converged "
          f"z {int(out_k['z_conv'].sum())} x {int(out_k['x_conv'].sum())} "
          f"of {RPD * BATCH}", flush=True)

    bb_params = dict(ell=code.ell, m=code.m, a_x_powers=code.a_x_powers,
                     a_y_powers=code.a_y_powers, b_y_powers=code.b_y_powers,
                     b_x_powers=code.b_x_powers)
    reset_counts()
    res = qt.run_simulation(
        code.Hx, code.Hz, code.Lx, code.Lz, P, num_cycles=CYCLES,
        maxIter=MAXITER, osd_order=OSD_ORDER, max_trials=MAX_TRIALS,
        batch_size=BATCH, rounds_per_dispatch=RPD, base_seed=SEED,
        precomputed_matrices=M, verbose=False, **bb_params)
    torch.cuda.synchronize()
    launches = counts()
    ler = res["logical_error_rate"]
    n = res["num_trials"]
    sig = np.sqrt(ler * (1 - ler) / max(n, 1)
                  + ARCHIVE_LER * (1 - ARCHIVE_LER) / ARCHIVE_TRIALS)
    print(f"phase 4: run_simulation {n} shots: LER {ler:.5f} "
          f"(z {(ler - ARCHIVE_LER) / sig:+.2f} vs the reference archive "
          f"{ARCHIVE_LER:.3f}, maxIter unrecorded), {res['shots_per_sec']:.1f}"
          f" shots/s, {res['osd_rank_deficient_shots']} rank-deficient "
          f"shot-bases; launches S1 {launches['s1']} K1 {launches['k1']} R1 "
          f"{launches['r1']} K2 {launches['k2']} G1 {launches['g1']}",
          flush=True)
    if per_dispatch["s1"] != RPD:
        fail(f"phase 4: the pooled dispatch launched S1 "
             f"{per_dispatch['s1']} times, not once a round ({RPD})")
    if per_dispatch["r1"] != 2:
        fail(f"phase 4: the pooled dispatch launched R1 "
             f"{per_dispatch['r1']} times, not once a basis")
    if launches["s1"] <= 0 or launches["k1"] <= 0 or launches["k2"] <= 0 \
            or launches["g1"] <= 0 or launches["r1"] <= 0:
        fail(f"phase 4: main path did not launch every kernel: {launches}")
    if launches["k3"] or launches["k4"] or launches["k5"]:
        fail(f"phase 4: main path launched another path's kernel: "
             f"{launches}")
    if n != MAX_TRIALS or not (0.0 < ler < 0.5):
        fail(f"phase 4: implausible result {res}")

    # ---- phase 5: K3 against its plain version, beside K1 ----
    shape3 = bp_lift_layered_cuda.layered_launch_info(decs[0].lifted, dev)
    print(f"phase 5: K3 shape at {CODE}: {shape3['registers']} registers "
          f"and {shape3['local_bytes']} spilled bytes a thread, "
          f"{shape3['threads']} threads a block (one shot), "
          f"{shape3['state_bytes']} state bytes a shot in "
          f"{shape3['state_in']}, {shape3['smem_bytes']} bytes of shared "
          f"memory a block, {shape3['blocks_per_sm']} blocks (shots) per SM",
          flush=True)
    if shape3["blocks_per_sm"] < 1:
        fail(f"phase 5: K3 cannot be resident: {shape3}")
    k3 = {}
    for basis, dec in zip("ZX", decs):
        args = (dec.lifted, syns[basis], dec.prior, dec.alpha_seq, MAXITER)
        a = bp_lift_layered_cuda.decode_batch_lift_layered_cuda(*args)
        torch.cuda.synchronize()
        b = bp_lift_layered_cuda.decode_batch_lift_layered_plain(*args)
        for key in ("hard", "converged", "iterations"):
            if not torch.equal(a[key], b[key]):
                fail(f"phase 5: K3 {key} differs from the plain version "
                     f"(basis {basis})")
        unconv = ~b["converged"]
        if not torch.equal(a["values"][unconv], b["values"][unconv]):
            fail(f"phase 5: K3 values of unconverged shots differ "
                 f"(basis {basis})")
        if not bool(a["converged"].any()):
            fail(f"phase 5: K3 converged no shot (basis {basis})")
        err_abs = float((a["values"] - b["values"]).abs().max())
        ms = cuda_ms(lambda: bp_lift_layered_cuda
                     .decode_batch_lift_layered_cuda(*args), 5)
        plain_ms = cuda_ms(lambda: bp_lift_layered_cuda
                           .decode_batch_lift_layered_plain(*args), 1)
        tabs = bp_lift_cuda.flood_tables(dec.lifted, dev)
        geo = bp_lift_cuda.flood_geometry(dec.lifted, dev)
        shot_sweeps = int((a["iterations"].long() + 1).sum())
        kb, bb = bound(
            nbytes(syns[basis], a["values"], a["hard"], a["converged"],
                   a["iterations"], dec.prior, dec.alpha_seq,
                   geo["pos_info"], geo["wrap_words"], tabs["prior_grid"],
                   tabs["out_gather"], tabs["residual"]),
            K3_OPS_PER_EDGE_SWEEP * k1[basis]["edges"] * shot_sweeps)
        k3[basis] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err_abs,
                         bound_ms=kb, bound_by=bb,
                         converged=int(a["converged"].sum()),
                         mean_sweeps=shot_sweeps / BATCH, out=a)
        # ms per sweep: the call over the mean sweeps its shots ran
        print(f"phase 5: K3 basis {basis}: exact; {ms:.3f} ms, "
              f"{ms / k3[basis]['mean_sweeps']:.4f} ms per sweep (plain "
              f"{plain_ms:.1f} ms, bound {kb:.4f} ms by {bb}); "
              f"{k3[basis]['converged']}/{BATCH} converged, mean "
              f"{k3[basis]['mean_sweeps']:.2f} sweeps; K1 on the same "
              f"syndromes: {k1[basis]['converged']}/{BATCH} converged, mean "
              f"{k1[basis]['mean_iters']:.2f} iterations, {k1[basis]['ms']:.3f}"
              f" ms", flush=True)

    # K1's and K3's device-memory branch: a per-shot state slab in device
    # memory instead of shared memory, the branch a graph whose state
    # exceeds a block's shared memory takes; no registry code takes it
    # (their compressed state is 161,280 bytes a shot at [[288]])
    dec = decs[0]
    args = (dec.lifted, syns["Z"], dec.prior, dec.alpha_seq, MAXITER)
    saved_limit = bp_lift_cuda._SMEM_LIMIT
    bp_lift_cuda._SMEM_LIMIT = 0
    try:
        for key, fn_k, ref in (
                ("K1", bp_lift_cuda.decode_batch_lift_cuda, k1["Z"]["out"]),
                ("K3", bp_lift_layered_cuda.decode_batch_lift_layered_cuda,
                 k3["Z"]["out"])):
            a = fn_k(*args)
            torch.cuda.synchronize()
            for name in ("hard", "converged", "iterations", "values"):
                if not torch.equal(a[name], ref[name]):
                    fail(f"phase 5: {key}'s device-memory branch {name} "
                         "differs from its shared-memory launch")
            dm_ms = cuda_ms(lambda: fn_k(*args), 3)
            smem_ms = (k1 if key == "K1" else k3)["Z"]["ms"]
            print(f"phase 5: {key} device-memory branch (basis Z): every "
                  f"output identical to the shared-memory launch; "
                  f"{dm_ms:.3f} ms (shared memory {smem_ms:.3f} ms)",
                  flush=True)
    finally:
        bp_lift_cuda._SMEM_LIMIT = saved_limit

    # K1 and K3 at [[288,12,18]] (the matrices and syndromes of phase 3):
    # their compressed state fits shared memory there, at one block per SM,
    # and the wraps reach ell*mm + mm = 156, a regime [[144]] does not reach
    t0 = time.time()
    g288 = LiftedGraph.try_from_dense(H288, code288.ell, code288.m,
                                      prior288, device=dev)
    if g288 is None:
        fail(f"phase 5: {CODE_288} has no lifted structure")
    args = (g288, syn288, torch.as_tensor(prior288, device=dev),
            decs[0].alpha_seq, MAXITER)
    for key, fn_k, plain, info in (
            ("K1", bp_lift_cuda.decode_batch_lift_cuda,
             bp_lift_cuda.decode_batch_lift_plain,
             bp_lift_cuda.flood_launch_info),
            ("K3", bp_lift_layered_cuda.decode_batch_lift_layered_cuda,
             bp_lift_layered_cuda.decode_batch_lift_layered_plain,
             bp_lift_layered_cuda.layered_launch_info)):
        shape288 = info(g288, dev)
        if shape288["state_in"] != "shared memory":
            fail(f"phase 5: {key} at {CODE_288} keeps its state in "
                 f"{shape288['state_in']}")
        a = fn_k(*args)
        torch.cuda.synchronize()
        b = plain(*args)
        for name in ("hard", "converged", "iterations", "values"):
            if not torch.equal(a[name], b[name]):
                fail(f"phase 5: {key} {name} at {CODE_288} differs from the "
                     "plain version")
        print(f"phase 5: {key} at {CODE_288} (basis Z, B={BATCH_288}, "
              f"maxIter {MAXITER}): every output identical to the plain "
              f"version; {int(a['converged'].sum())}/{BATCH_288} converged; "
              f"{shape288['state_bytes']} state bytes a shot in "
              f"{shape288['state_in']}, {shape288['smem_bytes']} bytes of "
              f"shared memory a block, {shape288['blocks_per_sm']} blocks per "
              f"SM ({time.time() - t0:.1f} s with the lifted graph)",
              flush=True)

    # ---- phase 6: K4 and K5 against their plain versions and K2's ----
    dec = decs[0]  # phase 3's inputs are Z-basis shots

    def osd0_bits(out):
        """OSD-0 correction bit of every pivot column slot."""
        s_red, prow = out[1], out[2]
        return torch.where(prow >= 0,
                           s_red.gather(1, prow.clamp(min=0).long()), 0)

    def is_valid(out):
        return torch.where(out[3], 0, out[1]).sum(1) == 0

    def max_diff(xs, ys):
        return max(float((x.long() - y.long()).abs().max())
                   for x, y in zip(xs, ys))

    alts = (("k4", "K4", osd_cuda.eliminate_blocks_fused,
             osd_cuda.eliminate_blocks_fused_plain),
            ("k5", "K5", osd_cuda.eliminate_blocks_pair,
             osd_cuda.eliminate_blocks_plain))

    def alt_exact(key, fn_k, plain, Hp, s, Kw, m, where, src=None, **kw):
        """K4 or K5 on G1's pack ``src()`` (by default Hp's plain
        transpose), with and without the reduced matrix, against its plain
        version on every output."""
        return elim_exact(key.upper(), fn_k, plain, Hp, s, Kw, m,
                          f"phase 6: {where}", src, **kw)

    k45 = dict(k4={}, k5={})
    k45_err = dict(k4=0.0, k5=0.0)
    for width, (Hp, Kw) in widths.items():
        for exit_on_valid in (False, True):
            kw = dict(rank=dec.rank, exit_on_valid=exit_on_valid)
            where = f"{width}, exit_on_valid={exit_on_valid}"
            a4, p4 = alt_exact("k4", *alts[0][2:], Hp, residual, Kw, m,
                               where, g1_src[width], **kw)
            a5, p2 = alt_exact("k5", *alts[1][2:], Hp, residual, Kw, m,
                               where, g1_src[width], **kw)
            if exit_on_valid:  # K4 may stop up to 3 columns after K2
                for nm, x, y in (("s_red", a4[1], p2[1]),
                                 ("OSD-0 bits", osd0_bits(a4), osd0_bits(p2)),
                                 ("validity", is_valid(a4), is_valid(p2))):
                    if not torch.equal(x, y):
                        fail(f"phase 6: K4 {nm} differs from K2's plain "
                             f"version ({where})")
            else:  # only the rank stop remains; its step count is grouped
                for nm, x, y in zip(names[:5], a4[:5], p2[:5]):
                    if not torch.equal(x, y):
                        fail(f"phase 6: K4 {nm} differs from K2's plain "
                             f"version ({where})")
            k45_err["k4"] = max(k45_err["k4"], max_diff(a4, p4))
            k45_err["k5"] = max(k45_err["k5"], max_diff(a5, p2))
        plain25["K4", width] = p4
        # timed as the main path calls it (validity exit on); both do K2's
        # work, so the bound is K2's at this width
        hc = g1_src[width]()
        for (key, kname, fn_k, plain), out in zip(alts, (a4, a5)):
            ms = wrapper_ms(fn_k, hc, residual, Kw, m, kname, rank=dec.rank)
            k45[key][width] = dict(
                ms=ms, bound_ms=k2[width]["bound_ms"],
                bound_by=k2[width]["bound_by"],
                mean_steps=float(out[5].float().mean()),
                max_steps=int(out[5].max()),
                shape=elim_shape(Hp, residual, Kw, m, out[5], kname,
                               rank=dec.rank),
                alone=g1_fed_ms(kname, g1_src[width], residual, Kw, m,
                                rank=dec.rank))
        del hc
        r4, r5, r2 = k45["k4"][width], k45["k5"][width], k2[width]
        print(f"phase 6: {width} ({Hp.shape[1]} words): K4 and K5 on G1's "
              f"pack exact against their plain versions and K2's, with and "
              f"without the validity exit and the reduced matrix; through "
              f"the wrapper K4 {r4['ms']:.3f} ms, K5 "
              f"{r5['ms']:.3f} ms, K2 {r2['ms']:.3f} ms; kernel alone K4 "
              f"{r4['shape']['kernel_ms']:.4f}, K5 "
              f"{r5['shape']['kernel_ms']:.4f}, K2 "
              f"{r2['shape']['kernel_ms']:.4f} ms (bound "
              f"{r2['bound_ms']:.4f} ms by {r2['bound_by']}); us per step of "
              f"the longest shot K4 {r4['shape']['us_per_step']:.3f}, K5 "
              f"{r5['shape']['us_per_step']:.3f} (a double step), K2 "
              f"{r2['shape']['us_per_step']:.3f}; K5/K2 step ratio "
              f"{r5['shape']['us_per_step'] / r2['shape']['us_per_step']:.3f};"
              f" steps mean K4 {r4['mean_steps']:.1f}, K5 "
              f"{r5['mean_steps']:.1f}, K2 {r2['mean_steps']:.1f}; max K4 "
              f"{r4['max_steps']}, K5 {r5['max_steps']}, K2 "
              f"{r2['max_steps']}", flush=True)
        for key, _, _, _ in alts:
            print(f"phase 6:   {key.upper()} {width}: "
                  + shape_line(k45[key][width]["shape"])
                  + "; alone on G1's output: "
                  + fed_line(k45[key][width]["alone"]), flush=True)
    Hp, Kw = widths["full"]
    for key, kname, fn_k, plain in alts:
        alt_exact(key, fn_k, plain, Hp, residual, Kw, m, "full",
                  g1_src["full"], rank=dec.rank, full_jordan=True)
    Hp, Kw = widths["stage1"]
    k45["k4"]["stage1"]["plain_ms"] = cuda_ms(
        lambda: osd_cuda.eliminate_blocks_fused_plain(Hp, residual, Kw, m,
                                                      rank=dec.rank), 1)
    k45["k5"]["stage1"]["plain_ms"] = cuda_ms(
        lambda: osd_cuda.eliminate_blocks_plain(Hp, residual, Kw, m,
                                                rank=dec.rank), 1)
    print(f"phase 6: K4 and K5 full_jordan at full width exact; stage-1 "
          f"plain K4 {k45['k4']['stage1']['plain_ms']:.1f} ms, K5 (K2's "
          f"plain version) {k45['k5']['stage1']['plain_ms']:.1f} ms",
          flush=True)

    # the chain of one team alone: at most one team per SM (37 teams), so
    # no other shot shares the SM's issue slots; the time per step less the
    # layout, K5's double step against K2's single step
    chain = {}
    wrap = dict(K2=osd_cuda.eliminate_blocks_v1,
                **{kname: fn_k for _, kname, fn_k, _ in alts})
    for kname, nshots in (("K2", 37), ("K4", 37), ("K5", 74)):
        h, r = Hp[:nshots], residual[:nshots]
        steps = wrap[kname](colsof(h), r, Kw, m, rank=dec.rank,
                            return_steps=True)[5]
        sh = elim_shape(h, r, Kw, m, steps, kname, rank=dec.rank)
        chain[kname] = dict(sh, chain_us_per_step=(
            sh["kernel_ms"] - sh["layout_ms"]) * 1e3 / max(int(steps.max()),
                                                            1))
    print(f"phase 6: one team per SM at stage1 (K2 and K4 37 shots, K5 74): "
          f"us per step of the longest shot, layout excluded: K2 "
          f"{chain['K2']['chain_us_per_step']:.3f}, K4 "
          f"{chain['K4']['chain_us_per_step']:.3f} (a column), K5 "
          f"{chain['K5']['chain_us_per_step']:.3f} (a double step); K5/K2 "
          f"{chain['K5']['chain_us_per_step'] / chain['K2']['chain_us_per_step']:.3f}"
          f"; kernel K2 {chain['K2']['kernel_ms']:.4f}, K4 "
          f"{chain['K4']['kernel_ms']:.4f}, K5 {chain['K5']['kernel_ms']:.4f}"
          f" ms", flush=True)
    k45["chain"] = chain

    # the device-memory branch forced at stage-1 width: bit-identical to the
    # shared-memory launch, on G1's output eliminated in place
    for key, kname, fn_k, plain in alts:
        kw = dict(rank=dec.rank, return_steps=True)
        ref = fn_k(g1_src["stage1"](), residual, Kw, m, **kw)
        saved_limit = osd_cuda._SMEM_LIMIT
        osd_cuda._SMEM_LIMIT = 0
        try:
            a = fn_k(g1_src["stage1"](), residual, Kw, m, **kw)
            torch.cuda.synchronize()
            for nm, x, y in zip(names, a, ref):
                if not torch.equal(x, y):
                    fail(f"phase 6: {kname}'s device-memory branch {nm} "
                         "differs from its shared-memory launch (stage1)")
            alt_exact(key, fn_k, plain, Hp, residual, Kw, m,
                      "stage1, device memory", g1_src["stage1"],
                      rank=dec.rank)
            dm = elim_shape(Hp, residual, Kw, m, a[5], kname, rank=dec.rank)
            dm_alone = g1_fed_ms(kname, g1_src["stage1"], residual, Kw, m,
                                 rank=dec.rank)
        finally:
            osd_cuda._SMEM_LIMIT = saved_limit
        k45[key]["stage1_device_memory"] = dict(dm, alone=dm_alone)
        print(f"phase 6: {kname} device-memory branch forced at stage1 "
              f"(G1's output eliminated in place): every output identical "
              f"to the shared-memory launch and the plain version; "
              + shape_line(dm) + "; alone: " + fed_line(dm_alone),
              flush=True)

    # K4 and K5 at [[288,12,18]], B=37 (phase 3's inputs): three row words
    # a lane, device memory (G1's pack eliminated in place)
    for width, (Hp, Kw, src) in w288.items():
        rerun = width == "basis rerun"
        kw = dict(rank=rank288) if rerun else {}
        for key, kname, fn_k, plain in alts:
            for exit_on_valid in (True,) if rerun else (False, True):
                a, pr = alt_exact(key, fn_k, plain, Hp, res288, Kw, m288,
                                  f"{CODE_288} {width}", src,
                                  exit_on_valid=exit_on_valid, **kw)
            if rerun:
                plain25[kname, "basis rerun 288"] = pr  # K5's: K2's plain
                k45[key]["basis_rerun_288_alone"] = g1_fed_ms(
                    kname, src, res288, Kw, m288, **kw)
                print(f"phase 6: {kname} at {CODE_288} basis rerun "
                      f"({Hp.shape[1]} words, B={BATCH_288}) on G1's pack: "
                      f"exact; alone: "
                      + fed_line(k45[key]["basis_rerun_288_alone"]),
                      flush=True)
                continue
            info = elim_shape(Hp, res288, Kw, m288, a[5], kname)
            if info["columns_in"] != "device memory" or \
                    info["words_per_lane"] != 3:
                fail(f"phase 6: {kname} at {CODE_288} {width} took another "
                     f"branch: {info}")
            print(f"phase 6: {kname} at {CODE_288} {width} ({Hp.shape[1]} "
                  f"words, B={BATCH_288}): on G1's pack exact with and "
                  f"without the validity exit; steps mean "
                  f"{float(a[5].float().mean()):.1f} max "
                  f"{int(a[5].max())}; " + shape_line(info), flush=True)
    rerun288 = w288["basis rerun"]  # phase 25's [[288]] input
    del w288

    # ---- phase 7: layered path (K3 + K2) ----
    fn_l = engine.make_pooled_round_fn(decs[0], decs[1], n_locs, P, BATCH,
                                       MAXITER, OSD_ORDER, RPD,
                                       bp_variant="layered")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    out_l = fn_l(None, randoms=randoms)
    torch.cuda.synchronize()
    dispatch_l_s = time.time() - t0
    per_dispatch_l = counts()
    with plain_versions():
        out_lp = fn_l(None, randoms=randoms)
    torch.cuda.synchronize()
    for key, v in out_l.items():
        if v.shape != (RPD * BATCH,) or not torch.equal(v, out_lp[key]):
            fail(f"phase 7: layered pooled dispatch flag {key} differs "
                 "between the kernels and the plain versions")
    print(f"phase 7: layered pooled dispatch ({RPD}x{BATCH} shots) identical "
          f"through kernels ({dispatch_l_s:.2f} s) and plain versions; "
          f"launches per dispatch K3 {per_dispatch_l['k3']} K2 "
          f"{per_dispatch_l['k2']}; BP converged z "
          f"{int(out_l['z_conv'].sum())} x {int(out_l['x_conv'].sum())} "
          f"(flooding z {int(out_k['z_conv'].sum())} x "
          f"{int(out_k['x_conv'].sum())}) of {RPD * BATCH}", flush=True)
    reset_counts()
    res_l = qt.run_simulation(
        code.Hx, code.Hz, code.Lx, code.Lz, P, num_cycles=CYCLES,
        maxIter=MAXITER, osd_order=OSD_ORDER, max_trials=MAX_TRIALS,
        batch_size=BATCH, rounds_per_dispatch=RPD, base_seed=SEED,
        precomputed_matrices=M, verbose=False, bp_variant="layered",
        **bb_params)
    torch.cuda.synchronize()
    launches_l = counts()
    ler_l, n_l = res_l["logical_error_rate"], res_l["num_trials"]
    print(f"phase 7: run_simulation(bp_variant='layered') {n_l} shots: LER "
          f"{ler_l:.5f}, {res_l['shots_per_sec']:.1f} shots/s, "
          f"{res_l['osd_rank_deficient_shots']} rank-deficient shot-bases; "
          f"launches K3 {launches_l['k3']} K2 {launches_l['k2']}; flooding "
          f"(phase 4): LER {ler:.5f}, {res['shots_per_sec']:.1f} shots/s, "
          f"{res['osd_rank_deficient_shots']} rank-deficient, launches K1 "
          f"{launches['k1']} K2 {launches['k2']}", flush=True)
    if launches_l["k3"] <= 0 or launches_l["k2"] <= 0 \
            or launches_l["g1"] <= 0 or launches_l["k1"]:
        fail(f"phase 7: the layered path ran other kernels than K3 and K2: "
             f"{launches_l}")
    if n_l != MAX_TRIALS or not (0.0 < ler_l < 0.5) \
            or res_l["osd_rank_deficient_shots"]:
        fail(f"phase 7: implausible result {res_l}")

    # ---- phase 8: the main path under each eliminator generation ----
    launches_v = {}
    for version, key in ((2, "k4"), (3, "k5")):
        osd_cuda._KERNEL_VERSION = version
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        out_v = fn(None, randoms=randoms)
        torch.cuda.synchronize()
        dispatch_v_s = time.time() - t0
        c = counts()
        for flag, v in out_v.items():
            if not torch.equal(v, out_k[flag]):
                fail(f"phase 8: flag {flag} under QLDPC_OSD_KERNEL={version} "
                     "differs from the K2 dispatch")
        reset_counts()
        res_v = qt.run_simulation(
            code.Hx, code.Hz, code.Lx, code.Lz, P, num_cycles=CYCLES,
            maxIter=MAXITER, osd_order=OSD_ORDER, max_trials=MAX_TRIALS,
            batch_size=BATCH, rounds_per_dispatch=RPD, base_seed=SEED,
            precomputed_matrices=M, verbose=False, **bb_params)
        torch.cuda.synchronize()
        launches_v[key] = counts()
        osd_cuda._KERNEL_VERSION = 1
        lv = launches_v[key]
        for cnt in (c, lv):
            if cnt[key] <= 0 or cnt["k1"] <= 0 or cnt["k2"]:
                fail(f"phase 8: QLDPC_OSD_KERNEL={version} did not run K1 "
                     f"and {key.upper()} alone: {cnt}")
        if (res_v["logical_errors"], res_v["num_trials"]) != \
                (res["logical_errors"], res["num_trials"]):
            fail(f"phase 8: run_simulation under QLDPC_OSD_KERNEL={version} "
                 f"differs from phase 4: {res_v}")
        print(f"phase 8: QLDPC_OSD_KERNEL={version}: pooled dispatch "
              f"identical to the K2 dispatch ({dispatch_v_s:.2f} s vs "
              f"{dispatch_s:.2f} s), launches K1 {c['k1']} {key.upper()} "
              f"{c[key]}; run_simulation {res_v['num_trials']} shots: LER "
              f"{res_v['logical_error_rate']:.5f} (phase 4's, exactly), "
              f"{res_v['shots_per_sec']:.1f} shots/s, launches K1 {lv['k1']} "
              f"{key.upper()} {lv[key]}", flush=True)

    # ---- phase 9: P1, the iterated on-chip gather ----
    reset_counts()
    bench = gather_bench.main([])  # the entry point, at its whole ladder
    torch.cuda.synchronize()
    c = counts()
    if c["p1"] <= 0 or any(v for k, v in c.items() if k != "p1"):
        fail(f"phase 9: gather_bench did not run P1 alone: {c}")
    p1_launches = c["p1"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = float(sm_clock.split()[0]) * 1e6
    smem_bytes_per_s = SMEM_BYTES_PER_CLK_SM * sms * clock_hz
    p1 = {}
    for (dtype, x, idx), row in zip(gather_bench.ladder_inputs(device=dev),
                                    bench):
        it = gather_bench.ITERS
        total, tile = gather.gather_iterate(x, idx, it)
        torch.cuda.synchronize()
        p_total, p_tile = gather.gather_iterate_plain(x, idx, it)
        where = f"({row['rows']}, {row['lanes']}) {row['dtype']}"
        if not torch.equal(tile, p_tile):
            fail(f"phase 9: P1 tile differs from its plain version {where}")
        rtol = 1e-5 if dtype == torch.float32 else 1e-2
        if total.shape != (1, x.shape[1]) or not torch.allclose(
                total.float(), p_total.float(), rtol=rtol, atol=0.0):
            fail(f"phase 9: P1 column sums differ from the plain version "
                 f"beyond rtol {rtol} {where}")
        index = idx.long()

        def gathers():
            acc = x
            for _ in range(it):
                acc = torch.gather(acc, 0, index)
            return acc

        info = gather.launch_info(*x.shape, dtype, dev)
        t_dev = nbytes(x, idx, total, tile) / HBM_BYTES_PER_S
        t_smem = 2 * x.numel() * x.element_size() * it / smem_bytes_per_s
        wavefronts = gather_timing.round_wavefronts(
            idx.cpu().numpy(), info["lanes"], x.element_size())
        p1[where] = dict(
            ms=row["P1_ms"], plain_ms=row["gather_ms"],
            **gather_timing.p1_times(gather, x, idx, it, dev),
            round_bound_us=t_smem / it * 1e6,
            round_floor_us=wavefronts / clock_hz * 1e6,
            library_ms=cuda_ms(gathers, 10),
            bound_ms=max(t_dev, t_smem) * 1e3, bound_by="bytes",
            bound_from="shared memory" if t_smem > t_dev else "device memory",
            max_abs_err=float((total.float() - p_total.float()).abs().max()),
            plan=[info["lanes"], info["cluster"], info["threads"]],
            active_clusters=info["active_clusters"],
            clusters=info["clusters"])
        r = p1[where]
        print(f"phase 9: P1 {where}: tile exact, sums within rtol {rtol} "
              f"(max abs err {r['max_abs_err']:.3g}); kernel "
              f"{r['kernel_ms']:.4f} ms alone ({r['ms']:.4f} ms a call in "
              f"gather_bench; plain {r['plain_ms']:.3f} ms, {it} "
              f"torch.gather calls {r['library_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_from']} bytes at "
              f"{sm_clock}); load and store {r['load_store_ms']:.4f} ms; one "
              f"round {r['round_us']:.3f} us (conflict-free bound "
              f"{r['round_bound_us']:.3f} us, conflict-aware floor "
              f"{r['round_floor_us']:.3f} us, {wavefronts} wavefronts); plan "
              f"L={info['lanes']} C={info['cluster']} threads="
              f"{info['threads']} E={info['stage']}, {info['registers']} "
              f"registers, {info['clusters']} clusters, "
              f"{info['active_clusters']} active at once", flush=True)
    p1_top = p1["(35280, 128) float32"]
    # every cluster size at the top case: wider clusters cover more of a
    # sector a row, narrower ones fit the GPCs in fewer waves; the plan
    # takes the widest of those with the fewest waves
    x, idx = next(gather_bench.ladder_inputs(((35280, 128),), dev))[1:]
    base = gather.Plan(p1_top["plan"][0], 1, p1_top["plan"][2])
    by_cluster = []
    for cl in (8, 4, 2, 1):
        plan_c = base._replace(cluster=cl)
        if not torch.equal(gather._launch(x, idx, 3, plan_c)[1],
                           gather.gather_iterate_plain(x, idx, 3)[1]):
            fail(f"phase 9: P1 with clusters of {cl} differs from its plain "
                 f"version")
        active = gather._launch_info(*x.shape, plan_c, 0,
                                     torch.cuda.current_device())
        ms_c = gather_timing.graph_ms(
            lambda: gather._launch(x, idx, gather_bench.ITERS, plan_c), 20,
            dev)
        zero_c = gather_timing.graph_ms(
            lambda: gather._launch(x, idx, 0, plan_c), 20, dev)
        by_cluster.append(
            f"C={cl}: {ms_c:.4f} ms, load and store {zero_c:.4f} ms, "
            f"{active['blocks'] // cl} clusters, "
            f"{active['active_clusters']} active at once")
    print(f"phase 9: P1 (35280, 128) float32 by cluster size (the plan takes "
          f"C={p1_top['plan'][1]}): " + "; ".join(by_cluster), flush=True)

    # ---- phase 10: P2, take-along-axis ----
    reset_counts()
    gather_probe.main([])  # exits non-zero on a mismatch
    torch.cuda.synchronize()
    c = counts()
    if c["p2"] <= 0 or any(v for k, v in c.items() if k != "p2"):
        fail(f"phase 10: gather_probe did not run P2 alone: {c}")
    p2_launches = c["p2"]
    p2 = {}
    for name, shape, dtype, axis in gather_probe.cases():
        x, idx = gather_probe.probe_inputs(shape, dtype, axis, dev)
        out = gather.take_along(x, idx, axis)
        torch.cuda.synchronize()
        if not torch.equal(out, gather.take_along_plain(x, idx, axis)) or \
                not torch.equal(out, torch.take_along_dim(x, idx.long(),
                                                          axis)):
            fail(f"phase 10: P2 differs from its plain version or "
                 f"torch.take_along_dim ({name})")
        if shape in gather_timing.P2_SHAPES and dtype == torch.float32:
            index = idx.long()
            p2[shape, axis] = dict(
                ms=cuda_ms(lambda: gather.take_along(x, idx, axis), 50),
                plain_ms=cuda_ms(
                    lambda: gather.take_along_plain(x, idx, axis), 50),
                library_ms=cuda_ms(
                    lambda: torch.take_along_dim(x, index, axis), 50),
                bound_ms=nbytes(x, idx, out) / HBM_BYTES_PER_S * 1e3,
                **gather_timing.p2_times(gather, wall_ms, x, idx, axis, dev))
    p2_top = p2[(1024, 128), 0]
    print(f"phase 10: P2 equals its plain version and torch.take_along_dim "
          f"at all {len(list(gather_probe.cases()))} probe cases; "
          f"(1024, 128) float32: " + "; ".join(
              f"axis {ax} kernel {r['kernel_ms'] * 1e3:.2f} us alone (launch "
              f"floor at (8, 128) {p2[(8, 128), ax]['kernel_ms'] * 1e3:.2f} "
              f"us), a call {r['wall_ms'] * 1e3:.2f} us on the host clock, "
              f"{r['ms'] * 1e3:.2f} us back to back; take_along_dim "
              f"{r['library_kernel_ms'] * 1e3:.2f} us alone, "
              f"{r['library_wall_ms'] * 1e3:.2f} us a call; plain "
              f"{r['plain_ms']:.4f} ms; bound {r['bound_ms'] * 1e3:.3f} us "
              f"by bytes" for (shp, ax), r in p2.items()
              if shp == (1024, 128)), flush=True)

    # ---- phase 11: the bp_breakdown entry point (K1) at B=1024 ----
    save_matrices(str(bp_breakdown.CACHE_DIR),
                  compute_cache_key(code.Hx, code.Hz, code.Lx, code.Lz,
                                    CYCLES, P), M)  # its cycles: d = 12
    reset_counts()
    brk = bp_breakdown.main(["--batch", str(BATCH), "--reps", "50"])
    torch.cuda.synchronize()
    c = counts()
    if c["k1"] <= 0 or any(v for k, v in c.items()
                           if k not in ("k1", "s1")):
        fail(f"phase 11: bp_breakdown did not run K1 alone: {c}")
    times = [v for k, v in brk.items() if k.endswith("_ms")]
    if not all(np.isfinite(times)) or brk["kernel20_ms"] <= 0 \
            or brk["converged20"] <= 0:
        fail(f"phase 11: implausible breakdown {brk}")
    print(f"phase 11: bp_breakdown [[144,12,12]] B={BATCH}: K1 launches "
          f"{c['k1']}; kernel per-iteration {brk['kernel_per_iter_ms']:.4f} "
          f"ms (first design {K1_EARLIER_PER_ITER_MS} ms), full "
          f"per-iteration {brk['full_per_iter_ms']:.4f} ms, wrapper "
          f"postprocess {brk['postprocess_ms']:.3f} ms", flush=True)

    # ---- phase 12: the main path's LER against matched JAX records ----
    # run_simulation (flooding, K2, dynamical alpha, OSD order 2) to the
    # records' error counts; |z| <= 3 with binomial sigma on both sides
    for name, cycles, p, max_iter, target, ref_errs, ref_n, src in (
            (CODE, CYCLES, P, 20, 200, 200, 1264, "VALIDATION.md:20"),
            ("[[72, 12, 6]]", 6, 0.004, 50, 100, 100, 652,
             "VALIDATION.md:102")):
        c = qt.get_code(name)
        reset_counts()
        t0 = time.time()
        r = qt.run_simulation(
            c.Hx, c.Hz, c.Lx, c.Lz, p, num_cycles=cycles, maxIter=max_iter,
            osd_order=OSD_ORDER, target_logical_errors=target,
            max_trials=LER_MAX_TRIALS, batch_size=BATCH,
            rounds_per_dispatch=RPD, base_seed=SEED,
            precomputed_matrices=M if (name, p) == (CODE, P) else None,
            verbose=False, ell=c.ell, m=c.m, a_x_powers=c.a_x_powers,
            a_y_powers=c.a_y_powers, b_y_powers=c.b_y_powers,
            b_x_powers=c.b_x_powers)
        torch.cuda.synchronize()
        cnt = counts()
        ler, n = r["logical_error_rate"], r["num_trials"]
        ref = ref_errs / ref_n
        z = (ler - ref) / np.sqrt(ler * (1 - ler) / max(n, 1)
                                  + ref * (1 - ref) / ref_n)
        print(f"phase 12: {name} p={p} maxIter {max_iter}: LER {ler:.5f} "
              f"({r['logical_errors']}/{n}) against the JAX record {ref:.4f} "
              f"({ref_errs}/{ref_n}, {src}): z {z:+.2f}; "
              f"{r['osd_rank_deficient_shots']} rank-deficient shot-bases; "
              f"launches K1 {cnt['k1']} K2 {cnt['k2']}; "
              f"{time.time() - t0:.1f} s", flush=True)
        if cnt["k1"] <= 0 or cnt["k2"] <= 0:
            fail(f"phase 12: run_simulation did not launch K1 and K2: {cnt}")
        if r["logical_errors"] < target or abs(z) > 3:
            fail(f"phase 12: {name} LER {ler:.5f} ({r['logical_errors']}/"
                 f"{n}) is not within 3 sigma of the JAX record {ref:.4f}")

    # ---- phase 13: generic BP on the card against the port on the CPU ----
    dec = decs[0]
    t13 = time.time()
    H_z = M["HdecZ"]
    g_dev = bp.TannerGraph.from_dense(H_z, device=dev)
    g_cpu = bp.TannerGraph.from_dense(H_z, device="cpu")
    HT_z = torch.as_tensor((np.asarray(H_z) != 0).T.astype(np.float32),
                           device=dev)
    _, syn13 = calibrate._sample_errors_and_syndromes(
        calibrate._generator(dev, SEED, 13), HT_z, g_dev.n, P, GENERIC_B)
    cpu_args = (syn13.cpu(), dec.prior.cpu(), dec.alpha_seq.cpu())
    dev_args = (syn13, dec.prior, dec.alpha_seq)
    generic = {}
    for name, kw in (("float32", {}), ("damping 0.8", dict(damping=0.8)),
                     ("tanh", None),
                     ("bfloat16", dict(msg_dtype=torch.bfloat16))):
        def run(g, syn, prior, seq, kw=kw):
            if kw is None:
                return bp.decode_batch_tanh(g, syn, prior, MAXITER)
            return bp.decode_batch(g, syn, prior, seq, MAXITER, **kw)

        torch.cuda.synchronize()
        t0 = time.time()
        a = run(g_dev, *dev_args)
        torch.cuda.synchronize()
        gpu_ms = (time.time() - t0) * 1e3
        t0 = time.time()
        b = run(g_cpu, *cpu_args)
        cpu_s = time.time() - t0
        a = {k: v.cpu() for k, v in a.items()}
        differ = ((a["hard"] != b["hard"]).any(1)
                  | (a["converged"] != b["converged"])
                  | (a["iterations"] != b["iterations"]))
        n_diff = int(differ.sum())
        same_values = torch.equal(a["values"], b["values"])
        err = float((a["values"] - b["values"]).abs().max())
        generic[name] = dict(gpu_ms=gpu_ms, cpu_s=cpu_s, differing=n_diff,
                             same_values=same_values, max_abs_err=err,
                             converged=int(a["converged"].sum()),
                             mean_iters=float(
                                 (a["iterations"].float() + 1).mean()))
        r = generic[name]
        print(f"phase 13: {name}: card {gpu_ms:.1f} ms "
              f"({gpu_ms / r['mean_iters']:.2f} ms per iteration of the "
              f"mean), CPU {cpu_s:.1f} s; {n_diff}/{GENERIC_B} shots differ "
              f"in a decision; values "
              f"{'bit-identical' if same_values else f'max abs err {err:.3g}'}"
              f"; {r['converged']}/{GENERIC_B} converged, mean "
              f"{r['mean_iters']:.2f} iterations", flush=True)
        if name == "float32" and (n_diff or not same_values):
            fail("phase 13: float32 generic BP differs between the card and "
                 "the CPU")
        if name in ("damping 0.8", "tanh") and n_diff:
            fail(f"phase 13: {name} decisions differ between the card and "
                 "the CPU")
        if name == "bfloat16" and n_diff > BF16_MAX_DIFFERING:
            fail(f"phase 13: bfloat16: {n_diff} shots differ (bound "
                 f"{BF16_MAX_DIFFERING})")
        if not r["converged"]:
            fail(f"phase 13: {name} converged no shot")
    del g_dev, HT_z

    # K1 against its plain version under a fitted (Alvarado) alpha, on
    # phase 2's syndromes
    def k1_exact(seq_np, where):
        args = (dec.lifted, syns["Z"], dec.prior,
                torch.as_tensor(np.asarray(seq_np, np.float32), device=dev),
                MAXITER)
        a = bp_lift_cuda.decode_batch_lift_cuda(*args)
        torch.cuda.synchronize()
        b = bp_lift_cuda.decode_batch_lift_plain(*args)
        for key in ("hard", "converged", "iterations"):
            if not torch.equal(a[key], b[key]):
                fail(f"{where}: K1 {key} differs from the plain version")
        unconv = ~b["converged"]
        if not torch.equal(a["values"][unconv], b["values"][unconv]):
            fail(f"{where}: K1 values of unconverged shots differ")
        return int(a["converged"].sum())

    trials13 = engine._calib_trials(None, H_z.shape[1], P)
    llrs_z = qt.channel_llrs(M["channel_probsZ"])
    t0 = time.time()
    alpha13, r2_13 = calibrate.estimate_alpha_alvarado(
        H_z, P, trials=trials13, llrs=llrs_z, seed=SEED, device=dev)
    fit13_s = time.time() - t0

    # one calibration point's binning: on the card (calibrate._histogram)
    # against numpy's np.histogram after a copy to the host (the JAX
    # package's way), on the buckets of one Alvarado harvest
    _, g_c, HT_c, prior_c = calibrate._setup(H_z, llrs_z, dev)
    buckets = calibrate._harvest_buckets(g_c, HT_c, prior_c, P, trials13,
                                         (SEED,), np.zeros(0, np.float32), 0)
    del g_c, HT_c

    def bins_card():
        x = [t.double() for t in buckets]
        x = [v[torch.isfinite(v) & (v.abs() < 1e29)] for v in x]
        lo, hi = min(float(v.min()) for v in x), max(float(v.max())
                                                      for v in x)
        return [calibrate._histogram(v, lo, hi, 50)[0] for v in x]

    def bins_host():
        x = [t.cpu().numpy().astype(np.float64) for t in buckets]
        x = [v[np.isfinite(v) & (np.abs(v) < 1e29)] for v in x]
        lo, hi = min(v.min() for v in x), max(v.max() for v in x)
        return [np.histogram(v, 50, range=(lo, hi), density=True)[0]
                for v in x]

    hist_ms = {}
    for name, fn_h in (("card", bins_card), ("host", bins_host)) * 2:
        torch.cuda.synchronize()
        t0 = time.time()
        dens = fn_h()
        hist_ms.setdefault(name, []).append((time.time() - t0) * 1e3)
        hist_ms[name + "_out"] = dens
    same_bins = all(np.array_equal(a, b) for a, b in
                    zip(hist_ms["card_out"], hist_ms["host_out"]))
    n_msgs = sum(int(t.numel()) for t in buckets)
    del buckets
    print(f"phase 13: one calibration point's binning ({n_msgs} messages, "
          f"50 bins): card {min(hist_ms['card']):.2f} ms, host copy + "
          f"np.histogram {min(hist_ms['host']):.2f} ms (best of 2); "
          f"densities {'identical' if same_bins else 'DIFFER'}; an "
          f"autoregressive calibration bins {2 * MAXITER} such points",
          flush=True)
    if not same_bins:
        fail("phase 13: the card's calibration histogram differs from "
             "np.histogram")
    conv13 = k1_exact(alpha_schedule("alvarado", MAXITER, alpha13),
                      "phase 13")
    print(f"phase 13: Alvarado fit (basis Z, 500 trials) alpha "
          f"{alpha13:.5f}, R^2 {r2_13:.4f} in {fit13_s:.2f} s; K1 under it "
          f"(B={BATCH}): every decision and the unconverged shots' values "
          f"identical to the plain version, {conv13}/{BATCH} converged "
          f"(dynamical: {k1['Z']['converged']}); phase {time.time() - t13:.1f}"
          f" s", flush=True)

    # ---- phase 14: calibrated run_simulation, damping and tanh ----
    calib_s: dict = {}
    saved = {name: getattr(engine, name)
             for name in ("_calibrate_basis_sequences", "_scopt_betas")}

    def timed(name):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            out = saved[name](*a, **kw)
            torch.cuda.synchronize()
            calib_s[name] = time.time() - t0
            return out
        return wrapper

    # fits that raised calibrate.FitFailed and fell back; the R^2 gate's
    # rejections are the other fallbacks
    fit_raised = [0]
    fit_saved = calibrate._fit_log_ratio

    def counting_fit(*a, **kw):
        try:
            return fit_saved(*a, **kw)
        except calibrate.FitFailed:
            fit_raised[0] += 1
            raise

    for name in saved:
        setattr(engine, name, timed(name))
    calibrate._fit_log_ratio = counting_fit
    try:
        reset_counts()
        t0 = time.time()
        ar = qt.run_simulation(
            code.Hx, code.Hz, code.Lx, code.Lz, P, num_cycles=CYCLES,
            maxIter=MAXITER, osd_order=OSD_ORDER, target_logical_errors=200,
            max_trials=LER_MAX_TRIALS, batch_size=BATCH,
            rounds_per_dispatch=RPD, base_seed=SEED, precomputed_matrices=M,
            verbose=False, alpha_mode="alvarado-autoregressive", **bb_params)
        torch.cuda.synchronize()
        ar_s = time.time() - t0
        launches_ar = counts()
        ar_calib_s = calib_s.pop("_calibrate_basis_sequences")
        ar_raised = fit_raised[0]
        reset_counts()
        sc = qt.run_simulation(
            code.Hx, code.Hz, code.Lx, code.Lz, P, num_cycles=CYCLES,
            maxIter=MAXITER, osd_order=OSD_ORDER, max_trials=BATCH * RPD,
            batch_size=BATCH, rounds_per_dispatch=RPD, base_seed=SEED,
            precomputed_matrices=M, verbose=False, alpha_mode="alvarado",
            scopt=True, **bb_params)
        torch.cuda.synchronize()
        launches_sc = counts()
    finally:
        for name, fn_s in saved.items():
            setattr(engine, name, fn_s)
        calibrate._fit_log_ratio = fit_saved
    ler, n = ar["logical_error_rate"], ar["num_trials"]
    ref = AR_REF_ERRS / AR_REF_TRIALS
    z = (ler - ref) / np.sqrt(ler * (1 - ler) / max(n, 1)
                              + ref * (1 - ref) / AR_REF_TRIALS)
    seq_ar = {b: np.asarray(ar[f"alpha_seq_{b}"]) for b in "zx"}
    r2_ar = {b: np.asarray(ar[f"alpha_r2_values_{b}"]) for b in "zx"}
    n_gated = ar["n_alpha_fallbacks_z"] + ar["n_alpha_fallbacks_x"] - \
        ar_raised
    print(f"phase 14: run_simulation(alpha_mode='alvarado-autoregressive') "
          f"{CODE} p={P} maxIter {MAXITER}: calibration {ar_calib_s:.1f} s "
          f"(500 trials a basis, {MAXITER} fits each); alpha z "
          f"{seq_ar['z'].min():.4f}-{seq_ar['z'].max():.4f}, x "
          f"{seq_ar['x'].min():.4f}-{seq_ar['x'].max():.4f}; fallbacks z "
          f"{ar['n_alpha_fallbacks_z']} x {ar['n_alpha_fallbacks_x']}, of "
          f"which {ar_raised} fits raised (no finite sample, no shared bin or"
          f" no optimum) and {n_gated} were rejected by the gate; R^2 "
          f"min/median z {np.nanmin(r2_ar['z']):.4f}/"
          f"{np.nanmedian(r2_ar['z']):.4f} x {np.nanmin(r2_ar['x']):.4f}/"
          f"{np.nanmedian(r2_ar['x']):.4f}; LER {ler:.5f} "
          f"({ar['logical_errors']}/{n}) against the JAX record {ref:.4f} "
          f"({AR_REF_ERRS}/{AR_REF_TRIALS}, VALIDATION.md:106): z {z:+.2f}; "
          f"{ar['osd_rank_deficient_shots']} rank-deficient shot-bases; "
          f"{ar['shots_per_sec']:.1f} shots/s; launches K1 "
          f"{launches_ar['k1']} K2 {launches_ar['k2']}; {ar_s:.1f} s",
          flush=True)
    if launches_ar["k1"] <= 0 or launches_ar["k2"] <= 0 or any(
            launches_ar[k] for k in ("k3", "k4", "k5")):
        fail(f"phase 14: the calibrated path did not run K1 and K2 alone: "
             f"{launches_ar}")
    if ar["logical_errors"] < 200 or abs(z) > 3:
        fail(f"phase 14: autoregressive LER {ler:.5f} is not within 3 sigma "
             f"of the JAX record {ref:.4f}")
    conv14 = k1_exact(seq_ar["z"], "phase 14")
    print(f"phase 14: K1 under the fitted Z sequence (B={BATCH}): every "
          f"decision and the unconverged shots' values identical to the "
          f"plain version; {conv14}/{BATCH} converged (dynamical: "
          f"{k1['Z']['converged']})", flush=True)
    alphas = {b: sc[f"alpha_seq_{b}"][0] for b in "zx"}
    print(f"phase 14: run_simulation(alpha_mode='alvarado', scopt=True) "
          f"{sc['num_trials']} shots: alpha z {alphas['z']:.5f} (R^2 "
          f"{sc['alpha_r2_z']:.4f}) x {alphas['x']:.5f} (R^2 "
          f"{sc['alpha_r2_x']:.4f}); beta z {sc['beta_z']:.5f} (R^2 "
          f"{sc['beta_r2_z']:.4f}) x {sc['beta_x']:.5f} (R^2 "
          f"{sc['beta_r2_x']:.4f}), fitted in "
          f"{calib_s['_scopt_betas']:.1f} s; LER "
          f"{sc['logical_error_rate']:.5f}; launches K1 {launches_sc['k1']} "
          f"K2 {launches_sc['k2']}", flush=True)
    if not all(0.05 < a < 1.5 for a in alphas.values()) or not \
            (sc["beta_z"] < 0 and sc["beta_x"] < 0):
        fail(f"phase 14: implausible Alvarado alpha or SCOPT beta: {sc}")
    if launches_sc["k1"] <= 0 or launches_sc["k2"] <= 0:
        fail(f"phase 14: the Alvarado run did not launch K1 and K2: "
             f"{launches_sc}")
    for name, kw in (("damping 0.8", dict(damping=0.8)),
                     ("tanh", dict(bp_variant="tanh"))):
        fn_g = engine.make_pooled_round_fn(decs[0], decs[1], n_locs, P, BATCH,
                                           MAXITER, OSD_ORDER, RPD, **kw)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        out_g = fn_g(None, randoms=randoms)
        torch.cuda.synchronize()
        c = counts()
        rd = int(out_g["z_rankdef"].sum() + out_g["x_rankdef"].sum())
        print(f"phase 14: {name} pooled dispatch ({RPD}x{BATCH} shots) in "
              f"{time.time() - t0:.2f} s: BP converged z "
              f"{int(out_g['z_conv'].sum())} x {int(out_g['x_conv'].sum())} "
              f"(flooding z {int(out_k['z_conv'].sum())} x "
              f"{int(out_k['x_conv'].sum())}), {int(out_g['any_err'].sum())} "
              f"logical errors (flooding {int(out_k['any_err'].sum())}), {rd} "
              f"rank-deficient; launches K1 {c['k1']} K2 {c['k2']}",
              flush=True)
        if c["k2"] <= 0 or any(c[k] for k in ("k1", "k3", "k4", "k5")):
            fail(f"phase 14: the {name} dispatch ran other kernels than K2: "
                 f"{c}")
        if rd:
            fail(f"phase 14: {name}: {rd} rank-deficient shot-bases")

    # ---- phase 15: multi-code at full width ----
    # [[90,8,10]] + [[108,8,10]], 10 cycles, p=0.004, maxIter 20, OSD order
    # 2, dynamical alpha, 1024 shots a round, 4 rounds a dispatch
    t15 = time.time()
    mc_specs, mc_M, mc = [], [], {}
    seq_mc = alpha_schedule("dynamical", MC_MAXITER)
    for name in MC_CODES:
        c = qt.get_code(name)
        circ_c = qt.SyndromeCircuit(c, num_cycles=MC_CYCLES)
        M_c = qt.build_decoding_matrices(circ_c, c.Lx, c.Lz, P)
        dz, dx = (engine._make_basis(circ_c, M_c, b, seq_mc,
                                     osd_order=OSD_ORDER, device=dev)
                  for b in "ZX")
        mc_M.append(M_c)
        mc_specs.append(dict(dec_z=dz, dec_x=dx,
                             n_locs=circ_c.num_error_locs, error_rate=P,
                             batch=BATCH, maxIter=MC_MAXITER,
                             osd_order=OSD_ORDER))
        # K1 (both bases) and K2 (each basis's BP-failed shots at stage 1,
        # prefix and full width) against their plain versions, one batch
        trials_c = trial_batch(torch.Generator(device=dev).manual_seed(SEED),
                               P, dz.maps, dx.maps, circ_c.num_error_locs,
                               BATCH)
        mc[name] = {}
        for basis, d in (("Z", dz), ("X", dx)):
            syn = trials_c[f"syndrome_{basis.lower()}"]
            args = (d.lifted, syn, d.prior, d.alpha_seq, MC_MAXITER)
            a = bp_lift_cuda.decode_batch_lift_cuda(*args)
            torch.cuda.synchronize()
            b = bp_lift_cuda.decode_batch_lift_plain(*args)
            for key in ("hard", "converged", "iterations", "values"):
                if not torch.equal(a[key], b[key]):
                    fail(f"phase 15: K1 {key} differs from the plain version "
                         f"at {name} basis {basis}")
            geo = bp_lift_cuda.flood_geometry(d.lifted, dev)
            tabs = bp_lift_cuda.flood_tables(d.lifted, dev)
            shot_iters = int((a["iterations"].long() + 1).sum())
            kb, bb = bound(
                nbytes(syn, a["values"], a["hard"], a["converged"],
                       a["iterations"], d.prior, d.alpha_seq,
                       geo["pos_info"], geo["wrap_words"],
                       tabs["prior_grid"], tabs["out_gather"],
                       tabs["residual"]),
                K1_OPS_PER_EDGE_ITER * int(d.H.sum()) * shot_iters)
            r = dict(k1_ms=cuda_ms(
                lambda: bp_lift_cuda.decode_batch_lift_cuda(*args), 5),
                k1_plain_ms=cuda_ms(
                    lambda: bp_lift_cuda.decode_batch_lift_plain(*args), 1),
                k1_bound_ms=kb, k1_bound_by=bb,
                converged=int(a["converged"].sum()),
                mean_iters=shot_iters / BATCH,
                k1_shape=bp_lift_cuda.flood_launch_info(d.lifted, dev))
            fail_b = ~a["converged"]
            m_c, K_c, R_c = d.H.shape[0], d.K, d.basis_cols.shape[0]
            res_c = osd_cuda.bp_residual(syn[fail_b], a["hard"][fail_b],
                                         d.HT, d.col_index)[0]
            cols_c = torch.sort(a["values"][fail_b].abs(), dim=1,
                                stable=True).indices
            HT_c = d.H.T.contiguous()
            Hb_c = torch.zeros((m_c, -(-R_c // 32) * 32), dtype=torch.uint8,
                               device=dev)
            Hb_c[:, :R_c] = d.H[:, d.basis_cols]
            pref_c = osd._gather_pack(HT_c, cols_c[:, :K_c], K_c,
                                      words_major=True)
            widths_c = {
                "stage1": (osd._gather_pack(HT_c, cols_c[:, :256], 256,
                                            words_major=True), 256),
                "prefix": (pref_c, K_c),
                "full": (torch.cat([pref_c, osd._pack_columns(Hb_c).T
                                    .contiguous()[None]
                                    .expand(len(cols_c), -1, -1)], 1),
                         K_c + R_c)}
            for width, (Hp, Kw) in widths_c.items():
                for exit_on_valid in (False, True):
                    ka, kp = k2_exact(Hp, res_c, Kw, m_c,
                                      f"phase 15: {name} {basis} {width}",
                                      rank=d.rank,
                                      exit_on_valid=exit_on_valid)
                k2_err = max(k2_err, max(
                    float((x.long() - y.long()).abs().max())
                    for x, y in zip(ka, kp)))
                k2b, k2by = bound(
                    2 * nbytes(Hp, res_c) + nbytes(ka[4], ka[5]),
                    K2_OPS_PER_ROW_STEP * m_c * int(ka[5].long().sum())
                    + K2_OPS_PER_XOR_WORD * int(kp[6].sum()))
                r[f"k2_{width}"] = dict(
                    ms=wrapper_ms(osd_cuda.eliminate_blocks_v1, colsof(Hp),
                                  res_c, Kw, m_c, rank=d.rank),
                    words=Hp.shape[1], shots=len(Hp), bound_ms=k2b,
                    bound_by=k2by, max_steps=int(ka[5].max()))
            Hp, Kw = widths_c["stage1"]
            r["k2_stage1"]["plain_ms"] = cuda_ms(
                lambda: osd_cuda.eliminate_blocks_plain(Hp, res_c, Kw, m_c,
                                                        rank=d.rank), 1)
            mc[name][basis] = r
            print(f"phase 15: {name} basis {basis} ({m_c} x {d.H.shape[1]}, "
                  f"B={BATCH}, maxIter {MC_MAXITER}): K1 exact, "
                  f"{r['k1_ms']:.3f} ms (plain {r['k1_plain_ms']:.1f} ms, "
                  f"bound {kb:.4f} ms by {bb}; {r['k1_shape']['state_bytes']}"
                  f" state bytes a shot in {r['k1_shape']['state_in']}, "
                  f"{r['k1_shape']['blocks_per_sm']} blocks per SM), "
                  f"{r['converged']}/{BATCH} converged, mean "
                  f"{r['mean_iters']:.2f} iterations; K2 exact on "
                  f"{len(cols_c)} failed shots with and without the validity "
                  f"exit: " + ", ".join(
                      f"{w} ({r[f'k2_{w}']['words']} words) "
                      f"{r[f'k2_{w}']['ms']:.3f} ms (bound "
                      f"{r[f'k2_{w}']['bound_ms']:.4f} ms by "
                      f"{r[f'k2_{w}']['bound_by']})" for w in widths_c)
                  + f"; stage-1 plain {r['k2_stage1']['plain_ms']:.1f} ms",
                  flush=True)
            del widths_c, pref_c, HT_c, Hb_c

    # one pooled multi-code dispatch against each code's own pooled
    # dispatch on the same generator seeds
    fn_mc = engine.make_multi_code_pooled_round_fn(mc_specs, RPD)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    out_mc = fn_mc([mesh.generator(SEED, 0, i, device=dev)
                    for i in range(len(MC_CODES))])
    torch.cuda.synchronize()
    mc_dispatch_s = time.time() - t0
    c_mc = counts()
    for i, (name, sp) in enumerate(zip(MC_CODES, mc_specs)):
        own = engine.make_pooled_round_fn(
            sp["dec_z"], sp["dec_x"], sp["n_locs"], P, BATCH, MC_MAXITER,
            OSD_ORDER, RPD)(mesh.generator(SEED, 0, i, device=dev))
        for key, v in own.items():
            if v.shape != (RPD * BATCH,) or not torch.equal(v,
                                                            out_mc[i][key]):
                fail(f"phase 15: {name}'s flag {key} differs between the "
                     "multi-code dispatch and its own dispatch")
    print(f"phase 15: one multi-code dispatch ({RPD}x{BATCH} shots a code) "
          f"in {mc_dispatch_s:.2f} s equals each code's own pooled dispatch "
          f"on the same seeds; launches S1 {c_mc['s1']} K1 {c_mc['k1']} R1 "
          f"{c_mc['r1']} K2 {c_mc['k2']}; "
          "BP converged " + ", ".join(
              f"{n} z {int(o['z_conv'].sum())} x {int(o['x_conv'].sum())}"
              for n, o in zip(MC_CODES, out_mc)), flush=True)

    # run_multi_code_simulation to 200 errors a code against the records,
    # then a fixed-length run for the steady rate
    mc_kw = dict(num_cycles=MC_CYCLES, maxIter=MC_MAXITER,
                 osd_order=OSD_ORDER, batch_size=BATCH,
                 rounds_per_dispatch=RPD, base_seed=SEED,
                 precomputed_matrices=mc_M, verbose=False)
    reset_counts()
    t0 = time.time()
    res_mc = qt.run_multi_code_simulation(
        list(MC_CODES), P, target_logical_errors=200,
        max_trials=LER_MAX_TRIALS, **mc_kw)
    torch.cuda.synchronize()
    mc_run_s = time.time() - t0
    launches_mc = counts()
    if c_mc["s1"] != RPD * len(MC_CODES):
        fail(f"phase 15: the multi-code dispatch launched S1 {c_mc['s1']} "
             f"times, not once a round and code")
    if c_mc["r1"] != 2 * len(MC_CODES):
        fail(f"phase 15: the multi-code dispatch launched R1 {c_mc['r1']} "
             f"times, not once a basis and code")
    if launches_mc["k1"] <= 0 or launches_mc["k2"] <= 0 \
            or launches_mc["r1"] <= 0 or any(
                v for k, v in launches_mc.items()
                if k not in ("k1", "k2", "g1", "s1", "r1")):
        fail(f"phase 15: the multi-code run did not run K1 and K2 alone: "
             f"{launches_mc}")
    for name in MC_CODES:
        r = res_mc[name]
        ler, n = r["logical_error_rate"], r["num_trials"]
        ref_errs, ref_n, src = MC_REF[name]
        ref = ref_errs / ref_n
        z = (ler - ref) / np.sqrt(ler * (1 - ler) / max(n, 1)
                                  + ref * (1 - ref) / ref_n)
        mc[name]["run"] = dict(ler=ler, n=n, z=z)
        print(f"phase 15: run_multi_code_simulation {name}: LER {ler:.5f} "
              f"({r['logical_errors']}/{n}) against the JAX record {ref:.3f} "
              f"({ref_errs}/{ref_n}, {src}): z {z:+.2f}; "
              f"{r['osd_rank_deficient_shots']} rank-deficient shot-bases; "
              f"shots/s {r['shots_per_sec']:.1f}, combined "
              f"{r['combined_shots_per_sec']:.1f}", flush=True)
        if r["logical_errors"] < 200 or abs(z) > 3:
            fail(f"phase 15: {name} LER {ler:.5f} is not within 3 sigma of "
                 f"the JAX record {ref:.3f}")
    reset_counts()
    steady_mc = qt.run_multi_code_simulation(
        list(MC_CODES), P, max_trials=MC_STEADY_DISPATCHES * RPD * BATCH,
        **mc_kw)
    torch.cuda.synchronize()
    launches_steady = counts()
    print(f"phase 15: run to 200 errors a code: launches K1 "
          f"{launches_mc['k1']} K2 {launches_mc['k2']} (nothing else), "
          f"{mc_run_s:.1f} s; fixed {MC_STEADY_DISPATCHES}-dispatch run "
          f"({MC_STEADY_DISPATCHES * RPD * BATCH} shots a code, the first "
          f"dispatch excluded from the rates): " + ", ".join(
              f"{n} {r['shots_per_sec']:.1f} shots/s (LER "
              f"{r['logical_error_rate']:.5f})"
              for n, r in steady_mc.items())
          + f", combined {steady_mc[MC_CODES[0]]['combined_shots_per_sec']:.1f}"
          f" shots/s; launches K1 {launches_steady['k1']} K2 "
          f"{launches_steady['k2']}; phase {time.time() - t15:.1f} s",
          flush=True)
    del mc_specs, out_mc

    # ---- phase 16: the shot mesh on the card ----
    # two processes share the card in one gloo group (NCCL refuses two
    # ranks on one GPU), against this process holding two shards
    t16 = time.time()
    verdict = multihost_smoke.main(["--device", "cuda"])
    if not verdict["ok"]:
        fail(f"phase 16: the two-process run differs from the two-shard "
             f"run: {verdict}")
    print(f"phase 16: multihost_smoke --device cuda: both configurations "
          f"identical in two gloo processes (one shard each) and in one "
          f"process (two shards): " + "; ".join(
              f"{nm} {v['single']['num_trials']} trials, "
              f"{v['single']['logical_errors']} errors"
              for nm, v in verdict.items() if isinstance(v, dict))
          + f" ({time.time() - t16:.1f} s)", flush=True)

    # a one-rank NCCL group drives run_simulation through the all_reduce of
    # the counts, the all_gather of the crossing round's flags and the
    # broadcasts of the seed and the fitted sequences, on CUDA tensors; it
    # must equal the same run without a process group
    import torch.distributed as dist
    cfg = multihost_smoke.CONFIGS["calibrated"]
    alone = multihost_smoke.run_config(cfg, dev)
    seen = {}
    saved_coll = {nm: getattr(dist, nm)
                  for nm in ("all_reduce", "all_gather", "broadcast")}

    def recording(nm):
        def call(tensor, *a, **kw):
            t = tensor[0] if isinstance(tensor, list) else tensor
            seen.setdefault(nm, set()).add(t.device.type)
            return saved_coll[nm](tensor, *a, **kw)
        return call

    os.environ.update(QLDPC_COORDINATOR=f"localhost:"
                      f"{multihost_smoke.free_port()}",
                      QLDPC_NUM_PROCESSES="1", QLDPC_PROCESS_ID="0")
    t0 = time.time()
    try:
        if not mesh.distributed_init_from_env():
            fail("phase 16: distributed_init_from_env did not join a group")
        if dist.get_backend() != "nccl":
            fail(f"phase 16: the default backend on the card is "
                 f"{dist.get_backend()}, not nccl")
        for nm in saved_coll:
            setattr(dist, nm, recording(nm))
        in_group = multihost_smoke.run_config(cfg, dev)
    finally:
        for nm, f in saved_coll.items():
            setattr(dist, nm, f)
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in ("QLDPC_COORDINATOR", "QLDPC_NUM_PROCESSES",
                  "QLDPC_PROCESS_ID"):
            os.environ.pop(k, None)
    if in_group != alone:
        fail(f"phase 16: the one-rank NCCL run differs from the run without "
             f"a group: {in_group} vs {alone}")
    if set(seen) != set(saved_coll) or any(v != {"cuda"}
                                           for v in seen.values()):
        fail(f"phase 16: collectives seen in the NCCL run: {seen}")
    print(f"phase 16: one-rank NCCL group: run_simulation (calibrated, "
          f"{in_group['num_trials']} trials, {in_group['logical_errors']} "
          f"errors) equals the run without a group; all_reduce, all_gather "
          f"and broadcast ran on CUDA tensors ({time.time() - t0:.1f} s); "
          f"NCCL across GPUs is not checked (one card)", flush=True)

    # ---- phase 17: BatchDecoder at full width ----
    # phase 4's pooled dispatch randoms (4 x 1024 shots), their syndromes
    # decoded through the public API in each basis, against the flags of
    # phase 4's (flooding) and phase 7's (layered) pooled dispatches
    t17 = time.time()
    trials = [trial_batch(None, P, decs[0].maps, decs[1].maps, n_locs, BATCH,
                          randoms=r) for r in randoms]
    api = {}
    for variant, ref_out, bp_key in (("minsum", out_k, "k1"),
                                     ("layered", out_l, "k3")):
        bdec = qt.BatchDecoder(code.Hx, code.Hz, code.Lx, code.Lz, P,
                               num_cycles=CYCLES, maxIter=MAXITER,
                               osd_order=OSD_ORDER, precomputed_matrices=M,
                               device=dev, bp_variant=variant, **bb_params)
        bdec.decode(torch.cat([t["syndrome_z"] for t in trials])[:BATCH]
                    .cpu().numpy(), "Z", BATCH)  # warm-up: allocator
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        got = {}
        for b in "zx":
            syn = torch.cat([t[f"syndrome_{b}"] for t in trials]).cpu()
            got[b] = bdec.decode(syn.numpy(), b.upper(), batch_size=BATCH)
        api_s = time.time() - t0
        c17 = counts()
        for b in "zx":
            true = torch.cat([t[f"true_{b}"] for t in trials]).cpu().numpy()
            err = (got[b]["logicals"] != true).any(1)
            for name, mine, key in (
                    ("error", err, f"{b}_err"),
                    ("converged", got[b]["converged"], f"{b}_conv"),
                    ("rank_deficient", got[b]["rank_deficient"],
                     f"{b}_rankdef")):
                if not np.array_equal(mine, ref_out[key].cpu().numpy()):
                    fail(f"phase 17: BatchDecoder({variant}) {name} differs "
                         f"from the pooled dispatch's {key} in basis "
                         f"{b.upper()}")
        if c17[bp_key] <= 0 or c17["k2"] <= 0 or c17["g1"] <= 0 \
                or c17["r1"] <= 0 or any(
                    v for k, v in c17.items()
                    if k not in (bp_key, "k2", "g1", "r1")):
            fail(f"phase 17: BatchDecoder({variant}) did not run "
                 f"{bp_key.upper()} and K2 alone: {c17}")
        api[variant] = dict(shots_per_s=RPD * BATCH / api_s, launches=c17)
        print(f"phase 17: BatchDecoder(bp_variant={variant!r}).decode of "
              f"{RPD}x{BATCH} shots a basis (batch_size {BATCH}) equals the "
              f"pooled dispatch shot for shot (error, converged, "
              f"rank_deficient, both bases); {RPD * BATCH / api_s:.1f} "
              f"decoded shots/s (both bases, {api_s:.2f} s); launches "
              f"{bp_key.upper()} {c17[bp_key]} K2 {c17['k2']}", flush=True)
    del trials
    print(f"phase 17: {time.time() - t17:.1f} s", flush=True)

    # ---- phase 18: run_code_capacity ----
    from qldpc_tpu_torch.parallel import code_capacity as ccap
    t18 = time.time()
    Hs, _, Ls, _ = ccap.steane_code()
    reset_counts()
    cap = ccap.run_code_capacity(Hs, 0.005, num_shots=10_000, L=Ls,
                                 device=dev)
    c18 = counts()
    print(f"phase 18: run_code_capacity Steane [[7,1,3]] p=0.005, "
          f"{cap['num_shots']} shots: LER {cap['logical_error_rate']:.5f}, "
          f"converged {cap['converged_rate']:.4f}, "
          f"{cap['shots_per_sec']:.1f} shots/s; launches K2 {c18['k2']}",
          flush=True)
    if not (cap["num_shots"] == 10_000 and cap["logical_error_rate"] < 0.01
            and cap["converged_rate"] > 0.9) or c18["k2"] <= 0 \
            or c18["r1"] <= 0 or any(
                v for k, v in c18.items() if k not in ("k2", "g1", "r1")):
        fail(f"phase 18: implausible code-capacity result {cap} or launches "
             f"{c18}")
    code_cap = dict(steane_shots_per_s=cap["shots_per_sec"],
                    steane_ler=cap["logical_error_rate"])
    for name, H18, L18, B18 in (
            ("Steane", Hs, Ls, 4096),
            (f"{CODE} Hz", code.Hz, code.Lx, BATCH)):
        e18 = torch.rand((B18, H18.shape[1]), generator=torch.Generator(
            device=dev).manual_seed(SEED), device=dev) < 0.05
        cc_dev = ccap.capacity_decoder(H18, 0.05, L18, MAXITER, OSD_ORDER,
                                       device=dev)
        cc_cpu = ccap.capacity_decoder(H18, 0.05, L18, MAXITER, OSD_ORDER,
                                       device="cpu")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        got18 = ccap._code_capacity_round(e18, cc_dev)
        torch.cuda.synchronize()
        round_s = time.time() - t0
        k2_18 = counts()["k2"]
        want18 = ccap._code_capacity_round(e18.cpu(), cc_cpu)
        for key in ("fail", "conv"):
            if not torch.equal(got18[key].cpu(), want18[key]):
                fail(f"phase 18: the {name} code-capacity round's {key} "
                     "differs between the card and the CPU")
        n_conv = int(want18["conv"].sum())
        if k2_18 <= 0:
            fail(f"phase 18: the {name} round did not launch K2")
        code_cap[name] = dict(round_s=round_s, k2=k2_18, conv=n_conv,
                              fail=int(want18["fail"].sum()))
        print(f"phase 18: {name} code-capacity round (p=0.05, B={B18}, "
              f"maxIter {MAXITER}, OSD order {OSD_ORDER}): card equals CPU "
              f"(fail {int(want18['fail'].sum())}, BP converged {n_conv}); "
              f"K2 launches {k2_18}; card round {round_s * 1e3:.1f} ms",
              flush=True)
    if code_cap[f"{CODE} Hz"]["conv"] >= BATCH:
        fail("phase 18: BP converged on every shot of the wide round")
    print(f"phase 18: {time.time() - t18:.1f} s", flush=True)

    # ---- phase 19: bench_cuda.py as a subprocess ----
    import tempfile
    t19 = time.time()
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as tmp:
        bench = subprocess.run(
            [sys.executable, os.path.join(root, "bench_cuda.py"),
             "--seconds", "2", "--windows", "2", "--baseline-cache",
             os.path.join(tmp, "baseline.json")],
            capture_output=True, text=True, timeout=300, cwd=tmp,
            env=dict(os.environ, BENCH_288="0"))
    lines = bench.stdout.strip().splitlines()
    if bench.returncode or len(lines) < 2:
        fail(f"phase 19: bench_cuda.py exited {bench.returncode}: "
             f"{bench.stdout[-2000:]} {bench.stderr[-3000:]}")
    head, full = json.loads(lines[0]), json.loads(lines[-1])
    if (full.get("metric") != "decoded_shots_per_sec_per_chip_[[144,12,12]]"
            or not full.get("value", 0) > 0 or "vs_baseline" not in full
            or "extra" in head or {k: full[k] for k in head} != head
            or "extra" not in full):
        fail(f"phase 19: bench_cuda.py lines do not parse as its contract: "
             f"{lines[0]} ... {lines[-1][:500]}")
    win = full["extra"]["windows_shots_per_sec"]
    stages19 = full["extra"]["stages_[[144,12,12]]"]["stage_ms_per_dispatch"]
    windows19 = ", ".join(f"{r:.1f}" for r in win["all"])
    print(f"phase 19: bench_cuda.py (2 windows of 2 s, no [[288]]): value "
          f"{full['value']} shots/s (windows {windows19}), "
          f"vs_baseline {full['vs_baseline']}; stages (ms a dispatch) "
          + ", ".join(f"{k} {v:.1f}" for k, v in stages19.items())
          + f"; phase 4's run_simulation {res['shots_per_sec']:.1f} shots/s;"
          f" {time.time() - t19:.1f} s", flush=True)

    # ---- phase 20: the CLI and the gallery ----
    t20 = time.time()
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as tmp:
        cli = subprocess.run(
            [sys.executable, "-m", "qldpc_tpu_torch", "--codes",
             CLI_CODE, "--error-rates", str(CLI_P), "--max-iter", "20",
             "--target-logical-errors", str(CLI_ERRORS), "--base-seed",
             str(SEED), "--output-dir", os.path.join(tmp, "out"),
             "--cache-dir", os.path.join(tmp, "cache")],
            capture_output=True, text=True, timeout=300, cwd=root)
        runs = sorted(os.listdir(os.path.join(tmp, "out"))) \
            if os.path.isdir(os.path.join(tmp, "out")) else []
        if cli.returncode or not runs:
            fail(f"phase 20: python -m qldpc_tpu_torch exited "
                 f"{cli.returncode}: {cli.stderr[-3000:]}")
        from qldpc_tpu_torch.utils.results import load_results
        r20 = load_results(os.path.join(tmp, "out", runs[-1], "results.npz")
                           )["results"]["72"][CLI_P]
        ler20, n20 = r20["logical_error_rate"], r20["num_trials"]
        ref20 = CLI_REF_ERRS / CLI_REF_TRIALS
        z20 = (ler20 - ref20) / np.sqrt(ler20 * (1 - ler20) / max(n20, 1)
                                        + ref20 * (1 - ref20)
                                        / CLI_REF_TRIALS)
        print(f"phase 20: python -m qldpc_tpu_torch {CLI_CODE} p={CLI_P} "
              f"maxIter 20: LER {ler20:.5f} ({r20['logical_errors']}/{n20}) "
              f"against the JAX record {ref20:.3f} ({CLI_REF_ERRS}/"
              f"{CLI_REF_TRIALS}, VALIDATION.md:12): z {z20:+.2f}; "
              f"results.npz loads", flush=True)
        if r20["logical_errors"] != CLI_ERRORS or abs(z20) > 3:
            fail(f"phase 20: the CLI's LER {ler20:.5f} is not within 3 "
                 f"sigma of {ref20:.3f}: {r20}")
        from qldpc_tpu_torch.utils import gallery
        if gallery.plt is not None:
            figs = gallery.generate_gallery(os.path.join(tmp, "gallery"),
                                            verbose=False, device=dev)
            if len(figs) != 15 or not all(os.path.getsize(f) > 5000
                                          for f in figs):
                fail(f"phase 20: the gallery wrote {len(figs)} figures")
            done20 = "generate_gallery on the card wrote 15 figures"
        else:
            # no matplotlib on this machine: the gallery's device work
            # (the sampled trials and BP decodes of figures 01c, 06, 07
            # and 10) on the card, its decisions against the CPU's
            c20 = qt.get_code(CLI_CODE)
            circ20 = qt.SyndromeCircuit(c20, num_cycles=4)
            M20 = qt.build_decoding_matrices(circ20, c20.Lx, c20.Lz, CLI_P)
            syn20, _ = gallery._trials(circ20, M20, dev, CLI_P, 5, 8)
            card20 = gallery._bp_z(M20, syn20, 30)
            cpu20 = gallery._bp_z(M20, syn20.cpu(), 30)
            for key in ("hard", "converged"):
                if not torch.equal(card20[key].cpu(), cpu20[key]):
                    fail(f"phase 20: the gallery's BP {key} differs between "
                         "the card and the CPU")
            done20 = ("matplotlib is not installed here, so the gallery "
                      "writes no figure; its sampled trials and BP decodes "
                      f"ran on the card ({int(syn20.sum())} syndrome bits "
                      "in 8 shots) and equal the CPU's decisions")
    print(f"phase 20: {done20}; {time.time() - t20:.1f} s", flush=True)

    # ---- phase 21: the LER validation sweep's entry point ----
    from qldpc_tpu_torch.scripts import validate_ler
    t21 = time.time()
    mode21 = "alvarado-autoregressive"
    all_points = validate_ler.BASELINE_POINTS
    run_saved = validate_ler.run_simulation
    calib_saved = engine._calibrate_basis_sequences
    results21, calib21 = [], []

    def recording_run(*a, **kw):
        out = run_saved(*a, **kw)
        results21.append(out)
        return out

    def timed_calibration(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.time()
        out = calib_saved(*a, **kw)
        torch.cuda.synchronize()
        calib21.append(time.time() - t0)
        return out

    launches_sw = {}
    validate_ler.run_simulation = recording_run
    engine._calibrate_basis_sequences = timed_calibration
    try:
        with tempfile.TemporaryDirectory(
                dir=os.path.join(root, "build")) as tmp:
            for name, p21, variant, target, ref_e, ref_t, src in SWEEP_POINTS:
                # the point's own row of the table, and no other
                validate_ler.BASELINE_POINTS = {mode21: [
                    pt for pt in all_points[mode21] if pt[:2] == (name, p21)]}
                reset_counts()
                rows = validate_ler.main([
                    "--alpha-mode", mode21, "--max-iter", "50",
                    "--target-errors", str(target), "--bp-variant", variant,
                    "--codes", name, "--out",
                    os.path.join(tmp, f"{variant}.json")])
                torch.cuda.synchronize()
                c = counts()
                launches_sw[variant] = c
                res21, row = results21[-1], rows[0]
                ler21, n21 = row["ler"], row["trials"]
                ref21 = ref_e / ref_t
                z21 = (ler21 - ref21) / np.sqrt(
                    ler21 * (1 - ler21) / n21 + ref21 * (1 - ref21) / ref_t)
                bp21 = "k3" if variant == "layered" else "k1"
                print(f"phase 21: validate_ler {name} p={p21} {mode21} "
                      f"{variant} maxIter 50: LER {ler21:.5f} "
                      f"({row['errors']}/{n21}) against the JAX record "
                      f"{ref21:.4f} ({ref_e}/{ref_t}, {src}): z {z21:+.2f};"
                      f" {row['shots_per_sec']} shots/s, calibration "
                      f"{calib21[-1]:.1f} s, point {row['wall_sec']} s; "
                      f"rank-deficient shot-bases "
                      f"{res21['osd_rank_deficient_shots']}; launches "
                      f"{bp21.upper()} {c[bp21]} K2 {c['k2']}", flush=True)
                if row["errors"] != target or abs(z21) > 3:
                    fail(f"phase 21: {name} p={p21} {variant}: LER "
                         f"{ler21:.5f} is not within 3 sigma of {ref21:.4f}"
                         f": {row}")
                if res21["osd_rank_deficient_shots"]:
                    fail(f"phase 21: {name} p={p21}: "
                         f"{res21['osd_rank_deficient_shots']} "
                         "rank-deficient shot-bases")
                if c[bp21] <= 0 or c["k2"] <= 0 or c["r1"] <= 0 or any(
                        v for k, v in c.items()
                        if k not in (bp21, "k2", "g1", "s1", "r1")):
                    fail(f"phase 21: {name} {variant} did not run "
                         f"{bp21.upper()} and K2 alone: {c}")
    finally:
        validate_ler.BASELINE_POINTS = all_points
        validate_ler.run_simulation = run_saved
        engine._calibrate_basis_sequences = calib_saved
    print(f"phase 21: {time.time() - t21:.1f} s", flush=True)

    # ---- phase 22: the asynchronous round ----
    t22 = time.time()
    dec0 = decs[0]  # phase 3's inputs are its Z-basis failed shots
    m0, K0 = dec0.H.shape[0], dec0.K
    deg = (dec0.col_index.colptr[1:] - dec0.col_index.colptr[:-1]).long()
    g1 = {}
    g1_err = 0.0
    empty = torch.zeros(2, dtype=torch.int32, device=dev)

    def g1_case(index, cl, Kx, want, span, where):
        """G1 on ``cl`` (B, K <= Kx) against its plain version ``want`` on
        the live shots; returns the max abs error (0 or fail)."""
        live = None if span is None else torch.tensor(
            span, dtype=torch.int32, device=dev)
        got = osd_cuda.gather_pack(index, cl, Kx, live=live)
        torch.cuda.synchronize()
        lo, hi = (0, len(cl)) if span is None else span
        if got.shape != want.shape or not torch.equal(got[lo:hi],
                                                      want[lo:hi]):
            fail(f"phase 22: G1 differs from its plain version ({where}, "
                 f"shots [{lo}, {hi}))")
        return float((got[lo:hi].long() - want[lo:hi].long()).abs().max()) \
            if hi > lo else 0.0

    def g1_writes_nothing(index, cl, Kx, where):
        """G1 gated to nothing leaves its output as it was."""
        launch, out = osd_cuda.prepare_gather_pack(index, cl, Kx, empty)
        out.fill_(-1)
        launch()
        torch.cuda.synchronize()
        if not bool((out == -1).all()):
            fail(f"phase 22: G1 gated to nothing wrote ({where})")

    def g1_alone(index, cl, Kx, live=None) -> float:
        """G1 alone (a prepared launch, CUDA graph)."""
        return handoff_timing.alone_ms(
            osd_cuda.prepare_gather_pack(index, cl, Kx, live)[0], 20, dev)

    for width, (cl, Kx, want_w) in g1_widths.items():
        want = osd_cuda.gather_pack_plain(dec0.col_index, cl, Kx)
        S0 = want.shape[2]
        if not torch.equal(osd_cuda.columns_to_words(want, m0), want_w):
            fail(f"phase 22: G1's plain version is not _gather_pack's "
                 f"words transposed ({CODE} {width})")
        for span in (None, (37, 300)):
            g1_err = max(g1_err, g1_case(dec0.col_index, cl, Kx, want, span,
                                         f"{CODE} {width}"))
        B0, W0 = len(cl), Kx // 32
        ms = cuda_ms(lambda: osd_cuda.gather_pack(dec0.col_index, cl, Kx),
                     20)
        plain_ms = cuda_ms(lambda: osd_cuda.gather_pack_plain(
            dec0.col_index, cl, Kx), 3)
        words_plain_ms = cuda_ms(lambda: osd._gather_pack(
            dec0.col_index.HT, cl, Kx, words_major=True), 3)
        alone = g1_alone(dec0.col_index, cl, Kx)
        nb = handoff_timing.g1_bytes(dec0.col_index, cl, Kx, S0)
        kb, bb = bound(nb, int(deg[cl].sum()))
        g1[width] = dict(ms=ms, plain_ms=plain_ms,
                         words_plain_ms=words_plain_ms, kernel_ms=alone,
                         bound_ms=kb, bound_by=bb, bytes=nb, words=W0,
                         shots=B0)
        print(f"phase 22: G1 {width} ({W0} words by {m0} rows, {B0} shots):"
              f" equals its plain version on the whole batch and on shots "
              f"[37, 300); alone {alone:.4f} ms (bound {kb:.4f} ms by {bb}:"
              f" {nb} bytes, S = {S0}); through the wrapper {ms:.4f} ms; "
              f"plain {plain_ms:.3f} ms (_gather_pack's words alone "
              f"{words_plain_ms:.3f} ms)", flush=True)
    g1_writes_nothing(dec0.col_index, *g1_widths["full"][:2], CODE)
    g1_empty = g1_alone(dec0.col_index, *g1_widths["full"][:2], empty)
    # [[288,12,18]]: the basis rerun's width (prefix + column basis), B=37
    want288 = osd_cuda.gather_pack_plain(index288, cols288E, Kx288)
    for span in (None, (5, 30)):
        g1_err = max(g1_err, g1_case(index288, cols288E, Kx288, want288,
                                     span, f"{CODE_288} basis rerun"))
    g1_writes_nothing(index288, cols288E, Kx288, CODE_288)
    g1_288 = g1_alone(index288, cols288E, Kx288)
    kb288, _ = bound(handoff_timing.g1_bytes(index288, cols288E, Kx288,
                                             want288.shape[2]), 0)
    print(f"phase 22: G1 at {CODE_288} basis rerun ({Kx288 // 32} words by "
          f"{m288} rows, B={BATCH_288}): equals its plain version on the "
          f"whole batch and on shots [5, 30); alone {g1_288:.4f} ms (bound "
          f"{kb288:.4f}); gated to nothing (writes nothing) at {CODE}'s full "
          f"width {g1_empty:.4f} ms", flush=True)
    del index288, cols288E, want288

    # the host's time a call: unsynchronised wrapper calls gated to nothing
    # (the host work of a call is the same whatever the gate), G1 and K2
    # as the OSD calls them
    cl1, Kx1, _ = g1_widths["stage1"]
    hc1 = g1_src["stage1"]()
    host_calls = {
        "G1": lambda: osd_cuda.gather_pack(dec0.col_index, cl1, Kx1,
                                           live=empty),
        "K2": lambda: osd_cuda.eliminate_blocks_v1(
            hc1, residual, 256, m0, rank=dec0.rank, live=empty,
            want_matrix=False)}
    host_ms = {name: handoff_timing.host_ms(call, 1000)
               for name, call in host_calls.items()}
    print("phase 22: host ms a call (1000 unsynchronised wrapper calls, "
          "gated to nothing): " + ", ".join(f"{k} {v:.4f}"
                                            for k, v in host_ms.items()),
          flush=True)

    # the eliminators gated to a range against their ungated launch on the
    # live shots (K5's pairs split at both ends), and gated to nothing
    Hp_pre, K_pre = widths["prefix"]
    span_t = torch.tensor((37, 300), dtype=torch.int32, device=dev)
    gate_ms = {}
    for key, kname, fn_k in (("k2", "K2", osd_cuda.eliminate_blocks_v1),
                             ("k4", "K4", osd_cuda.eliminate_blocks_fused),
                             ("k5", "K5", osd_cuda.eliminate_blocks_pair)):
        full = fn_k(g1_src["prefix"](), residual, K_pre, m0, rank=dec0.rank,
                    return_steps=True)
        gated = fn_k(g1_src["prefix"](), residual, K_pre, m0, rank=dec0.rank,
                     return_steps=True, live=span_t)
        torch.cuda.synchronize()
        for nm, x, y in zip(names, gated, full):
            if not torch.equal(x[37:300], y[37:300]):
                fail(f"phase 22: {kname} gated to [37, 300) differs from "
                     f"its ungated launch in {nm}")
        if (gated[4][:37] != -1).any() or (gated[5][300:] != 0).any():
            fail(f"phase 22: {kname}'s gated-off shots recorded a pivot or "
                 f"a step")
        gate_ms[key] = {}
        for width in ("prefix", "full"):
            launch, _ = osd_cuda.prepare_elim_launch(
                g1_src[width](), residual, widths[width][1], m0,
                rank=dec0.rank, kernel=kname, live=empty)
            gate_ms[key][width] = cuda_ms(launch, 20)  # nothing consumed
        ungated = (k2 if key == "k2" else k45[key])["prefix"]["ms"]
        print(f"phase 22: {kname} gated to shots [37, 300) of {len(Hp_pre)}"
              f" equals its ungated launch there (prefix, {Hp_pre.shape[1]} "
              f"words); gated to nothing: prefix "
              f"{gate_ms[key]['prefix']:.4f} ms, full "
              f"{gate_ms[key]['full']:.4f} ms (ungated prefix "
              f"{ungated:.3f} ms)", flush=True)

    # one steady pooled dispatch (phase 4's round function and randoms) with
    # every host read an error, then one drawing from a generator
    sharded = mesh.shard_rounds(fn, mesh.shot_mesh())
    gen22 = torch.Generator(device=dev).manual_seed(SEED)
    sharded([gen22])  # warm-up of the generator's path
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        out22 = sharded([None], randoms=[randoms])
        out22g = sharded([gen22])
        issue22 = (time.perf_counter() - t0) / 2
    except RuntimeError as e:
        fail(f"phase 22: a steady dispatch read back from the device: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for key, v in out_k.items():
        if not torch.equal(v, out22[key]):
            fail(f"phase 22: flag {key} of the dispatch under the sync "
                 "check differs from phase 4's")
    c22 = mesh.read_counts([out22, out22g])
    if c22[0]["any_err_count"] != int(out_k["any_err"].sum()) or any(
            c["osd_overflow_count"] for c in c22):
        fail(f"phase 22: implausible counts {c22}")
    print(f"phase 22: two steady pooled dispatches ({RPD}x{BATCH} shots) "
          f"under set_sync_debug_mode('error'): no host read; flags equal "
          f"phase 4's shot for shot; host issue {issue22 * 1e3:.1f} ms a "
          f"dispatch; counts read one round late {c22[0]}", flush=True)

    # the same steady dispatch with the program's telemetry on: its spans
    # and held counters add no host read and no launch and change no flag;
    # then one under the profiler, where each eliminator launch enters its
    # range (entered only while a profiler runs)
    from qldpc_tpu_torch.utils import telemetry
    from torch.profiler import ProfilerActivity, profile
    reset_counts()
    telemetry.reset()
    telemetry.enable()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        with telemetry.dispatch(0):
            out22t = sharded([None], randoms=[randoms])
        issue22t = time.perf_counter() - t0
    except RuntimeError as e:
        fail(f"phase 22: a steady dispatch with telemetry on read back from "
             f"the device: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
        telemetry.disable()
    torch.cuda.synchronize()
    launches22t = counts()
    exp22 = telemetry.export()
    telemetry.reset()
    for key, v in out_k.items():
        if not torch.equal(v, out22t[key]):
            fail(f"phase 22: flag {key} with telemetry on differs from "
                 "phase 4's")
    if launches22t != per_dispatch:
        fail(f"phase 22: launches with telemetry on {launches22t} against "
             f"{per_dispatch} off")
    sp22 = exp22["spans"]
    n22 = {}
    for sp in sp22:
        n22[sp["name"]] = n22.get(sp["name"], 0) + 1

    def total22(name, key):
        return sum(sp["counters"].get(key, 0) for sp in sp22
                   if sp["name"] == name)

    elim22 = [sp["counters"]["elim.live"] for sp in sp22
              if sp["name"] == "elim"]
    fails22 = [int((~out_k[f"{b}_conv"]).sum()) for b in "zx"]
    if (n22.get("round") != 1 or n22.get("elim") != per_dispatch["k2"]
            or n22.get("bp") != 2 * RPD
            or total22("bp", "bp.shots") != 2 * RPD * BATCH
            or [sp["counters"]["osd.failed"] for sp in sp22
                if sp["name"] == "osd"] != fails22
            or any(sp["dispatch"] != 0 for sp in sp22)):
        fail(f"phase 22: implausible spans {n22}")
    chunks22 = total22("osd", "osd.chunks_issued")
    live22 = sum(sp["counters"]["osd.live"] > 0 for sp in sp22
                 if sp["name"] == "osd.chunk")
    print(f"phase 22: the dispatch with telemetry on: no host read, flags "
          f"and launches ({launches22t['k1']} K1, {launches22t['k2']} K2, "
          f"{launches22t['g1']} G1) as off; host issue "
          f"{issue22t * 1e3:.1f} ms; {len(sp22)} spans {n22}; BP "
          f"{total22('bp', 'bp.shot_iterations') / (2 * RPD * BATCH):.2f} "
          f"iterations a shot-basis; OSD chunks live {live22} of "
          f"{chunks22}; eliminator launches empty "
          f"{sum(v == 0 for v in elim22)} of {len(elim22)}, column steps "
          f"{total22('elim', 'elim.steps')}", flush=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof22:
        sharded([None], randoms=[randoms])
        torch.cuda.synchronize()
    ranges22 = sum(e.count for e in prof22.key_averages()
                   if e.key.startswith(osd_cuda.K2_RANGE))
    if ranges22 != per_dispatch["k2"]:
        fail(f"phase 22: {ranges22} eliminator ranges under the profiler "
             f"against {per_dispatch['k2']} launches")
    print(f"phase 22: under the profiler {ranges22} '{osd_cuda.K2_RANGE}' "
          f"ranges, one a launch", flush=True)

    # run_simulation at the bench configuration, one and two dispatches in
    # flight, one seed
    runs22 = {}
    for depth in (1, 2):
        reset_counts()
        r = qt.run_simulation(
            code.Hx, code.Hz, code.Lx, code.Lz, P, num_cycles=CYCLES,
            maxIter=MAXITER, osd_order=OSD_ORDER, max_trials=MAX_TRIALS,
            batch_size=BATCH, rounds_per_dispatch=RPD, base_seed=SEED,
            precomputed_matrices=M, verbose=False, pipeline_depth=depth,
            **bb_params)
        torch.cuda.synchronize()
        runs22[depth] = dict(r, launches=counts())
        print(f"phase 22: run_simulation pipeline_depth={depth}: "
              f"{r['num_trials']} trials, {r['logical_errors']} errors "
              f"(z {r['z_logical_error_rate']:.5f}, x "
              f"{r['x_logical_error_rate']:.5f}), "
              f"{r['osd_rank_deficient_shots']} rank-deficient, LER "
              f"{r['logical_error_rate']:.5f}; {r['shots_per_sec']:.1f} "
              f"shots/s; launches K1 {runs22[depth]['launches']['k1']} K2 "
              f"{runs22[depth]['launches']['k2']} G1 "
              f"{runs22[depth]['launches']['g1']}", flush=True)
    tally = ("num_trials", "logical_errors", "z_logical_error_rate",
             "x_logical_error_rate", "osd_rank_deficient_shots")
    if any(runs22[1][k] != runs22[2][k] or runs22[1][k] != res[k]
           for k in tally):
        got = [{k: r[k] for k in tally} for r in (runs22[1], runs22[2], res)]
        fail(f"phase 22: the tallies differ between depth 1, depth 2 and "
             f"phase 4: {got}")
    print(f"phase 22: {time.time() - t22:.1f} s", flush=True)

    # ---- phase 23: the bench sweeps and the OSD studies ----
    # the eleven entry points of qldpc_tpu_torch/scripts that port the JAX
    # package's bench sweeps and OSD studies, each at full width for a
    # short time (one configuration a sweep, 1-second windows), each with
    # the launches it made; the OSD studies' statistics on the card against
    # the plain versions on the same posteriors; osd_microbench under each
    # eliminator; and every pooled@cN against the default chunk on one
    # dispatch's randoms
    import io

    from qldpc_tpu_torch.scripts import (
        bench288_sweep, bp_lift_bench, eliminate, maxiter_sweep,
        multicode_bench, osd144_stage_ab, osd288_ab, osd288_probe,
        osd_margin_probe, osd_microbench, pooled_ab, residual_order,
        scaling_bench)
    t23 = time.time()
    cpu = torch.device("cpu")
    for name, M_c in zip(MC_CODES, mc_M):  # multicode_bench's cache
        c = qt.get_code(name)
        save_matrices(str(bp_breakdown.CACHE_DIR), compute_cache_key(
            c.Hx, c.Hz, c.Lx, c.Lz, MC_CYCLES, P), M_c)
    c23 = {}

    def entry(label, main_fn, argv, want, phase=23):
        """``main_fn(argv)`` on the card with its output captured; fails
        unless it printed the card's line first and a result line last and
        launched the kernels ``want`` (keys of counts()) and no other
        decoder kernel (S1 runs wherever the entry point samples; R1 forms
        the residual wherever G1 packs an OSD input, so ``want`` with G1
        wants R1 too)."""
        want = set(want) | ({"r1"} if "g1" in want else set())
        reset_counts()
        buf = io.StringIO()
        t0 = time.time()
        try:
            with contextlib.redirect_stdout(buf):
                out = main_fn(argv)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - the phase fails either way
            fail(f"phase {phase}: {label} raised {type(e).__name__}: {e}")
        c23[label] = c = counts()
        lines = buf.getvalue().strip().splitlines()
        if len(lines) < 2 or not lines[0].startswith("card: "):
            fail(f"phase {phase}: {label} printed no card line or no "
                 f"result: {lines[:2]}")
        if {k for k, v in c.items() if v} - {"s1"} != set(want):
            fail(f"phase {phase}: {label} launched {c}, not {sorted(want)} "
                 f"alone")
        print(f"phase {phase}: {label} ({time.time() - t0:.1f} s): launches "
              + ", ".join(f"{k.upper()} {c[k]}"
                          for k in sorted(set(want) | {"s1"}))
              + f"; {lines[-1][:400]}", flush=True)
        return out, lines

    def quiet(fn, *a):
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(*a)

    mc23, lines = entry("multicode_bench", multicode_bench.main,
                        [str(BATCH), str(RPD), "1", "--windows", "1"],
                        {"k1", "k2", "g1"})
    if json.loads(lines[-1])["shots_per_sec_per_code"] <= 0:
        fail(f"phase 23: multicode_bench measured nothing: {mc23}")
    ab23, lines = entry("pooled_ab", pooled_ab.main, [
        "--seconds", "1", "--reps", "1", "--windows", "1", "--configs",
        "scanned", "pooled", "pooled+layered", "pooled@c512"],
        {"k1", "k3", "k2", "g1"})
    if json.loads(lines[-1])["best_shots_per_sec"] != \
            ab23["best_shots_per_sec"]:
        fail("phase 23: pooled_ab's result line differs from its result")
    mi23, lines = entry("maxiter_sweep", maxiter_sweep.main,
                        ["50", "--pooled", "--seconds", "1"],
                        {"k1", "k2", "g1"})
    if "best-of-2 per config:" not in lines:
        fail("phase 23: maxiter_sweep printed no best-of-2 table")
    b288, lines = entry("bench288_sweep", bench288_sweep.main, [
        "--seconds", "1", "--windows", "1", "--configs", "256,200,2"],
        {"k1", "k2", "g1"})
    if [r["shots_per_sec"] > 0 for r in json.loads(lines[-1])["results"]
            .values()] != [True]:
        fail(f"phase 23: bench288_sweep measured nothing: {b288}")
    sc23, _ = entry("scaling_bench", scaling_bench.main,
                    ["--devices", "1", "2", "--reps", "2"],
                    {"k1", "k2", "g1"})
    saved = (osd144_stage_ab.STAGE1, osd288_ab.MAX_ITERS, osd288_ab.STAGE1)
    osd144_stage_ab.STAGE1, osd288_ab.MAX_ITERS = (0, 256), (200,)
    osd288_ab.STAGE1 = (0, 768)
    try:
        s144, _ = entry("osd144_stage_ab", osd144_stage_ab.main,
                        [str(BATCH), str(MAXITER)], {"k1", "k2", "g1"})
        s288, _ = entry("osd288_ab", osd288_ab.main, ["256"],
                        {"k1", "k2", "g1"})
    finally:
        osd144_stage_ab.STAGE1, osd288_ab.MAX_ITERS, osd288_ab.STAGE1 = saved
    for label, res in (("osd144_stage_ab", s144), ("osd288_ab", s288[200])):
        if len({v[:3] for v in res.values()}) != 1:
            fail(f"phase 23: {label}'s sums depend on the stage-1 width: "
                 f"{res}")
    pr23, _ = entry("osd288_probe", osd288_probe.main, ["256", "50"],
                    {"k1", "k3", "k2", "g1"})
    mg144, _ = entry("osd_margin_probe [[144]]", osd_margin_probe.main,
                     [CODE, str(P), "512", "1"], {"k2", "g1"})
    mg288, _ = entry("osd_margin_probe [[288]]", osd_margin_probe.main,
                     [CODE_288, "0.005", "256", "1"], {"k2", "g1"})
    micro = {}
    saved = osd_cuda._KERNEL_VERSION
    try:
        for version, key in ((1, "k2"), (2, "k4"), (3, "k5")):
            osd_cuda._KERNEL_VERSION = version
            micro[key], _ = entry(
                f"osd_microbench QLDPC_OSD_KERNEL={version}",
                osd_microbench.main, [CODE, str(P), "512"], {key, "g1"})
    finally:
        osd_cuda._KERNEL_VERSION = saved
    valid_keys = [k for k in micro["k2"] if k.endswith("_valid")]
    if any(micro[v][k] != micro["k2"][k] for v in micro for k in valid_keys):
        fail(f"phase 23: osd_microbench's valid counts differ by "
             f"eliminator: {micro}")
    # 128 shots: the PyTorch-op decoders take 2-7 ms an iteration at 512
    bl23, _ = entry("bp_lift_bench", bp_lift_bench.main,
                    [CODE, str(P), "128", "20"], {"k1"})

    # the studies' statistics: the card against the plain versions on the
    # same BP-failed posteriors (K1, maxIter 50): [[144,12,12]] 16 shots,
    # [[288,12,18]] 4 shots (p=0.005, its matrices from the cache)
    def failed_shots(dec_c, n_locs_c, p_c, B_c, keep):
        g = torch.Generator(device=dev).manual_seed(SEED + 23)
        syn_c = trial_batch(g, p_c, dec_c.maps, dec_c.maps, n_locs_c,
                            B_c)["syndrome_z"]
        r = bp_lift_cuda.decode_batch_lift_cuda(dec_c.lifted, syn_c,
                                                dec_c.prior,
                                                dec_c.alpha_seq, MAXITER)
        f = torch.nonzero(~r["converged"])[:keep, 0]
        return syn_c[f], r["values"][f], r["hard"][f]

    def studies(dec_g, dec_c, shots, stage1, order, where):
        """Each study's statistic on the card and on the CPU (the stage
        sums at OSD order ``order``); fails unless they are equal."""
        got = []  # card, CPU
        for d, device in ((dec_g, dev), (dec_c, cpu)):
            syn_d, vals, hard = (t.to(device) for t in shots)
            residual, ranked = residual_order(d, syn_d, vals, hard)
            bp_d = dict(values=vals, hard=hard)
            full = torch.cat([ranked[:, :d.K], d.basis_cols[None].expand(
                len(ranked), d.basis_cols.numel())], 1)
            s_red, used, cf, _ = eliminate(d, full, residual,
                                           d.K + d.basis_cols.numel(), True,
                                           0, device)
            probe = quiet(osd288_probe.probe, d, syn_d, vals, hard, stage1,
                          0, device)
            got.append(dict(
                stage=quiet(osd144_stage_ab.run_widths, d, syn_d, bp_d,
                            (0,) + stage1, order,
                            d.num_test if order else 0, 0, device),
                depth=probe["depth"].tolist(),
                unsat=(probe["unsat"] != 0).tolist(),
                prefix=probe["prefix"],
                valid={K: v.tolist() for K, v in
                       osd_margin_probe.valid_within(
                           d, ranked, residual,
                           osd_margin_probe.K_GRID, device).items()},
                basis_rerun=[s_red.tolist(), used.tolist(), cf.tolist()]))
        for key in got[0]:
            a, b = got[0][key], got[1][key]
            if key == "stage":
                a = {s: v[:3] for s, v in a.items()}
                b = {s: v[:3] for s, v in b.items()}
            if a != b:
                fail(f"phase 23: {where} {key} differs between the card "
                     f"and the plain versions: {a} vs {b}"[:2000])
        return got[0]

    dec_cpu = engine._make_basis(circ, M, "Z", seq, osd_order=OSD_ORDER,
                                 device=cpu)
    st144 = studies(decs[0], dec_cpu,
                    failed_shots(decs[0], n_locs, P, BATCH, 16), (256,),
                    OSD_ORDER, CODE)
    from qldpc_tpu_torch.scripts.bp_breakdown import cached_matrices
    code288 = qt.get_code(CODE_288)
    circ288c, M288c = cached_matrices(code288, CYCLES_288, 0.005)
    seq50 = alpha_schedule("dynamical", MAXITER)
    d288 = [engine._make_basis(circ288c, M288c, "Z", seq50, device=d)
            for d in (dev, cpu)]
    st288 = studies(*d288, failed_shots(d288[0], circ288c.num_error_locs,
                                        0.005, 64, 4), (768,), 0,
                    CODE_288)
    print(f"phase 23: the studies' statistics equal the plain versions' on "
          f"the same posteriors: {CODE} 16 failed shots (order 2, stage-1 "
          f"widths 0 and 256: delta-sum, valid, rank-deficient "
          f"{st144['stage'][0][:3]}"
          f"; exit depths max {max(st144['depth'])}; stage 1 leaves "
          f"{st144['prefix'].get(256)} uncovered; valid within K "
          + str({K: sum(v) for K, v in st144["valid"].items()})
          + f"; the basis rerun's outputs), {CODE_288} 4 failed shots "
          f"(stage-1 width 768 leaves {st288['prefix'].get(768)} uncovered, "
          f"exit depths {st288['depth']}, the basis rerun's outputs)",
          flush=True)

    # pooled@cN: every chunk (c512 is pool/8) gives the default chunk's
    # flags (the whole pool at this shape) on one dispatch's draws
    cfgs = ["pooled"] + [f"pooled@c{n}" for n in (512, 1024, 2048,
                                                   RPD * BATCH)]
    fns23 = pooled_ab.make_config_fns(cfgs, *decs, n_locs, P, BATCH, RPD,
                                      MAXITER, OSD_ORDER)
    g23 = torch.Generator(device=dev).manual_seed(SEED + 23)
    draws23 = [sample_gate_randoms(g23, BATCH, n_locs, P)
               for _ in range(RPD)]
    ref23 = fns23["pooled"](None, randoms=draws23)
    for cfg in cfgs[1:]:
        got23 = fns23[cfg](None, randoms=draws23)
        bad = [k for k in ref23 if not torch.equal(got23[k], ref23[k])]
        if bad:
            fail(f"phase 23: {cfg} flags {bad} differ from the default "
                 f"chunk's")
    print(f"phase 23: pooled@c512/1024/2048/4096 flags equal the default "
          f"chunk's on one dispatch ({int(ref23['any_err'].sum())} errors "
          f"in {RPD * BATCH}); "
          + pooled_ab.chunk_plan("pooled", decs, RPD * BATCH, dev,
                                 OSD_ORDER), flush=True)
    print(f"phase 23: {time.time() - t23:.1f} s", flush=True)

    # ---- phase 24: the oracle, the round and OSD breakdowns, the BP
    # micro-benchmarks ----
    # ler_oracle's decode of the committed reference-sampled [[90,8,10]]
    # trials (maxIter 20 and 50) against the JAX package's flags, the first
    # 64 trials against the plain path; profile_round --cumulative at the
    # bench configuration; osd_batch's prefixes (osd_microbench) on the card
    # against the plain versions; osd_post_micro; bp_microbench; and
    # bp_lift_bench --layered at [[288,12,18]], each entry point's kernels
    # against their plain versions on its own inputs
    from qldpc_tpu_torch import profile_round
    from qldpc_tpu_torch.scripts import (bp_microbench, build, ler_oracle,
                                         osd_post_micro)
    t24 = time.time()

    def same(a, b, where):
        """Fails unless ``a`` (the card's tensors) equals ``b``."""
        a = a if isinstance(a, (tuple, list)) else (a,)
        b = b if isinstance(b, (tuple, list)) else (b,)
        if len(a) != len(b) or not all(
                torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b)):
            fail(f"phase 24: {where} differs between the card and the "
                 f"plain versions")

    orc, _ = entry("ler_oracle [[90,8,10]]", ler_oracle.main, [
        "ourdecode", "--code", "[[90, 8, 10]]", "--cycles", "10", "--p",
        "0.004", "--max-iter", "20", "50"], {"k1", "k2", "g1"}, phase=24)
    code90 = ler_oracle.load_code("[[90, 8, 10]]")
    circ90, M90 = cached_matrices(code90, 10, 0.004)
    data90 = np.load(ler_oracle.data_path("[[90, 8, 10]]", 10, 0.004))
    oracle = {}
    for r in orc:
        x, line, mi = r["extra"], r["line"], r["line"]["max_iter"]
        plain90 = ler_oracle.decode_file(circ90, M90, data90, mi, OSD_ORDER,
                                         cpu, first=64)
        for b in "ZX":
            for key in ("err", "conv", "rank_deficient"):
                if not np.array_equal(r["flags"][b][key][:64],
                                      plain90[b][key]):
                    fail(f"phase 24: ler_oracle maxIter {mi} basis {b} "
                         f"{key} differs from the plain path on the first "
                         f"64 trials")
        if abs(x["z"]) > 3:
            fail(f"phase 24: ler_oracle maxIter {mi} LER {line['ler']:.5f} "
                 f"is {x['z']:+.2f} sigma from the record "
                 f"{x['record_ler']:.5f}")
        oracle[mi] = dict(ler=line["ler"], errors=line["errors"],
                          record_ler=x["record_ler"], z=x["z"],
                          disagree=dict(Z=x["z_disagree"],
                                        X=x["x_disagree"]),
                          overflow=x["overflow_trials"],
                          seconds=x["seconds"], launches=x["launches"])
        print(f"phase 24: ler_oracle [[90,8,10]] maxIter {mi}: LER "
              f"{line['ler']:.5f} ({line['errors']}/{line['n']}) against the "
              f"record {x['record_ler']:.5f} ({x['record_errors']}), z "
              f"{x['z']:+.2f}; trials disagreeing Z {x['z_disagree']}, X "
              f"{x['x_disagree']}; reprocess replayed for "
              f"{x['overflow_trials']} trials; K1 {x['launches']['K1']}, G1 "
              f"{x['launches']['G1']}, K2 {x['launches']['eliminator']} "
              f"launches; {x['seconds']:.1f} s; the first 64 trials equal the "
              f"plain path's", flush=True)

    cum, _ = entry("profile_round --cumulative", profile_round.main, [
        "--cumulative", CODE, str(P), str(BATCH), "2", "--max-iter",
        str(MAXITER), "--reps", "5"], {"k1", "k2", "g1"}, phase=24)
    g24 = torch.Generator(device=dev).manual_seed(SEED + 24)
    e24, p24, c24 = sample_gate_randoms(g24, 256, n_locs, P)
    syn24 = trial_syndromes(e24, p24, c24, *maps)["syndrome_z"]
    bp24 = engine._bp_one_basis(syn24, decs[0], MAXITER)
    plain24 = bp_lift_cuda.decode_batch_lift_plain(
        decs[0].lifted, syn24, decs[0].prior, decs[0].alpha_seq, MAXITER)
    same([bp24[k] for k in ("hard", "converged", "iterations")],
         [plain24[k] for k in ("hard", "converged", "iterations")],
         "the cumulative round's BP (K1)")
    osd_in = (syn24, bp24["values"], bp24["hard"], bp24["converged"])
    same(engine._osd_fallback(*osd_in, decs[0], OSD_ORDER, 128),
         engine._osd_fallback(*(t.cpu() for t in osd_in), dec_cpu,
                              OSD_ORDER, 128),
         "the cumulative round's OSD chunks (G1, K2)")
    print(f"phase 24: cumulative round ({CODE}, B={BATCH}, maxIter "
          f"{MAXITER}, 2 in flight) ms: "
          + ", ".join(f"{k} {v:.2f}" for k, v in cum["variant_ms"].items())
          + "; stage deltas " + ", ".join(f"{k} {v:.2f}" for k, v in
                                           cum["delta_ms"].items())
          + f"; its BP and OSD chunks equal the plain versions on 256 shots",
          flush=True)

    shots24 = failed_shots(decs[0], n_locs, P, BATCH, 16)
    for stop in osd.PREFIXES + (None,):
        outs = []
        for d, device in ((decs[0], dev), (dec_cpu, cpu)):
            s_, v_, h_ = (t.to(device) for t in shots24)
            o = osd.osd_batch(d.H, d.HT, s_, v_, h_, K=d.K, order=OSD_ORDER,
                              num_test=d.num_test, rank=d.rank,
                              basis_cols=d.basis_cols,
                              logical_pack=d.logical_pack,
                              return_solution=False, col_index=d.col_index,
                              stop_after=stop)
            outs.append(o if stop else [o[k] for k in (
                "logical_delta_packed", "valid", "rank_deficient",
                "reprocess_overflow")])
        same(*outs, f"osd_batch through {stop or 'readout'} (16 failed "
                    f"shots)")
    pre = micro["k2"]["prefix_ms"]
    print(f"phase 24: osd_batch's prefixes equal the plain versions' on 16 "
          f"failed {CODE} shots; osd_microbench (K2, B=512) prefix ms "
          f"(delta): " + ", ".join(f"{k} {v[0]:.2f} ({v[1]:+.2f})"
                                   for k, v in pre.items()), flush=True)

    post, _ = entry("osd_post_micro", osd_post_micro.main, [], set(),
                    phase=24)
    # the same ops on the card and the CPU, each row's pivot columns
    # distinct (as an elimination gives them), so that the scatters have
    # one writer a slot
    small = [osd_post_micro.inputs(64, 100, 900, 256, 100, d)
             for d in (dev, cpu)]
    distinct = torch.stack([torch.randperm(
        small[1]["KT"], generator=torch.Generator().manual_seed(b))[
        :small[1]["M"]] for b in range(64)]).to(torch.int32)
    for x in small:
        x["colofrow"] = distinct.to(x["s_red"].device)
    for (name, fn_g), (_, fn_c) in zip(*(osd_post_micro.ops(x)
                                          for x in small)):
        same(fn_g(), fn_c(), f"osd_post_micro's {name}")
    print("phase 24: osd_post_micro's ops (B=512, m=1008, n=8785, K=1280, "
          "R=930) host ms less the no-op's, device ms: " + "; ".join(
              f"{k} {v['minus_floor_ms']:.3f}, {v['device_ms']:.3f}"
              for k, v in post.items())
          + "; the card equals the CPU on every op at a small shape",
          flush=True)

    # 128 shots and 10 iterations: the roll decoder, host-bound, takes
    # 8-18 ms an iteration at any batch
    mb, _ = entry("bp_microbench", bp_microbench.main,
                  [CODE, str(P), "128", "10"], {"k1"}, phase=24)
    seq20 = alpha_schedule("dynamical", 20)
    seq20_t = torch.as_tensor(seq20, device=dev)
    rng24 = np.random.default_rng(0)
    Hz = (np.asarray(M["HdecZ"]) != 0).astype(np.uint8)
    e_mb = (rng24.random((64, Hz.shape[1])) < M["channel_probsZ"])
    syn_mb = torch.as_tensor((e_mb.astype(np.int64) @ Hz.T) % 2,
                             dtype=torch.int8, device=dev)
    k1_mb = (decs[0].lifted, syn_mb, decs[0].prior, seq20_t, 20)
    same(bp_lift_cuda.decode_batch_lift_cuda(*k1_mb)["hard"],
         bp_lift_cuda.decode_batch_lift_plain(*k1_mb)["hard"],
         "bp_microbench's K1")
    same(bp_microbench.csr_loop(decs[0].graph, syn_mb, decs[0].prior,
                                seq20_t, 20, check=True),
         bp_microbench.csr_loop(dec_cpu.graph, syn_mb.cpu(), dec_cpu.prior,
                                seq20_t.cpu(), 20, check=True),
         "bp_microbench's padded-CSR loop")
    print("phase 24: bp_microbench an iteration (ms): " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in mb["split"].items())
        + "; K1 and the padded-CSR loop equal the plain versions on 64 shots",
        flush=True)

    lay, _ = entry("bp_lift_bench --layered", bp_lift_bench.main,
                   ["--layered"], {"k1", "k3", "k2", "g1"}, phase=24)
    circ_l, _M_l, (d_l,) = build(CODE_288, 0.005, 20, OSD_ORDER, dev,
                                 which="Z")
    g_l = torch.Generator(device=dev).manual_seed(0)
    syn_l = trial_batch(g_l, 0.005, d_l.maps, d_l.maps,
                        circ_l.num_error_locs, 64)["syndrome_z"]
    args_l = (d_l.lifted, syn_l, d_l.prior, d_l.alpha_seq, 20)
    for key, fn_k, plain in (
            ("K1", bp_lift_cuda.decode_batch_lift_cuda,
             bp_lift_cuda.decode_batch_lift_plain),
            ("K3", bp_lift_layered_cuda.decode_batch_lift_layered_cuda,
             bp_lift_layered_cuda.decode_batch_lift_layered_plain)):
        a, b = fn_k(*args_l), plain(*args_l)
        same([a[k] for k in ("hard", "converged", "iterations", "values")],
             [b[k] for k in ("hard", "converged", "iterations", "values")],
             f"bp_lift_bench --layered's {key} at {CODE_288}")
    print(f"phase 24: bp_lift_bench --layered ({CODE_288}, B=64, maxIter "
          f"20): " + "; ".join(
              f"{k} {v['ms']:.2f} ms ({v['ms_per_iter']:.4f} a sweep), "
              f"converged {v['converged']}, pays {v.get('pays_ms', 0):.2f} "
              f"saves {v.get('saves_ms', 0):.2f} ms"
              for k, v in lay.items() if isinstance(v, dict))
          + f"; OSD {lay['osd_ms']:.2f} ms; K1 and K3 equal their plain "
          f"versions there", flush=True)
    print(f"phase 24: {time.time() - t24:.1f} s", flush=True)

    # ---- phase 25: the eliminators' block shape ----
    # (a) K2, K4 and K5 at block_shots 1, 2, 4 and 8 (K5 also 16) and at
    # tail budgets of one team and below one team, on phase 3's inputs
    # ([[144]] stage 1, prefix and full width; [[288]]'s basis rerun): every
    # output equal to the plain version's and the default plan's, and the
    # shots a block elim_launch_info reports equal to make_plan's clamps;
    # (b) every eliminator launch of phase 4's pooled dispatch (under each
    # eliminator) on make_plan's old rule, and pick_block_shots against the
    # library at those shapes; (c) the four entry points that set the block
    # shape or were left out, at full width, each for one short pass; (d)
    # the grid decoder on the card against the padded-CSR decoder there
    from qldpc_tpu_torch.scripts import (bp_grid_experiment,
                                         osd288_tailblock_ab,
                                         osd_blockshots_sweep,
                                         osd_panel_probe)
    t25 = time.time()
    elim25 = dict(K2=osd_cuda.eliminate_blocks_v1,
                  K4=osd_cuda.eliminate_blocks_fused,
                  K5=osd_cuda.eliminate_blocks_pair)

    def plan25(B, W, M_, kname, block_shots=None, smem_budget=None):
        """make_plan's rule (csrc/gf2_elim_common.cuh), copied: teams / SMs
        a block (the old rule) when block_shots is None, else
        ceil(block_shots / spt) teams and the batch's teams at most;
        clamped by what fits the budget, 8 teams (4 on the device-memory
        branch) and the warps a block."""
        spt = 2 if kname == "K5" else 1
        NR = -(-M_ // 32)
        tb = spt * 4 * 32 * W * (NR | 1)
        budget = (osd_cuda._SMEM_LIMIT if smem_budget is None
                  else min(smem_budget, osd_cuda._SMEM_LIMIT))
        in_dev = budget // tb < 1
        cap = 4 if in_dev else min(budget // tb, 8)
        warps = (512 if kname != "K2" and NR > 32 else 1024) // 32
        cap = min(cap, warps // min(max(W // 2, 1), 16))
        teams = -(-B // spt)
        spb = teams // sms
        if block_shots is not None:
            spb = min(-(-block_shots // spt), teams)
        spb = max(min(spb, cap), 1)
        return dict(shots_per_block=spb * spt,
                    smem_bytes=0 if in_dev else spb * tb,
                    blocks=-(-teams // spb),
                    columns_in="device memory" if in_dev else "shared memory")

    def plan_of(info) -> dict:
        return {k: info[k] for k in ("shots_per_block", "smem_bytes",
                                     "blocks", "columns_in")}

    m144 = decs[0].H.shape[0]
    cases25 = {f"{CODE} {w}": (Hp, Kw, g1_src[w], residual, m144,
                               decs[0].rank, w)
               for w, (Hp, Kw) in widths.items()}
    cases25[f"{CODE_288} basis rerun"] = (*rerun288, res288, m288, rank288,
                                          "basis rerun 288")
    block25 = {k: {} for k in elim25}
    reset_counts()
    for where, (Hp, Kw, src, s25, mm, rk, key) in cases25.items():
        Bc, W = Hp.shape[0], Hp.shape[1]
        for kname, fn_k in elim25.items():
            want = plain25.get((kname, key), plain25["K2", key])
            base = fn_k(src(), s25, Kw, mm, rank=rk, return_steps=True)
            tb = osd_cuda.elim_sizes(W, mm, kname)["team_bytes"]
            settings = [dict(block_shots=b) for b in (1, 2, 4, 8)
                        + ((16,) if kname == "K5" else ())]
            settings += [dict(smem_budget=tb), dict(smem_budget=tb - 1),
                         dict(block_shots=8, smem_budget=tb)]
            taken = []
            for st in settings:
                got = fn_k(src(), s25, Kw, mm, rank=rk, return_steps=True,
                           **st)
                torch.cuda.synchronize()
                for nm, g, y, z in zip(names, got, want, base):
                    if not (torch.equal(g, y) and torch.equal(g, z)):
                        fail(f"phase 25: {kname} {where} {st}: {nm} differs "
                             f"from its plain version or its default plan")
                info = plan_of(osd_cuda.elim_launch_info(Bc, W, mm, dev,
                                                         kname, **st))
                if info != plan25(Bc, W, mm, kname, **st):
                    fail(f"phase 25: {kname} {where} {st}: the library plans "
                         f"{info}, make_plan's rule "
                         f"{plan25(Bc, W, mm, kname, **st)}")
                taken.append((st, info))
            ms25 = {}
            if key != "basis rerun 288":  # each setting's launch alone
                for st in [{}] + settings[:4]:
                    x = src()
                    launch, _ = osd_cuda.prepare_elim_launch(
                        x, s25, Kw, mm, rank=rk, kernel=kname,
                        want_matrix=False, **st)
                    x0 = x.clone() if launch.consumes_input else None
                    ms25[st.get("block_shots", "default")] = \
                        handoff_timing.alone_ms(
                            launch, 5, dev, (lambda: x.copy_(x0))
                            if x0 is not None else None)
            block25[kname][key] = dict(
                team_bytes=tb, kernel_ms=ms25,
                taken={", ".join(f"{k}={v}" for k, v in st.items()):
                       info["shots_per_block"] for st, info in taken})
            print(f"phase 25: {kname} {where} ({W} words, {Bc} shots): every "
                  f"output equal to its plain version and its default plan; "
                  f"shots a block taken: " + ", ".join(
                      f"{', '.join(f'{k}={v}' for k, v in st.items())} -> "
                      f"{info['shots_per_block']}"
                      + (" (device memory)"
                         if info["columns_in"] == "device memory" else "")
                      for st, info in taken)
                  + (("; alone (no matrix) ms: " + ", ".join(
                      f"{k} {v:.4f}" for k, v in ms25.items()))
                     if ms25 else ""), flush=True)
    launches25 = counts()
    torch.cuda.empty_cache()

    # (b) the default plan on the main path: every eliminator launch of
    # phase 4's pooled dispatch asks for no block shape and takes the old
    # rule; the flags stay phase 4's
    seen25 = []
    prep = osd_cuda.prepare_elim_launch

    def recording_prep(Hp, s, K, m, *a, kernel="K2", **kw):
        seen25.append((Hp.shape[0], Hp.shape[1] // 32, s.shape[1], kernel,
                       kw.get("block_shots"), kw.get("smem_budget")))
        return prep(Hp, s, K, m, *a, kernel=kernel, **kw)
    saved_version = osd_cuda._KERNEL_VERSION
    osd_cuda.prepare_elim_launch = recording_prep
    try:
        for version in (1, 2, 3):
            osd_cuda._KERNEL_VERSION = version
            out25 = fn(None, randoms=randoms)
            torch.cuda.synchronize()
            for k, v in out_k.items():
                if not torch.equal(v, out25[k]):
                    fail(f"phase 25: flag {k} of phase 4's dispatch under "
                         f"QLDPC_OSD_KERNEL={version} differs from phase 4's")
    finally:
        osd_cuda.prepare_elim_launch = prep
        osd_cuda._KERNEL_VERSION = saved_version
    if any(bs is not None or bud is not None
           for *_, bs, bud in seen25):
        fail("phase 25: a launch of the main path asked for a block shape")
    plans25 = {}
    for B5, W5, M5, kname, _, _ in sorted(set(seen25)):
        info = plan_of(osd_cuda.elim_launch_info(B5, W5, M5, dev, kname))
        if info != plan25(B5, W5, M5, kname):
            fail(f"phase 25: {kname} at B={B5}, {W5} words took {info}, not "
                 f"make_plan's old rule {plan25(B5, W5, M5, kname)}")
        plans25[f"{kname} B={B5} W={W5}"] = info
        # pick_block_shots against the library at this shape
        tb = osd_cuda.elim_sizes(W5, M5, kname)["team_bytes"]
        spt = 2 if kname == "K5" else 1
        for budget in (None, tb, tb - 1):
            p = osd_cuda.pick_block_shots(M5, W5, budget, 64, kname)
            lib = osd_cuda.elim_launch_info(4096, W5, M5, dev, kname, p,
                                            budget)
            most = osd_cuda.elim_launch_info(4096, W5, M5, dev, kname, 64,
                                             budget)
            pow2 = 1 << (most["shots_per_block"].bit_length() - 1)
            if lib["shots_per_block"] != max(p, spt) or (
                    most["columns_in"] == "shared memory" and p != pow2) or (
                    most["columns_in"] == "device memory" and p != spt):
                fail(f"phase 25: pick_block_shots({M5}, {W5}, {budget}, 64, "
                     f"{kname}) = {p}; the library takes "
                     f"{lib['shots_per_block']}, at most "
                     f"{most['shots_per_block']} in {most['columns_in']}")
    print(f"phase 25: phase 4's dispatch under K2, K4 and K5: "
          f"{len(seen25)} eliminator launches, none asking for a block "
          f"shape, flags equal to phase 4's; each on make_plan's old rule "
          f"(shots a block, shared memory, blocks): " + "; ".join(
              f"{k} {v['shots_per_block']}, {v['smem_bytes']}, "
              f"{v['blocks']}" + (" (device memory)"
                                  if v["columns_in"] == "device memory"
                                  else "")
              for k, v in plans25.items())
          + "; pick_block_shots equals the library's plan there", flush=True)

    # (c) and (d): the four entry points at full width, one short pass
    for mod in (osd_blockshots_sweep, osd288_tailblock_ab, osd_panel_probe,
                bp_grid_experiment):
        mod.REPS = 1
    sweep25, _ = entry("osd_blockshots_sweep", osd_blockshots_sweep.main,
                       [], {"k1", "k2", "g1"}, phase=25)
    tail25, _ = entry("osd288_tailblock_ab", osd288_tailblock_ab.main,
                      ["--budgets-kb", "64"], {"k1", "k2", "g1"}, phase=25)
    panel25, _ = entry("osd_panel_probe", osd_panel_probe.main, [], {"k2"},
                       phase=25)
    grid25, _ = entry("bp_grid_experiment", bp_grid_experiment.main, [],
                      set(), phase=25)
    if len({(r["delta_sum"], r["valid"]) for r in sweep25.values()}) != 1:
        fail("phase 25: the sweep's outputs depend on the block shape")
    rng25 = np.random.default_rng(25)
    tin = osd_panel_probe.transform_inputs(rng25, 64, 1024)
    got = osd_panel_probe.apply_transform(*(torch.as_tensor(
        x.view(np.int32) if x.dtype == np.uint32 else x, device=dev)
        for x in tin)).cpu().numpy()
    if not np.array_equal(got, osd_panel_probe.transform_plain(
            tin[0].view(np.int32), tin[1].view(np.int32), tin[2])):
        fail("phase 25: the panel-entry transform's bfloat16 products on "
             "the card differ from its integer XOR version")
    print(f"phase 25: osd_blockshots_sweep ms by block_shots: " + ", ".join(
        f"{k} {v['ms']:.2f}" for k, v in sweep25.items())
        + f"; osd288_tailblock_ab best ms: " + ", ".join(
            f"{k} {v:.2f}" for k, v in tail25["best_ms"].items())
        + f"; osd_panel_probe us a step " + ", ".join(
            f"W={w} {panel25[w]['us_per_step']:.3f}" for w in (8, 16, 40))
        + f", transform ms {panel25['transform_ms']['pair']:.3f} / "
        f"{panel25['transform_ms']['six_pairs']:.3f} (its bits equal the "
        f"integer XOR version on 64 shots); grid ms an iteration " + ", ".join(
            f"{k.split()[0]} {v['ms_per_iter']:.4f}"
            for k, v in grid25["rows"].items())
        + f" (values differ by at most {grid25['max_value_diff']:g})",
        flush=True)
    print(f"phase 25: {time.time() - t25:.1f} s", flush=True)

    kernels = [
        dict(name="bp_flood_kernel", route="cuda",
             source="qldpc_tpu_torch/csrc/bp_lift_flood.cu",
             replaces="qldpc_tpu/ops/bp_lift_pallas.py:93",
             launches=launches["k1"], max_abs_err=k1["Z"]["max_abs_err"],
             ms=k1["Z"]["ms"], plain_ms=k1["Z"]["plain_ms"],
             bound_ms=k1["Z"]["bound_ms"], bound_by=k1["Z"]["bound_by"],
             library_ms=None, multicode_launches=launches_mc["k1"],
             batch_decoder_launches=api["minsum"]["launches"]["k1"],
             validate_ler_launches=launches_sw["minsum"]["k1"],
             at_multicode={n: {b: dict(ms=r["k1_ms"],
                                       plain_ms=r["k1_plain_ms"],
                                       bound_ms=r["k1_bound_ms"])
                               for b, r in mc[n].items() if b in "ZX"}
                           for n in MC_CODES}),
        dict(name="gf2_elim_kernel", route="cuda",
             source="qldpc_tpu_torch/csrc/gf2_elim.cu",
             replaces="qldpc_tpu/ops/osd_pallas.py:54",
             launches=launches["k2"], max_abs_err=k2_err,
             ms=k2["stage1"]["ms"],
             kernel_ms=k2["stage1"]["shape"]["kernel_ms"],
             plain_ms=k2["stage1"]["plain_ms"],
             bound_ms=k2["stage1"]["bound_ms"],
             bound_by=k2["stage1"]["bound_by"], library_ms=None,
             multicode_launches=launches_mc["k2"],
             batch_decoder_launches=api["minsum"]["launches"]["k2"],
             code_capacity_launches=c18["k2"],
             validate_ler_launches=sum(c["k2"] for c in launches_sw.values()),
             empty_range_ms=gate_ms["k2"],
             kernel_ms_on_g1={w: k2[w]["alone"] for w in widths},
             kernel_ms_on_g1_288_basis_rerun=k2["basis_rerun_288_alone"],
             block_shape=block25["K2"], block_shape_launches=launches25["k2"],
             at_multicode={n: {b: {w: dict(ms=r[f"k2_{w}"]["ms"],
                                           bound_ms=r[f"k2_{w}"]["bound_ms"])
                                   for w in ("stage1", "prefix", "full")}
                               for b, r in mc[n].items() if b in "ZX"}
                           for n in MC_CODES}),
        dict(name="bp_layered_kernel", route="cuda",
             source="qldpc_tpu_torch/csrc/bp_lift_layered.cu",
             replaces="qldpc_tpu/ops/bp_lift_pallas.py:255",
             launches=launches_l["k3"], max_abs_err=k3["Z"]["max_abs_err"],
             ms=k3["Z"]["ms"], plain_ms=k3["Z"]["plain_ms"],
             bound_ms=k3["Z"]["bound_ms"], bound_by=k3["Z"]["bound_by"],
             library_ms=None,
             batch_decoder_launches=api["layered"]["launches"]["k3"],
             validate_ler_launches=launches_sw["layered"]["k3"]),
    ]
    for key, name, src, line in (
            ("k4", "gf2_elim_fused_kernel", "gf2_elim_fused.cu", 158),
            ("k5", "gf2_elim_pair_kernel", "gf2_elim_pair.cu", 272)):
        st = k45[key]["stage1"]
        kernels.append(dict(
            name=name, route="cuda", source=f"qldpc_tpu_torch/csrc/{src}",
            replaces=f"qldpc_tpu/ops/osd_pallas.py:{line}",
            launches=launches_v[key][key], max_abs_err=k45_err[key],
            ms=st["ms"], kernel_ms=st["shape"]["kernel_ms"],
            plain_ms=st["plain_ms"], bound_ms=st["bound_ms"],
            bound_by=st["bound_by"], library_ms=None,
            ms_by_width={w: k45[key][w]["ms"] for w in widths},
            bound_ms_by_width={w: k2[w]["bound_ms"] for w in widths},
            empty_range_ms=gate_ms[key],
            kernel_ms_on_g1={w: k45[key][w]["alone"] for w in widths},
            kernel_ms_on_g1_288_basis_rerun=k45[key][
                "basis_rerun_288_alone"],
            block_shape=block25[key.upper()],
            block_shape_launches=launches25[key]))
    kernels.append(dict(
        name="gather_pack_kernel", route="cuda",
        source="qldpc_tpu_torch/csrc/gather_pack.cu",
        replaces="qldpc_tpu/ops/osd.py:73", launches=launches["g1"],
        max_abs_err=g1_err, ms=g1["stage1"]["ms"],
        kernel_ms=g1["stage1"]["kernel_ms"],
        plain_ms=g1["stage1"]["plain_ms"],
        bound_ms=g1["stage1"]["bound_ms"],
        bound_by=g1["stage1"]["bound_by"], library_ms=None,
        ms_by_width={w: r["ms"] for w, r in g1.items()},
        kernel_ms_by_width={w: r["kernel_ms"] for w, r in g1.items()},
        bound_ms_by_width={w: r["bound_ms"] for w, r in g1.items()},
        plain_ms_by_width={w: r["plain_ms"] for w, r in g1.items()},
        kernel_ms_at_288_basis_rerun=g1_288,
        empty_range_kernel_ms=g1_empty, host_ms_per_call=host_ms,
        pipeline_depth_shots_per_s={d: r["shots_per_sec"]
                                    for d, r in runs22.items()}))
    kernels += [
        dict(name="gather_iter_kernel", route="cuda",
             source="qldpc_tpu_torch/csrc/gather_iter.cu",
             replaces="scripts/pallas_gather_bench.py:35",
             launches=p1_launches, max_abs_err=p1_top["max_abs_err"],
             ms=p1_top["ms"], kernel_ms=p1_top["kernel_ms"],
             load_store_ms=p1_top["load_store_ms"],
             round_us=p1_top["round_us"], plain_ms=p1_top["plain_ms"],
             bound_ms=p1_top["bound_ms"], bound_by=p1_top["bound_by"],
             library_ms=p1_top["library_ms"]),
        dict(name="take_along_kernel", route="cuda",
             source="qldpc_tpu_torch/csrc/take_along.cu",
             replaces="scripts/pallas_gather_probe.py:26",
             launches=p2_launches, max_abs_err=0.0, ms=p2_top["ms"],
             kernel_ms=p2_top["kernel_ms"], plain_ms=p2_top["plain_ms"],
             bound_ms=p2_top["bound_ms"], bound_by="bytes",
             library_ms=p2_top["library_ms"]),
        dict(name="trial_syndromes_kernel", route="cuda",
             source="qldpc_tpu_torch/csrc/trial_syndromes.cu",
             replaces="qldpc_tpu/ops/sampler.py:120",
             launches=launches["s1"], max_abs_err=0.0, ms=s1["ms"],
             kernel_ms=s1["kernel_ms"], plain_ms=s1["plain_ms"],
             bound_ms=s1["bound_ms"], bound_by=s1["bound_by"],
             library_ms=s1["library_ms"],
             erring_per_shot=s1["erring_per_shot"],
             flips_per_shot_frame=s1["flips_per_shot_frame"],
             launches_per_dispatch=per_dispatch["s1"],
             multicode_launches=launches_mc["s1"],
             validate_ler_launches=sum(c["s1"]
                                       for c in launches_sw.values())),
        dict(name="bp_residual_kernel", route="cuda",
             source="qldpc_tpu_torch/csrc/bp_residual.cu",
             replaces="qldpc_tpu/parallel/engine.py:236",
             launches=launches["r1"], max_abs_err=0.0, ms=r1["Z"]["ms"],
             kernel_ms=r1["Z"]["kernel_ms"], plain_ms=r1["Z"]["plain_ms"],
             bound_ms=r1["Z"]["bound_ms"], bound_by=r1["Z"]["bound_by"],
             library_ms=r1["Z"]["library_ms"],
             at_basis={b: {k: v for k, v in r.items() if k != "bound_by"}
                       for b, r in r1.items()},
             launches_per_dispatch=per_dispatch["r1"],
             multicode_launches=launches_mc["r1"],
             multicode_launches_per_dispatch=c_mc["r1"],
             batch_decoder_launches=api["minsum"]["launches"]["r1"],
             code_capacity_launches=c18["r1"],
             validate_ler_launches=sum(c["r1"]
                                       for c in launches_sw.values())),
    ]
    keys23 = dict(bp_flood_kernel="k1", gf2_elim_kernel="k2",
                  bp_layered_kernel="k3", gf2_elim_fused_kernel="k4",
                  gf2_elim_pair_kernel="k5", gather_pack_kernel="g1",
                  trial_syndromes_kernel="s1", bp_residual_kernel="r1")
    for kd in kernels:
        if kd["name"] in keys23:
            kd["entry_point_launches"] = {
                lab: c[keys23[kd["name"]]] for lab, c in c23.items()
                if c[keys23[kd["name"]]]}
    print(f"max SM clock {sm_clock}, {sms} SMs; every phase passed in "
          f"{time.time() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
