#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (qldpc_tpu_torch).

Builds the hand-written CUDA kernels from qldpc_tpu_torch/csrc, holds each
against its plain PyTorch version on the card at the [[144,12,12]] shapes
of the main path, drives the port's main path (pooled BP+OSD Monte-Carlo
rounds and run_simulation at the bench configuration: [[144,12,12]],
12 cycles, p=0.004, 1024 shots per round, 4 rounds per dispatch, maxIter 50,
OSD order 2), and prints one JSON result line last.

Run from the root of a checkout on a machine with an NVIDIA GPU and the CUDA
toolkit:

    python3 chip_smoke.py

Phases: (1) device and build, (2) BP kernel K1 vs its plain version,
(3) GF(2) elimination kernel K2 vs its plain version, (4) main path. Exits
non-zero, and prints no result, without a GPU, outside a checkout, or when
any phase fails.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import torch

SEED = 2024
CODE, CYCLES, P = "[[144, 12, 12]]", 12, 0.004
BATCH, RPD, MAXITER, OSD_ORDER = 1024, 4, 50, 2
MAX_TRIALS = 16384
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
K1_OPS_PER_EDGE_ITER = 17   # float32 ops per live edge per iteration
K2_OPS_PER_ROW_STEP = 5     # int ops per row per column step (scan only)
# [[144,12,12]] p=0.004 dynamical, the reference's archived LER
ARCHIVE_LER, ARCHIVE_TRIALS = 200 / 1135, 1135


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
        from qldpc_tpu_torch.ops import bp_lift_cuda, osd, osd_cuda
        from qldpc_tpu_torch.ops.bp import alpha_schedule
        from qldpc_tpu_torch.ops.sampler import (augmented_bits, fault_bits,
                                                 sample_gate_randoms)
        from qldpc_tpu_torch.parallel import engine
    except ImportError as e:
        fail(f"run from the root of a checkout: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- phase 1: device and build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "unknown"
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

    code = qt.get_code(CODE)
    circ = qt.SyndromeCircuit(code, num_cycles=CYCLES)
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, P)
    seq = alpha_schedule("dynamical", MAXITER)
    decs = [engine._make_basis(circ, M, b, seq, osd_order=OSD_ORDER,
                               device=dev) for b in "ZX"]
    n_locs = circ.num_error_locs
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err, pauli, cat2 = sample_gate_randoms(gen, BATCH, n_locs, P)

    # ---- phase 2: K1 against its plain version ----
    k1 = {}
    failed = {}
    for basis, dec in zip("ZX", decs):
        aug = augmented_bits(fault_bits(err, pauli, cat2, dec.maps, basis),
                             dec.maps)
        syn = aug[:, :dec.maps.num_syn].contiguous()
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
        edges = int(dec.H.sum())
        shot_iters = int((a["iterations"].long() + 1).sum())
        kb, bb = bound(
            nbytes(syn, a["values"], a["hard"], a["converged"],
                   a["iterations"], dec.prior, dec.alpha_seq,
                   tabs["chk_nbr"], tabs["col_chk"], tabs["prior_grid"],
                   tabs["out_gather"], tabs["residual"]),
            K1_OPS_PER_EDGE_ITER * edges * shot_iters)
        k1[basis] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err_abs,
                         bound_ms=kb, bound_by=bb, edges=edges,
                         converged=int(a["converged"].sum()),
                         mean_iters=shot_iters / BATCH)
        failed[basis] = (syn[unconv], b["values"][unconv],
                         b["hard"][unconv])
        print(f"phase 2: K1 basis {basis}: exact; {ms:.3f} ms "
              f"(plain {plain_ms:.1f} ms, bound {kb:.4f} ms by {bb}); "
              f"{k1[basis]['converged']}/{BATCH} converged, mean "
              f"{k1[basis]['mean_iters']:.2f} iterations", flush=True)

    # ---- phase 3: K2 against its plain version ----
    dec = decs[0]
    syn_f, vals_f, hard_f = failed["Z"]
    m, K, KT_basis = dec.H.shape[0], dec.K, dec.basis_cols.shape[0]
    residual = (syn_f.to(torch.int32)
                ^ ((hard_f.float() @ dec.HT).to(torch.int32) & 1))
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
    for width, (Hp, Kw) in widths.items():
        for exit_on_valid in (False, True):
            kw = dict(rank=dec.rank, exit_on_valid=exit_on_valid,
                      return_steps=True)
            a = osd_cuda.eliminate_blocks(Hp, residual, Kw, m, **kw)
            torch.cuda.synchronize()
            b = osd_cuda.eliminate_blocks_plain(Hp, residual, Kw, m, **kw)
            for nm, x, y in zip(names, a, b):
                if not torch.equal(x, y):
                    fail(f"phase 3: K2 {nm} differs from the plain version "
                         f"({width}, exit_on_valid={exit_on_valid})")
            k2_err = max(k2_err, max(float((x.long() - y.long()).abs().max())
                                     for x, y in zip(a, b)))
        ms = cuda_ms(lambda: osd_cuda.eliminate_blocks(Hp, residual, Kw, m,
                                                       rank=dec.rank), 5)
        steps = a[5]
        kb, bb = bound(2 * nbytes(Hp, residual) + nbytes(a[4], steps),
                       K2_OPS_PER_ROW_STEP * m * int(steps.long().sum()))
        k2[width] = dict(ms=ms, words=Hp.shape[1], shots=len(Hp),
                         bound_ms=kb, bound_by=bb,
                         mean_steps=float(steps.float().mean()),
                         max_steps=int(steps.max()))
        print(f"phase 3: K2 {width} ({Hp.shape[1]} words, {len(Hp)} shots):"
              f" exact with and without the validity exit; {ms:.3f} ms "
              f"(bound {kb:.4f} ms by {bb}); steps mean "
              f"{k2[width]['mean_steps']:.1f} max {k2[width]['max_steps']}",
              flush=True)
    Hp, Kw = widths["stage1"]
    k2["stage1"]["plain_ms"] = cuda_ms(
        lambda: osd_cuda.eliminate_blocks_plain(Hp, residual, Kw, m,
                                                rank=dec.rank), 1)
    Hp, Kw = widths["full"]
    a = osd_cuda.eliminate_blocks(Hp, residual, Kw, m, rank=dec.rank,
                                  full_jordan=True)
    b = osd_cuda.eliminate_blocks_plain(Hp, residual, Kw, m, rank=dec.rank,
                                        full_jordan=True)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail("phase 3: K2 full_jordan differs from the plain version")
    print(f"phase 3: K2 full_jordan at full width exact; stage-1 plain "
          f"{k2['stage1']['plain_ms']:.1f} ms", flush=True)

    # ---- phase 4: main path ----
    randoms = [sample_gate_randoms(gen, BATCH, n_locs, P)
               for _ in range(RPD)]
    fn = engine.make_pooled_round_fn(decs[0], decs[1], n_locs, P, BATCH,
                                     MAXITER, OSD_ORDER, RPD)
    bp_lift_cuda.decode_batch_lift_cuda.launches = 0
    osd_cuda.eliminate_blocks.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    out_k = fn(None, randoms=randoms)
    torch.cuda.synchronize()
    dispatch_s = time.time() - t0
    per_dispatch = dict(k1=bp_lift_cuda.decode_batch_lift_cuda.launches,
                        k2=osd_cuda.eliminate_blocks.launches)

    @contextlib.contextmanager
    def plain_versions():
        saved = engine.decode_batch_lift_cuda, osd.eliminate_blocks
        engine.decode_batch_lift_cuda = bp_lift_cuda.decode_batch_lift_plain
        osd.eliminate_blocks = osd_cuda.eliminate_blocks_plain
        try:
            yield
        finally:
            engine.decode_batch_lift_cuda, osd.eliminate_blocks = saved

    t0 = time.time()
    with plain_versions():
        out_p = fn(None, randoms=randoms)
    torch.cuda.synchronize()
    plain_dispatch_s = time.time() - t0
    for key, v in out_k.items():
        if v.shape != (RPD * BATCH,) or not torch.equal(v, out_p[key]):
            fail(f"phase 4: pooled dispatch flag {key} differs between the "
                 "kernels and the plain versions")
    print(f"phase 4: pooled dispatch ({RPD}x{BATCH} shots) identical "
          f"through kernels ({dispatch_s:.2f} s) and plain versions "
          f"({plain_dispatch_s:.2f} s); launches per dispatch "
          f"K1 {per_dispatch['k1']} K2 {per_dispatch['k2']}; BP converged "
          f"z {int(out_k['z_conv'].sum())} x {int(out_k['x_conv'].sum())} "
          f"of {RPD * BATCH}", flush=True)

    bb_params = dict(ell=code.ell, m=code.m, a_x_powers=code.a_x_powers,
                     a_y_powers=code.a_y_powers, b_y_powers=code.b_y_powers,
                     b_x_powers=code.b_x_powers)
    bp_lift_cuda.decode_batch_lift_cuda.launches = 0
    osd_cuda.eliminate_blocks.launches = 0
    res = qt.run_simulation(
        code.Hx, code.Hz, code.Lx, code.Lz, P, num_cycles=CYCLES,
        maxIter=MAXITER, osd_order=OSD_ORDER, max_trials=MAX_TRIALS,
        batch_size=BATCH, rounds_per_dispatch=RPD, base_seed=SEED,
        precomputed_matrices=M, verbose=False, **bb_params)
    torch.cuda.synchronize()
    launches = dict(k1=bp_lift_cuda.decode_batch_lift_cuda.launches,
                    k2=osd_cuda.eliminate_blocks.launches)
    ler = res["logical_error_rate"]
    n = res["num_trials"]
    sig = np.sqrt(ler * (1 - ler) / max(n, 1)
                  + ARCHIVE_LER * (1 - ARCHIVE_LER) / ARCHIVE_TRIALS)
    print(f"phase 4: run_simulation {n} shots: LER {ler:.5f} "
          f"(z {(ler - ARCHIVE_LER) / sig:+.2f} vs the reference archive "
          f"{ARCHIVE_LER:.3f}, maxIter unrecorded), {res['shots_per_sec']:.1f}"
          f" shots/s, {res['osd_rank_deficient_shots']} rank-deficient "
          f"shot-bases; launches K1 {launches['k1']} K2 {launches['k2']}",
          flush=True)
    if launches["k1"] <= 0 or launches["k2"] <= 0:
        fail(f"phase 4: main path did not launch every kernel: {launches}")
    if n != MAX_TRIALS or not (0.0 < ler < 0.5):
        fail(f"phase 4: implausible result {res}")

    kernels = [
        dict(name="bp_flood_kernel", route="cuda",
             source="qldpc_tpu_torch/csrc/bp_lift_flood.cu",
             replaces="qldpc_tpu/ops/bp_lift_pallas.py:93",
             launches=launches["k1"], max_abs_err=k1["Z"]["max_abs_err"],
             ms=k1["Z"]["ms"], plain_ms=k1["Z"]["plain_ms"],
             bound_ms=k1["Z"]["bound_ms"], bound_by=k1["Z"]["bound_by"],
             library_ms=None),
        dict(name="gf2_elim_kernel", route="cuda",
             source="qldpc_tpu_torch/csrc/gf2_elim.cu",
             replaces="qldpc_tpu/ops/osd_pallas.py:54",
             launches=launches["k2"], max_abs_err=k2_err,
             ms=k2["stage1"]["ms"], plain_ms=k2["stage1"]["plain_ms"],
             bound_ms=k2["stage1"]["bound_ms"],
             bound_by=k2["stage1"]["bound_by"], library_ms=None),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
