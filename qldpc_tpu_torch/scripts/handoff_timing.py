"""Kernel-alone and per-call times of the OSD's matrix hand-off: the
gather-pack G1 and the eliminators K2, K4 and K5 fed by it, for one
checkout or two.

Inputs are ``chip_smoke.py`` phase 3's: [[144,12,12]] (12 cycles,
p=0.004) basis Z, 1024 shots drawn from seed 2024 through K1 (maxIter 50,
dynamical alpha), the BP-failed ones with their columns in |LLR| order at
the OSD's widths: stage 1 (8 words), the prefix (40) and the full width
(the prefix and the column basis, 70 words), 1008 rows; and [[288,12,18]]'s
basis rerun (198 words by 2880 rows, B=37, phase 3's seed), whose matrices
are cached in ``matrix_cache/`` in the working directory.

Every kernel time is a launch alone on the card: a prepared launch (no
wrapper, no allocation) captured ``reps`` times into a CUDA graph and
replayed between CUDA events (``gather_timing.graph_ms``). A launch that
consumes its input (column input eliminated in place on the device-memory
branch) is captured after a copy that restores it, and the copy's own time
is taken away. Read:

* G1 at every width beside its byte bound (its output written once, the
  column indices, their CSC offsets and rows read once), and gated to
  nothing;
* K2, K4 and K5 on G1's output, with the reduced matrix written and
  without;
* the host's time a call: ``time.perf_counter`` over 1,000 unsynchronised
  wrapper calls of G1 and of K2 (K2 as the OSD calls it), gated to nothing
  so that the card never holds the host back (the wrappers do the same
  host work whatever the gate); then the same calls under ``cProfile``,
  whose heaviest functions (own time a call, inflated by the profiler)
  say where that time goes.

The checkout's own layout is used: G1's column layout, or in an earlier
checkout (one without ``osd_cuda.prepare_gather_pack``) the words-major
layout, whose eliminators always write the reduced matrix. Usage (from the
root of a checkout, on a machine with a GPU):

    python qldpc_tpu_torch/scripts/handoff_timing.py [--root DIR]
        [--label NAME] [--json PATH]

``--root`` imports ``qldpc_tpu_torch`` from another checkout (for
instance a parent commit unpacked by ``git archive``), which builds its own
kernels there, so that two versions are compared on one card in one call,
in turns. Prints the card's name and power limit, then one JSON object a
case.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet, at 700 W)
SEED, P, MAXITER, BATCH = 2024, 0.004, 50, 1024
HOST_CALLS = 1000
PROFILE_TOP = 8  # functions a host profile reports


def phase3_inputs(qt, engine, sampler, bp_lift_cuda, osd_cuda,
                  dev) -> tuple:
    """chip_smoke phase 3's basis-Z inputs: the decoder, the failed shots'
    columns in |LLR| order (prefix) and with the column basis appended
    (full), and their residual syndromes (R1, ``osd_cuda.bp_residual``, as
    the round computes them)."""
    from qldpc_tpu_torch.ops.bp import alpha_schedule
    code = qt.get_code("[[144, 12, 12]]")
    circ = qt.SyndromeCircuit(code, num_cycles=12)
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, P)
    dec = engine._make_basis(circ, M, "Z", alpha_schedule("dynamical",
                                                          MAXITER),
                             osd_order=2, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    maps_x = sampler.make_trial_maps(circ, M, "X", device=dev)
    syn = sampler.trial_batch(gen, P, dec.maps, maps_x, circ.num_error_locs,
                              BATCH)["syndrome_z"]
    bp = bp_lift_cuda.decode_batch_lift_cuda(dec.lifted, syn, dec.prior,
                                             dec.alpha_seq, MAXITER)
    fail = ~bp["converged"]
    syn_f, vals, hard = syn[fail], bp["values"][fail], bp["hard"][fail]
    residual = osd_cuda.bp_residual(syn_f, hard, dec.HT, dec.col_index)[0]
    cols = torch.sort(vals.abs(), dim=1, stable=True).indices[:, :dec.K]
    full = torch.cat([cols, dec.basis_cols[None].expand(
        len(cols), len(dec.basis_cols))], 1)
    return dec, cols, full, residual


def basis_rerun_288(qt, dev) -> tuple:
    """chip_smoke phase 3's [[288,12,18]] basis-rerun inputs: H, the
    prefix and basis columns of 37 shots, their syndromes, the rank."""
    from qldpc_tpu_torch.models import gf2
    from qldpc_tpu_torch.ops import osd
    from qldpc_tpu_torch.scripts.bp_breakdown import cached_matrices
    _, M = cached_matrices(qt.get_code("[[288, 12, 18]]"), 18, P)
    H = (np.asarray(M["HdecZ"]) != 0).astype(np.uint8)
    prior = qt.channel_llrs(M["channel_probsZ"]).astype(np.float32)
    rng = np.random.default_rng(SEED)
    B, (m, n) = 37, H.shape
    errs = rng.random((B, n)) < M["channel_probsZ"]
    syn = ((torch.as_tensor(errs, dtype=torch.float32, device=dev)
            @ torch.as_tensor(H.T, dtype=torch.float32, device=dev))
           % 2).to(torch.int32)
    noise = torch.as_tensor(rng.standard_normal((B, n)),
                            dtype=torch.float32, device=dev)
    llr = torch.as_tensor(prior, device=dev) * (1 + 0.1 * noise)
    order = torch.sort(llr.abs(), dim=1, stable=True).indices
    basis = torch.as_tensor(gf2.column_basis(H), device=dev)
    cols = torch.cat([order[:, :osd.choose_K(m, n)],
                      basis[None].expand(B, len(basis))], 1)
    return H, cols, syn, gf2.rank_fast(H)


def g1_bytes(index, cols, Kx: int, S: int = 0) -> int:
    """G1's bytes: its output written once (Kx columns of S words a shot,
    or with S = 0 the words-major Kx/32 words of m rows), the column
    indices, their CSC offsets and each column's rows read once (this
    run's columns)."""
    deg = (index.colptr[1:] - index.colptr[:-1]).long()
    B = len(cols)
    per_shot = Kx * S if S else Kx // 32 * index.m
    out = B * per_shot * 4
    return out + cols.numel() * 16 + int(deg[cols].sum()) * 4


def host_ms(call, calls: int) -> float:
    """ms a call on the host's clock over ``calls`` unsynchronised
    calls."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def host_profile(call, calls: int, top: int) -> list:
    """The ``top`` functions by own time over ``calls`` calls under
    cProfile: (function, us a call of the wrapper, calls a call)."""
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        call()
    prof.disable()
    torch.cuda.synchronize()
    st = pstats.Stats(prof).stats
    rows = sorted(st.items(), key=lambda kv: -kv[1][2])[:top]
    return [(f"{Path(f).name}:{line}({fn})", tt * 1e6 / calls, nc / calls)
            for (f, line, fn), (_, nc, tt, _, _) in rows]


def alone_ms(launch, reps: int, device, restore=None) -> float:
    """A prepared launch alone on the card: ``reps`` launches in a CUDA
    graph (``gather_timing.graph_ms``). One that consumes its input is
    restored before each launch, the restore's own time taken away."""
    from qldpc_tpu_torch.scripts.gather_timing import graph_ms
    if restore is None:
        return graph_ms(launch, reps, device)
    return (graph_ms(lambda: (restore(), launch()), reps, device)
            - graph_ms(restore, reps, device))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]),
                    help="checkout whose qldpc_tpu_torch to time")
    ap.add_argument("--label", default="",
                    help="name printed with every result")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", help="write every case here as one list")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import qldpc_tpu_torch as qt
    from qldpc_tpu_torch.ops import bp_lift_cuda, osd_cuda, sampler
    from qldpc_tpu_torch.parallel import engine
    from qldpc_tpu_torch.scripts import card_line
    if not torch.cuda.is_available():
        raise SystemExit("handoff_timing needs a CUDA GPU")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(dev), flush=True)
    columns = hasattr(osd_cuda, "prepare_gather_pack")  # the column layout
    layout = "columns" if columns else "words"
    reps = args.reps
    out = []

    def emit(rec):
        rec = dict(label=args.label, layout=layout, **rec)
        print(json.dumps(rec), flush=True)
        out.append(rec)

    def g1_launch(index, cols, Kx, live=None):
        """A prepared G1 launch and its output."""
        if columns:
            return osd_cuda.prepare_gather_pack(index, cols, Kx, live)
        # an earlier checkout: the wrapper's launch, unwrapped
        c = cols.to(torch.int64)
        o = torch.empty((len(c), Kx // 32, index.m), dtype=torch.int32,
                        device=dev)
        fn = osd_cuda._gather_pack_lib().gather_pack_launch
        ptr = None if live is None else live.data_ptr()

        def launch():
            osd_cuda._kernels.check(fn(
                index.colptr.data_ptr(), index.rows.data_ptr(),
                c.data_ptr(), c.stride(0), ptr, o.data_ptr(), len(c),
                cols.shape[1], Kx // 32, index.m,
                osd_cuda._kernels.stream_ptr(dev)), "gather_pack_launch")
        return launch, o

    dec, cols, full, residual = phase3_inputs(qt, engine, sampler,
                                              bp_lift_cuda, osd_cuda, dev)
    m, K = dec.H.shape[0], dec.K
    index = dec.col_index
    widths = {"stage1": (cols[:, :256], 256, 256),
              "prefix": (cols, K, K),
              "full": (full, -(-full.shape[1] // 32) * 32, full.shape[1])}
    H288, cols288, syn288, rank288 = basis_rerun_288(qt, dev)
    index288 = osd_cuda.column_index(H288, dev)
    Kx288 = -(-cols288.shape[1] // 32) * 32
    empty = torch.zeros(2, dtype=torch.int32, device=dev)
    cases = dict(widths, basis_rerun_288=(cols288, Kx288, cols288.shape[1]))

    # G1 alone
    for width, (cl, Kx, _) in cases.items():
        idx = index288 if width == "basis_rerun_288" else index
        launch, o = g1_launch(idx, cl, Kx)
        nb = g1_bytes(idx, cl, Kx, o.shape[2] if columns else 0)
        emit(dict(kernel="G1", width=width, shots=len(cl), words=Kx // 32,
                  rows=idx.m, ms=alone_ms(launch, reps, dev), bytes=nb,
                  bound_ms=nb / HBM_BYTES_PER_S * 1e3))
        if width == "full":
            launch, _ = g1_launch(idx, cl, Kx, live=empty)
            emit(dict(kernel="G1", width=width, gated_to_nothing=True,
                      ms=alone_ms(launch, reps, dev)))

    # the host's time a call, gated to nothing, and where it goes
    cl, Kx, Kw = widths["stage1"]
    packed = osd_cuda.gather_pack(index, cl, Kx)
    no_matrix = dict(want_matrix=False) if columns else {}
    calls = {"G1": lambda: osd_cuda.gather_pack(index, cl, Kx, live=empty),
             "K2": lambda: osd_cuda.eliminate_blocks_v1(
                 packed, residual, Kw, m, rank=dec.rank, live=empty,
                 **no_matrix)}
    for name, call in calls.items():
        emit(dict(kernel=name, host_ms_per_call=host_ms(call, HOST_CALLS),
                  calls=HOST_CALLS))
        emit(dict(kernel=name, host_profile=host_profile(
            call, HOST_CALLS, PROFILE_TOP)))

    # the eliminators alone on G1's output
    for kernel in ("K2", "K4", "K5"):
        for width, (cl, Kx, Kw) in cases.items():
            at288 = width == "basis_rerun_288"
            idx, s = (index288, syn288) if at288 else (index, residual)
            rank = rank288 if at288 else dec.rank
            for want in (True, False) if columns else (True,):
                pack, hp = g1_launch(idx, cl, Kx)
                pack()
                x = hp.clone()
                kw = dict(want_matrix=want) if columns else {}
                launch, _ = osd_cuda.prepare_elim_launch(
                    x, s, Kw, idx.m, rank=rank, kernel=kernel, **kw)
                consumes = getattr(launch, "consumes_input", False)
                ms = alone_ms(launch, reps, dev,
                              (lambda: x.copy_(hp)) if consumes else None)
                emit(dict(kernel=kernel, width=width, want_matrix=want,
                          shots=len(cl), words=Kx // 32,
                          consumes_input=consumes, ms=ms))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
