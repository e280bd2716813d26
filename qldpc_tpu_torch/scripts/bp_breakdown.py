"""Decompose the cost of the flooding BP stage (kernel K1).

Counterpart of the JAX package's ``scripts/bp_pallas_breakdown.py``: what it
measures, for the port's kernel. Each line is host ms per call with the
device synchronised after every call, so each includes the fixed per-call
floor that the first line measures:

* null dispatch (floor): one small reduction;
* launch prep alone: what the wrapper does before the launch
  (``bp_lift_cuda.prepare_flood_launch``: syndrome and prior casts, tables,
  output allocation); the plain version's set-up on the CPU;
* K1 kernel-only at maxIter 1 and 20: the launch alone, on inputs and
  outputs prepared once (``bp_lift_cuda.prepare_flood_launch``), and the
  cost per iteration, (k20 - k1) / 19;
* the full wrapper ``decode_batch_lift_cuda`` at maxIter 1 and 20, and its
  cost per iteration;
* wrapper postprocess = full20 - kernel20 (the launch prep again; the
  posterior gather is in the kernel's epilogue).

Syndromes are the Z-basis syndromes of one ``trial_batch`` drawn with
seed 0; decoding matrices are cached in ``matrix_cache/`` in the working
directory through ``utils.caching``, in the JAX package's file format. With
``--device cpu`` every line runs the plain version (kernel-only equals the
wrapper there).

Usage (from the root of a checkout):

    python -m qldpc_tpu_torch.scripts.bp_breakdown [--code "[[144, 12, 12]]"]
        [--p 0.004] [--batch 512] [--device cuda|cpu] [--reps 10]
"""
from __future__ import annotations

import argparse

import torch

from .. import build_decoding_matrices, get_code, resolve_device
from .. import SyndromeCircuit
from ..ops import bp_lift_cuda
from ..ops.bp import alpha_schedule
from ..ops.sampler import trial_batch
from ..parallel.engine import _make_basis
from ..utils.caching import compute_cache_key, load_matrices, save_matrices
from . import card_line, wall_ms

CACHE_DIR = "matrix_cache"
MAX_ITER = 20


def cached_matrices(code, cycles: int, p: float, cache_dir=CACHE_DIR):
    """Decoding matrices of ``code`` from the cache, built and saved on a
    miss; returns (circuit, matrices)."""
    circ = SyndromeCircuit(code, num_cycles=cycles)
    key = compute_cache_key(code.Hx, code.Hz, code.Lx, code.Lz, cycles, p)
    M = load_matrices(cache_dir, key)
    if M is None:
        M = build_decoding_matrices(circ, code.Lx, code.Lz, p)
        save_matrices(cache_dir, key, M)
    return circ, M


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--code", default="[[144, 12, 12]]")
    ap.add_argument("--p", type=float, default=0.004)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B = args.batch
    code = get_code(args.code)
    cycles = code.distance
    circ, M = cached_matrices(code, cycles, args.p)
    seq = alpha_schedule("dynamical", MAX_ITER)
    dz, dx = (_make_basis(circ, M, b, seq, osd_order=2, device=dev)
              for b in "ZX")
    g = dz.lifted
    print(card_line(dev))
    print(f"{args.code} B={B} ell={g.ell} mm={g.mm} T={g.T} NB={g.NB} "
          f"EB={g.EB}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    syn = trial_batch(gen, args.p, dz.maps, dx.maps, circ.num_error_locs,
                      B)["syndrome_z"]
    rep = dict(code=args.code, p=args.p, batch=B, device=str(dev))

    def line(name, key, fn):
        rep[key] = wall_ms(fn, args.reps, dev)
        print(f"{name:44s} {rep[key]:9.3f} ms", flush=True)

    line("null dispatch (floor)", "null_ms", lambda: syn.sum())
    def prep():
        if dev.type == "cuda":
            return bp_lift_cuda.prepare_flood_launch(g, syn, dz.prior,
                                                     dz.alpha_seq, MAX_ITER)
        return bp_lift_cuda._PlainGraph(g, syn)

    line("launch prep alone", "prep_ms", prep)

    def decode(mi):
        return bp_lift_cuda.decode_batch_lift_cuda(g, syn, dz.prior,
                                                   dz.alpha_seq, mi)

    def kernel_only(mi):
        if dev.type != "cuda":
            return lambda: decode(mi)
        launch, _ = bp_lift_cuda.prepare_flood_launch(g, syn, dz.prior,
                                                      dz.alpha_seq, mi)
        return launch

    line("K1 kernel-only maxIter=1", "kernel1_ms", kernel_only(1))
    line(f"K1 kernel-only maxIter={MAX_ITER}", "kernel20_ms",
         kernel_only(MAX_ITER))
    rep["kernel_per_iter_ms"] = ((rep["kernel20_ms"] - rep["kernel1_ms"])
                                 / (MAX_ITER - 1))
    print(f"  -> kernel per-iteration {rep['kernel_per_iter_ms']:.4f} ms")
    line("full wrapper maxIter=1", "full1_ms", lambda: decode(1))
    line(f"full wrapper maxIter={MAX_ITER}", "full20_ms",
         lambda: decode(MAX_ITER))
    rep["full_per_iter_ms"] = ((rep["full20_ms"] - rep["full1_ms"])
                               / (MAX_ITER - 1))
    rep["postprocess_ms"] = rep["full20_ms"] - rep["kernel20_ms"]
    out = decode(MAX_ITER)
    rep["converged20"] = int(out["converged"].sum())
    rep["mean_iters20"] = float((out["iterations"].float() + 1).mean())
    print(f"  -> full per-iteration {rep['full_per_iter_ms']:.4f} ms")
    print(f"  -> wrapper postprocess (full20 - kernel20) "
          f"{rep['postprocess_ms']:.3f} ms")
    print(f"  -> at maxIter={MAX_ITER}: {rep['converged20']}/{B} converged, "
          f"mean {rep['mean_iters20']:.2f} iterations run", flush=True)
    return rep


if __name__ == "__main__":
    main()
