"""OSD stage costs on real BP-failed posteriors.

Counterpart of the JAX package's ``scripts/osd_microbench.py``: one
batch's padded-CSR BP posteriors (``ops/bp.py``, bfloat16 messages,
maxIter 20, as the JAX script's ``decode_batch``), then each OSD sub-stage
alone:

* the reliability sort of |LLR| (B, n);
* G1 (``osd_cuda.gather_pack``), the K-column prefix packed into the
  eliminators' column bitsets;
* the eliminator (K2, or K4 / K5 under ``QLDPC_OSD_KERNEL``) on the prefix
  alone and on the prefix with the column basis appended, each with and
  without the validity exit, with the valid shots each finds (the same
  with and without the exit);
* the whole ``ops.osd.osd_batch`` (order 2, with the solution);
* the cumulative prefixes of ``osd_batch`` as the engine calls it (the
  logical delta, no solution), as the JAX package's
  ``scripts/osd_breakdown.py`` times its own: the residual matmul, + the
  sort, + stage 1 (G1 and the eliminator), + the staged tail's sort,
  launches and merge, + the basis rerun's sort, launches and merge, + the
  order-2 reprocess, + the readout (the whole call). Each line gives the
  prefix and its difference from the one before, the stage's cost.

On the card the sort, G1 and ``osd_batch`` are the mean of ``REPS`` calls
between CUDA events, and the eliminator its launch alone
(``scripts.eliminate``); on the CPU every time is the host's. The JAX
script's transposed-gather variant was a TPU layout experiment and has no
counterpart.

Usage (from the root of a checkout):

    python -m qldpc_tpu_torch.scripts.osd_microbench [code] [p=0.004]
        [batch=512] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import torch

from .. import resolve_device
from ..ops import osd_cuda
from ..ops.bp import decode_batch
from ..ops.osd import PREFIXES, osd_batch
from ..ops.sampler import trial_batch
from . import (build, card_line, device_ms, eliminate, residual_order,
               unsatisfied)

MAX_ITER, OSD_ORDER = 20, 2
REPS = 5
SEED = 0


def elimination_cases(dec, order) -> list:
    """[(label, columns (B, Kx), Kx)]: the prefix alone, and the prefix
    with the column basis appended (``osd_batch``'s basis rerun)."""
    colsK = order[:, :dec.K]
    B, R = colsK.shape[0], dec.basis_cols.numel()
    full = torch.cat([colsK, dec.basis_cols[None].expand(B, R)], 1)
    return [("prefix-only", colsK, dec.K), ("prefix+basis", full, dec.K + R)]


def valid_counts(dec, order, residual, reps: int, device) -> dict:
    """{(label, exit_on_valid): (valid shots, the eliminator's ms)} of
    :func:`elimination_cases`."""
    m = dec.H.shape[0]
    out = {}
    for label, cols, Kx in elimination_cases(dec, order):
        for ev in (False, True):
            s_red, used, _cf, ms = eliminate(dec, cols, residual, Kx, ev,
                                             reps, device)
            out[(label, ev)] = (int((unsatisfied(s_red, used, m) == 0)
                                    .sum()), ms)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("code", nargs="?", default="[[144, 12, 12]]")
    ap.add_argument("p", nargs="?", type=float, default=0.004)
    ap.add_argument("batch", nargs="?", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B, p = args.batch, args.p
    print(card_line(dev), flush=True)
    circ, _M, (dz,) = build(args.code, p, MAX_ITER, OSD_ORDER, dev,
                            which="Z")
    m, n = dz.H.shape
    K = dz.K
    print(f"{args.code} p={p} B={B} m={m} n={n} K={K} rank={dz.rank} "
          f"basis={dz.basis_cols.numel()} eliminator "
          f"{osd_cuda.selected_kernel()}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    syn = trial_batch(gen, p, dz.maps, dz.maps, circ.num_error_locs,
                      B)["syndrome_z"]
    bp = decode_batch(dz.graph, syn, dz.prior, dz.alpha_seq, MAX_ITER,
                      msg_dtype=torch.bfloat16)
    vals, hard = bp["values"], bp["hard"]
    print(f"BP convergence: {float(bp['converged'].float().mean()):.2%}",
          flush=True)
    residual, order = residual_order(dz, syn, vals, hard)
    rep = {}

    def line(name, key, ms):
        rep[key] = ms
        print(f"{name:44s} {ms:9.2f} ms", flush=True)

    line("argsort |llr| (B, n)", "sort_ms", device_ms(
        lambda: torch.sort(vals.abs(), dim=1, stable=True), REPS, dev))
    Kp = -(-K // 32) * 32
    line("G1 gather+pack K cols", "g1_ms", device_ms(
        lambda: osd_cuda.gather_pack(dz.col_index, order[:, :K], Kp), REPS,
        dev))
    for (label, ev), (valid, ms) in valid_counts(dz, order, residual, REPS,
                                                 dev).items():
        W = -(-(K if label == "prefix-only"
                else K + dz.basis_cols.numel()) // 32)
        tag = "valid-exit" if ev else "full-scan "
        line(f"eliminate {label} W={W:3d} {tag}", f"{label}_{tag.strip()}",
             ms)
        rep[f"{label}_{tag.strip()}_valid"] = valid
        print(f"    valid {valid}/{B}", flush=True)
    line("osd_batch (order=2)", "osd_batch_ms", device_ms(
        lambda: osd_batch(dz.H, dz.HT, syn, vals, hard, K=K, order=OSD_ORDER,
                          num_test=dz.num_test, rank=dz.rank,
                          basis_cols=dz.basis_cols,
                          col_index=dz.col_index)["solution"], REPS, dev))
    rep["prefix_ms"] = prefixes(dz, syn, vals, hard, dev)
    return rep


def prefixes(dec, syn, vals, hard, device) -> dict:
    """{stage: (prefix ms, its difference from the previous prefix)} of
    ``osd_batch`` as the engine calls it, the prefixes of
    ``ops.osd.PREFIXES`` and then the whole call ("readout")."""
    out, prev = {}, 0.0
    for stop in PREFIXES + (None,):
        ms = device_ms(lambda: osd_batch(
            dec.H, dec.HT, syn, vals, hard, K=dec.K, order=OSD_ORDER,
            num_test=dec.num_test, rank=dec.rank, basis_cols=dec.basis_cols,
            logical_pack=dec.logical_pack, return_solution=False,
            col_index=dec.col_index, stop_after=stop), REPS, device)
        name = stop or "readout"
        out[name] = (ms, ms - prev)
        print(f"{'osd_batch through ' + name:44s} {ms:9.2f} ms   "
              f"delta {ms - prev:8.2f} ms", flush=True)
        prev = ms
    return out


if __name__ == "__main__":
    main()
