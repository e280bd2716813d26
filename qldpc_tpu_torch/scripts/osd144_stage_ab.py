"""[[144,12,12]] staged-OSD A/B: does a narrow stage-1 prefix pay at the
headline scale?

Counterpart of the JAX package's ``scripts/osd144_stage_ab.py``. The
staged scan eliminates a narrow stage-1 prefix for every shot and rescans
at the full prefix width only the shots it leaves uncovered; it also packs
only the stage-1 width up front. This times the whole ``ops.osd.osd_batch``
(residual, ordering, G1's packs, the eliminator's scans, the basis rerun,
the order-2 reprocess, the readout) on one batch's K1 posteriors for each
stage-1 width of ``STAGE1`` (0: single-stage; a width at or past K is
skipped), every width on its own copy of the same posteriors, and prints
per width the least host ms of ``REPS`` synchronised calls and the sums
that must not depend on the width: the packed logical deltas, the valid
shots and the rank-deficient ones.

Usage (from the root of a checkout):

    python -m qldpc_tpu_torch.scripts.osd144_stage_ab [batch=1024]
        [maxIter=50] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import torch

from .. import resolve_device
from ..ops.bp_lift_cuda import decode_batch_lift_cuda
from ..ops.osd import osd_batch
from ..ops.sampler import trial_batch
from . import build, card_line, timed

CODE, P = "[[144, 12, 12]]", 0.004
STAGE1 = (0, 128, 192, 256, 320)
OSD_ORDER = 2
REPS = 4
SEED = 0


def kernel_posteriors(dz, n_locs: int, p: float, B: int, mi: int,
                      device) -> tuple:
    """(one batch's Z syndromes from seed ``SEED``, K1's result on them)
    for the Z decoder ``dz``."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    syn = trial_batch(gen, p, dz.maps, dz.maps, n_locs, B)["syndrome_z"]
    return syn, decode_batch_lift_cuda(dz.lifted, syn, dz.prior,
                                       dz.alpha_seq, mi)


def stage_run(dec, syndrome, values, hard, stage1: int, order: int,
              num_test: int) -> dict:
    """``osd_batch`` over every shot at stage-1 width ``stage1``."""
    return osd_batch(dec.H, dec.HT, syndrome, values, hard, K=dec.K,
                     order=order, num_test=num_test, rank=dec.rank,
                     basis_cols=dec.basis_cols,
                     logical_pack=dec.logical_pack, return_solution=False,
                     stage1_cols=stage1, col_index=dec.col_index)


def stage_sums(out) -> tuple:
    """(sum of the packed logical deltas, valid shots, rank-deficient
    shots) of an ``osd_batch`` result."""
    return (int(out["logical_delta_packed"].sum()), int(out["valid"].sum()),
            int(out["rank_deficient"].sum()))


def run_widths(dec, syn, bp, widths, order: int, num_test: int, reps: int,
               device, label: str = "osd_batch", width: int = 34) -> dict:
    """{stage-1 width: (delta-sum, valid, rank-deficient, ms)}, each width
    timed on its own clone of the same posteriors; printed as
    ``<label> stage1=<width>`` in a column ``width`` wide."""
    B = syn.shape[0]
    res = {}
    for s1 in widths:
        if s1 >= dec.K:
            continue
        s, v, h = syn.clone(), bp["values"].clone(), bp["hard"].clone()
        out, ms = timed(f"{label} stage1={s1 or 'off'}",
                        lambda: stage_run(dec, s, v, h, s1, order, num_test),
                        reps, device, width=width)
        d, ok, rd = stage_sums(out)
        res[s1] = (d, ok, rd, ms)
        pad = " " * (len(label) - len(label.lstrip()) + 2)
        print(f"{pad}delta-sum {d} valid {ok}/{B} rankdef {rd}", flush=True)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=1024)
    ap.add_argument("maxIter", nargs="?", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B, mi = args.batch, args.maxIter
    print(card_line(dev), flush=True)
    circ, _M, (dz,) = build(CODE, P, mi, OSD_ORDER, dev, which="Z")
    syn, bp = kernel_posteriors(dz, circ.num_error_locs, P, B, mi, dev)
    print(f"K={dz.K} rank={dz.rank} n={dz.H.shape[1]} m={dz.H.shape[0]}")
    conv = float(bp["converged"].sum()) / B
    print(f"kernel BP mi={mi}: converged {conv:.1%}", flush=True)
    return run_widths(dz, syn, bp, STAGE1, OSD_ORDER, dz.num_test, REPS, dev)


if __name__ == "__main__":
    main()
