"""[[288,12,18]] staged-OSD A/B: stage-1 width x BP maxIter, one session.

Counterpart of the JAX package's ``scripts/osd288_ab.py``: the whole
``ops.osd.osd_batch`` (OSD-0: the residual, ordering, G1's packs, the
eliminator's staged or single scan, the basis rerun, the readout) timed on
one batch's K1 posteriors for each stage-1 width of ``STAGE1`` (0:
single-stage) and each BP maxIter of ``MAX_ITERS``: more BP iterations
may order the columns better (earlier validity exits, fewer shots left
uncovered by stage 1). Each width runs on its own copy of the same
posteriors. Prints per configuration the least host ms of ``REPS``
synchronised calls, the valid and rank-deficient shots, and per maxIter
the peak device memory on the card.

Usage (from the root of a checkout):

    python -m qldpc_tpu_torch.scripts.osd288_ab [batch=256]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

from .. import resolve_device
from . import bases, build, card_line, peak_gib, reset_peak
from .osd144_stage_ab import kernel_posteriors, run_widths

CODE, P = "[[288, 12, 18]]", 0.005
MAX_ITERS = (50, 100, 200)
STAGE1 = (0, 768, 1536)
REPS = 3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B = args.batch
    print(card_line(dev), flush=True)
    circ = M = None
    out = {}
    for mi in MAX_ITERS:
        reset_peak(dev)
        if M is None:
            circ, M, (dz,) = build(CODE, P, mi, 0, dev, which="Z")
        else:
            (dz,) = bases(circ, M, mi, 0, dev, which="Z")
        syn, bp = kernel_posteriors(dz, circ.num_error_locs, P, B, mi, dev)
        conv = float(bp["converged"].sum()) / B
        print(f"--- kernel BP mi={mi}: converged {conv:.1%}", flush=True)
        out[mi] = run_widths(dz, syn, bp, STAGE1, 0, 0, REPS, dev,
                             label="  osd", width=44)
        peak = peak_gib(dev)
        if peak is not None:
            print(f"    peak device memory {peak:.2f} GiB", flush=True)
    return out


if __name__ == "__main__":
    main()
