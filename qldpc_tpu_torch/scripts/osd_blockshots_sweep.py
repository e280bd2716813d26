"""Sweep the eliminator's shots a block on real BP-failed shots.

Counterpart of the JAX package's ``scripts/osd_blockshots_sweep.py``:
[[144,12,12]] at p=0.004 (its distance in cycles), basis Z, one batch of
B=512 shots (``osd144_stage_ab.SEED``), K1's posteriors at maxIter 20,
the shots sorted unconverged first by residual weight (engine-style),
then the whole ``ops.osd.osd_batch`` (OSD order 2) in 8 chunks of 64, as
the engine chunks its pool. ``osd_cuda.pick_block_shots`` is patched to give
each value of the sweep at every eliminator site, as the JAX script
patches ``osd_pallas.pick_block_shots``; the card's range is 1, 2, 4 and 8
shots a block (K5, ``QLDPC_OSD_KERNEL=3``, also 16: two shots a team).
Prints per value JAX's line (mean host ms of ``REPS`` synchronised runs)
and, on the card, the shots a block each width's launch takes after the
plan's clamps; checks that the consumed outputs (the packed logical
deltas, validity) are identical across values.

On the card a block's shots change how the launch packs the SMs, not
where a shot exits: each shot exits on its own (ops/osd_cuda.py), where
JAX's block exits at its deepest shot, which is what its sweep measured.

Usage (from the root of a checkout):

    python -m qldpc_tpu_torch.scripts.osd_blockshots_sweep
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import torch

from .. import resolve_device
from ..ops import osd_cuda
from ..ops.osd import auto_stage1, osd_batch
from . import build, card_line, timed
from .osd144_stage_ab import kernel_posteriors

CODE, P, B, MAXITER, OSD_ORDER = "[[144, 12, 12]]", 0.004, 512, 20, 2
CHUNK = 64  # engine chunking: 8 chunks of 64
REPS = 10


def sweep_values(kernel: str) -> tuple:
    """The shots a block swept for eliminator ``kernel``: up to the eight
    teams a block's named barriers allow."""
    return (1, 2, 4, 8, 16) if kernel == "K5" else (1, 2, 4, 8)


def widths(dec) -> dict:
    """The eliminator launches' widths in words of ``osd_batch`` on
    decoder ``dec``: stage 1 (when staged), the prefix, the basis rerun."""
    K, KT = dec.K, dec.K + len(dec.basis_cols)
    out = {"prefix": -(-K // 32), "full": -(-KT // 32)}
    if auto_stage1(K):
        out = {"stage1": -(-auto_stage1(K) // 32), **out}
    return out


def plans(dec, B: int, device, block_shots=None, smem_budget=None) -> dict:
    """{width name: (shots a block, where the columns live)} of the
    selected eliminator's launch of B shots at each of ``widths(dec)``, as
    the library plans it (None on the CPU)."""
    if device.type != "cuda":
        return None
    m = dec.H.shape[0]
    out = {}
    for name, W in widths(dec).items():
        info = osd_cuda.elim_launch_info(B, W, m, device,
                                         osd_cuda.selected_kernel(),
                                         block_shots, smem_budget)
        out[name] = (info["shots_per_block"], info["columns_in"])
    return out


def sorted_failed(dec, syn, bp):
    """(syndromes, posteriors, hard decisions) sorted unconverged first by
    residual weight (stable), the engine's order."""
    res_wt = osd_cuda.bp_residual(syn, bp["hard"], dec.HT,
                                  dec.col_index)[1]
    order = torch.sort(torch.where(bp["converged"], 10000, res_wt),
                       stable=True).indices
    return syn[order], bp["values"][order], bp["hard"][order]


def chunked(dec, s, v, h, chunk: int) -> tuple:
    """``osd_batch`` (order 2) over ``chunk``-shot chunks; returns the
    consumed outputs (packed logical deltas, valid), concatenated."""
    deltas, valid = [], []
    for c0 in range(0, len(s), chunk):
        out = osd_batch(dec.H, dec.HT, s[c0:c0 + chunk], v[c0:c0 + chunk],
                        h[c0:c0 + chunk], K=dec.K, order=OSD_ORDER,
                        num_test=dec.num_test, rank=dec.rank,
                        basis_cols=dec.basis_cols,
                        logical_pack=dec.logical_pack, return_solution=False,
                        col_index=dec.col_index)
        deltas.append(out["logical_delta_packed"])
        valid.append(out["valid"])
    return torch.cat(deltas), torch.cat(valid)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    circ, _M, (dz,) = build(CODE, P, MAXITER, OSD_ORDER, dev, which="Z")
    syn, bp = kernel_posteriors(dz, circ.num_error_locs, P, B, MAXITER, dev)
    conv = float(bp["converged"].sum()) / B
    print(f"BP converged {conv:.1%}; sweeping eliminator block size on the "
          f"sorted unconverged batch", flush=True)
    s, v, h = sorted_failed(dz, syn, bp)
    kernel = osd_cuda.selected_kernel()
    orig_pick = osd_cuda.pick_block_shots
    res, ref = {}, None
    try:
        for S in sweep_values(kernel):
            osd_cuda.pick_block_shots = (
                lambda M, W, smem_budget=None, cap=None, kernel=None, S=S: S)
            out, ms = timed(f"osd_batch {B // CHUNK}x{CHUNK} chunks, "
                            f"block_shots={S:2d}",
                            lambda: chunked(dz, s, v, h, CHUNK), REPS, dev,
                            stat="mean", width=52)
            taken = plans(dz, CHUNK, dev, block_shots=S)
            if taken is not None:
                print("    shots a block taken (" + kernel + "): " + ", ".join(
                    f"{w} {spb} ({where})"
                    for w, (spb, where) in taken.items()), flush=True)
            if ref is None:
                ref = out
            elif not all(torch.equal(a, b) for a, b in zip(out, ref)):
                raise RuntimeError(f"block_shots={S} changed a consumed "
                                   "output (logical delta or validity)")
            res[S] = dict(ms=ms, taken=taken,
                          delta_sum=int(out[0].sum()),
                          valid=int(out[1].sum()))
    finally:
        osd_cuda.pick_block_shots = orig_pick
    print(f"consumed outputs identical across block_shots "
          f"{sorted(res)} ({kernel}): delta-sum {res[1]['delta_sum']}, "
          f"valid {res[1]['valid']}/{B}", flush=True)
    return res


if __name__ == "__main__":
    main()
