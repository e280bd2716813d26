"""[[288,12,18]] staged-OSD tail block A/B: the tail budget.

Counterpart of the JAX package's ``scripts/osd288_tailblock_ab.py``, which
times ``osd_batch`` under ``QLDPC_OSD_TAIL_MB`` 26 and 78, the VMEM budget
its staged tail and basis rerun size their shot blocks against. The port's
counterpart is ``QLDPC_OSD_TAIL_SMEM_KB``, the shared memory a block of
those launches may take for its teams' columns (``ops/osd.py``,
``osd_batch``): this times the whole ``ops.osd.osd_batch`` (OSD-0) on one
batch's K1 posteriors ([[288,12,18]] at its distance in cycles, p=0.005,
basis Z, B=256, maxIter 200) under the default (the variable unset: the
plan's own rule), a budget of one team's columns at the tail's width, and
each of ``--budgets-kb`` (one below a team reaches the device-memory
branch), in one process: the budget is read when ``osd_batch`` is called,
so no rebuild is needed between them. Prints per budget the shots a block
and where the columns live of the tail's and the basis rerun's launches
(on the card, as the library plans them), and the best of ``REPS`` host ms
with the device synchronised; checks that the consumed outputs (logical
deltas, validity, rank deficiency) are identical across budgets.

On the card a block holds at most ~227 KB; at [[288]] one team's columns
at the tail's width exceed it, so every budget there runs the tail in
device memory.

Usage (from the root of a checkout):

    python -m qldpc_tpu_torch.scripts.osd288_tailblock_ab [batch=256]
        [maxiter=200] [--budgets-kb KB ...] [--code CODE]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch

from .. import resolve_device
from ..ops import osd_cuda
from ..ops.osd import TAIL_BUDGET_ENV, osd_batch
from . import build, card_line
from .osd144_stage_ab import kernel_posteriors
from .osd_blockshots_sweep import widths

CODE, P = "[[288, 12, 18]]", 0.005
REPS = 4


@contextlib.contextmanager
def tail_budget(kb):
    """``QLDPC_OSD_TAIL_SMEM_KB`` set to ``kb`` (None: unset) inside the
    block, restored after it."""
    saved = os.environ.pop(TAIL_BUDGET_ENV, None)
    if kb is not None:
        os.environ[TAIL_BUDGET_ENV] = str(kb)
    try:
        yield
    finally:
        os.environ.pop(TAIL_BUDGET_ENV, None)
        if saved is not None:
            os.environ[TAIL_BUDGET_ENV] = saved


def osd_small(dec, syn, bp) -> tuple:
    """The whole OSD-0 ``osd_batch``; its consumed outputs (packed logical
    deltas, valid, rank_deficient)."""
    rr = osd_batch(dec.H, dec.HT, syn, bp["values"], bp["hard"], K=dec.K,
                   order=0, num_test=0, rank=dec.rank,
                   basis_cols=dec.basis_cols, logical_pack=dec.logical_pack,
                   return_solution=False, col_index=dec.col_index)
    return rr["logical_delta_packed"], rr["valid"], rr["rank_deficient"]


def tail_plans(dec, B: int, kb, device) -> dict:
    """{launch: (shots a block asked, taken, where the columns live)} of the
    tail's (the prefix width) and the basis rerun's launches of B shots
    under a tail budget of ``kb`` KB (None: the plan's own rule); taken and
    where are None on the CPU."""
    m = dec.H.shape[0]
    budget = None if kb is None else kb * 1024
    out = {}
    for name, W in widths(dec).items():
        if name == "stage1":
            continue
        asked = osd_cuda.pick_block_shots(m, W, smem_budget=budget)
        taken = where = None
        if device.type == "cuda":
            info = osd_cuda.elim_launch_info(B, W, m, device,
                                             osd_cuda.selected_kernel(),
                                             asked, budget)
            taken, where = info["shots_per_block"], info["columns_in"]
        out["tail" if name == "prefix" else "basis rerun"] = (asked, taken,
                                                              where)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=256)
    ap.add_argument("maxiter", nargs="?", type=int, default=200)
    ap.add_argument("--budgets-kb", type=int, nargs="*", default=[])
    ap.add_argument("--code", default=CODE)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B, mi = args.batch, args.maxiter
    print(card_line(dev), flush=True)
    circ, _M, (dz,) = build(args.code, P, mi, 0, dev, which="Z")
    syn, bp = kernel_posteriors(dz, circ.num_error_locs, P, B, mi, dev)
    conv = float(bp["converged"].sum()) / B
    print(f"kernel BP mi={mi}: converged {conv:.1%}", flush=True)
    one_team = -(-osd_cuda.team_bytes(dz.H.shape[0], -(-dz.K // 32)) // 1024)
    budgets = {"default": None, f"{one_team}KB (one team)": one_team}
    budgets.update({f"{kb}KB": kb for kb in args.budgets_kb})

    outs = {}
    for label, kb in budgets.items():
        with tail_budget(kb):
            outs[label] = osd_small(dz, syn, bp)
        plan = tail_plans(dz, B, kb, dev)
        print(f"tail budget {label}: " + "; ".join(
            f"{name} block_shots {asked}"
            + ("" if taken is None else f", {taken} a block in {where}")
            for name, (asked, taken, where) in plan.items()), flush=True)
    ref = outs["default"]
    if not all(torch.equal(a, b) for out in outs.values()
               for a, b in zip(out, ref)):
        raise RuntimeError("tail budget changed a consumed output")
    print("outputs identical across tail budgets", flush=True)

    best = {label: float("inf") for label in budgets}
    for _ in range(REPS):
        for label, kb in budgets.items():
            with tail_budget(kb):
                t0 = time.perf_counter()
                osd_small(dz, syn, bp)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                best[label] = min(best[label], time.perf_counter() - t0)
    for label in budgets:
        print(f"tail budget {label}: full osd_batch "
              f"{best[label] * 1e3:8.2f} ms", flush=True)
    for label in list(budgets)[1:]:
        print(f"speedup {label} vs default: "
              f"{best['default'] / best[label]:.2f}x", flush=True)
    return dict(best_ms={k: v * 1e3 for k, v in best.items()},
                one_team_kb=one_team,
                valid=int(ref[1].sum()), rank_deficient=int(ref[2].sum()))


if __name__ == "__main__":
    main()
