"""NEGATIVE EXPERIMENT (not wired into any decode path): Cycle-periodic
("time-Toeplitz") layout for the min-sum BP decoder.

The port of the JAX package's ``scripts/bp_grid_experiment.py``, as
PyTorch ops on an explicit device.

The circuit-level decoding graphs are block-banded and periodic along the
syndrome-cycle axis: every fault-equivalence class (column of HdecZ/HdecX)
is a time-shifted copy of one of a small number of local *patterns*. For
the [[144,12,12]] graph at 12 cycles, the 8785 columns collapse to 720
patterns, each anchored at every cycle and spanning at most 2 adjacent
cycles (verified at build time, not assumed). Rows are (cycle t, check c)
with identical local neighborhoods for all interior t.

The JAX package's rationale, for the TPU: the two per-iteration gathers
that dominate BP cost there (its ops/bp.py uses one dynamic index per edge
— ~35k and ~53k gather rows of one batch-width each) become *static*
gathers with one index per LOCAL edge over arrays whose minor dims are
(cycle, batch): ~2.5k and ~4.3k gather rows, each T-times longer; gather
cost on the TPU is dominated by per-row overhead. On the card the port's
padded-CSR decoder (``ops/bp.py``) is bound by its launches instead (one
PyTorch op a launch), so :func:`main` times the two layouts side by side:

  messages   Q, R   : (n2, dr, T, B)   row-edge layout, cycle+batch minor
  posteriors V      : (nq, T, B)       pattern-grid layout
  col gather source U = [R ; shift(R, -1 cycle) ; ... ; zeros]  (o-stacked)
  row gather source W = [V ; shift(V, +1 cycle) ; ... ; zeros]

Boundary cycles are handled purely by masks (dead row edges) and dead grid
slots — the gather indices stay cycle-independent. Semantics are identical
to ``ops/bp.py::decode_batch`` (same flooding schedule, min1/min2, damping,
clipping, convergence freezing, the same check update and fused extrinsic
update); column-side summation order is preserved (row-ascending), so
float32 results match the padded-CSR layout bit for bit on the CPU. On the
card PyTorch's reductions may order the column sums otherwise, so there
hard decisions, convergence and iterations are held equal and the values'
largest difference is reported. Tie-breaking in the check update's argmin
needs no ordering guarantee: when |Q| ties at the row minimum, min1 ==
min2 and every edge receives the same magnitude regardless of which slot
argmin selects.

Usage (from the root of a checkout):

    python -m qldpc_tpu_torch.scripts.bp_grid_experiment [code]
        [p=0.004] [batch=512] [maxIter=20] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from .. import channel_llrs, get_code, resolve_device
from ..ops import bp as tbp
from ..ops.bp import _BIG, TannerGraph, alpha_schedule, decode_batch
from . import card_line, timed
from .bp_breakdown import cached_matrices
from .bp_microbench import device_profile

REPS = 5
SEED = 0


@dataclasses.dataclass(frozen=True)
class PeriodicGraph:
    """Static cycle-periodic structure of a decoding matrix (tensors on
    one device).

    Build with :func:`try_from_dense`; ``None`` means the matrix is not
    (cleanly) periodic and the padded-CSR ``TannerGraph`` should be used.
    """

    row_src: torch.Tensor    # (n2, dr) int64 index into W's first axis
                             #   (o * nq + q; pad = S1 * nq, a zero row)
    row_mask: torch.Tensor   # (n2, dr, T) bool — per-cycle edge liveness
    col_src: torch.Tensor    # (nq, dc) int64 index into U's first axis
                             #   (o * n2 * dr + c * dr + slot; pad = dead)
    prior_grid: torch.Tensor  # (nq, T) f32 — channel LLRs on the grid
                              #   (dead slots hold +50)
    out_gather: torch.Tensor  # (n,) int64 index into V.reshape(nq*T, B)
    residual: torch.Tensor    # (n,) bool — cols outside the grid (edge-free)
    n2: int               # checks per cycle
    T: int                # row cycles
    nq: int               # patterns
    dr: int               # max local row degree
    dc: int               # max pattern size
    S1: int               # number of distinct cycle offsets (span + 1)
    n: int
    m: int

    @staticmethod
    def try_from_dense(H: np.ndarray, n2: int, prior: np.ndarray,
                       max_span: int = 3, device=None):
        """Detect the periodic structure of ``H`` (rows = cycle-major
        syndrome bits, ``n2`` per cycle). Returns a PeriodicGraph on
        ``device``, or None when the matrix does not decompose into
        cycle-shifted column patterns (each grid slot occupied at most
        once, span <= max_span, residual columns edge-free)."""
        dev = resolve_device(device)
        H = np.asarray(H) != 0
        m, n = H.shape
        if n2 <= 0 or m % n2:
            return None
        T = m // n2
        if T < 2:
            return None
        patterns: dict = {}          # key -> q
        pat_edges: list = []         # q -> tuple of (offset, check)
        col_anchor = np.full(n, -1, np.int64)
        col_q = np.full(n, -1, np.int64)
        residual = np.zeros(n, bool)
        for j in range(n):
            rows = np.nonzero(H[:, j])[0]
            if rows.size == 0:
                residual[j] = True
                continue
            cyc = rows // n2
            a = int(cyc.min())
            off = cyc - a
            if off.max() >= max_span:
                return None
            key = (tuple(off.tolist()), tuple((rows % n2).tolist()))
            q = patterns.get(key)
            if q is None:
                q = patterns[key] = len(pat_edges)
                pat_edges.append(tuple(zip(off.tolist(),
                                           (rows % n2).tolist())))
            col_anchor[j] = a
            col_q[j] = q
        nq = len(pat_edges)
        if nq == 0 or nq * T > 4 * n:  # grid too sparse to pay off
            return None
        S1 = 1 + max(max(o for o, _ in e) for e in pat_edges)
        # grid occupancy: each (anchor, pattern) at most one column
        grid_col = np.full((T, nq), -1, np.int64)
        live = ~residual
        a_l, q_l, j_l = col_anchor[live], col_q[live], np.nonzero(live)[0]
        if np.unique(a_l * nq + q_l).size != j_l.size:
            return None
        grid_col[a_l, q_l] = j_l

        # row slot assignment: for each check c, the (offset, q) edge list
        # (cycle-independent); slots ordered (offset desc, q asc)
        row_edges = [[] for _ in range(n2)]
        for q, edges in enumerate(pat_edges):
            for o, c in edges:
                row_edges[c].append((o, q))
        for c in range(n2):
            row_edges[c].sort(key=lambda e: (-e[0], e[1]))
        dr = max(1, max(len(e) for e in row_edges))
        row_src = np.full((n2, dr), S1 * nq, np.int64)       # pad: zero row
        row_mask = np.zeros((n2, dr, T), bool)
        slot_of = {}
        t_idx = np.arange(T)
        for c in range(n2):
            for s, (o, q) in enumerate(row_edges[c]):
                row_src[c, s] = o * nq + q
                slot_of[(o, c, q)] = s
                # edge lives at cycle t iff column (t - o, q) is real
                a = t_idx - o
                ok = (a >= 0) & (a < T)
                ok[ok] = grid_col[a[ok], q] >= 0
                row_mask[c, s] = ok

        # column slots: pattern q's edges ordered by row index (offset asc,
        # check asc) so the posterior summation order matches the padded-CSR
        # layout (and the reference) bit for bit in float32
        dc = max(1, max(len(e) for e in pat_edges))
        col_src = np.full((nq, dc), S1 * n2 * dr, np.int64)  # pad: zero row
        for q, edges in enumerate(pat_edges):
            for s, (o, c) in enumerate(sorted(edges)):
                col_src[q, s] = o * (n2 * dr) + c * dr + slot_of[(o, c, q)]

        prior = np.asarray(prior, np.float32)
        prior_grid = np.full((nq, T), 50.0, np.float32)   # dead slots: +50
        tt, qq = np.nonzero(grid_col >= 0)
        prior_grid[qq, tt] = prior[grid_col[tt, qq]]

        out_gather = np.zeros(n, np.int64)
        out_gather[live] = col_q[live] * T + col_anchor[live]

        def t(a):
            return torch.as_tensor(a, device=dev)

        return PeriodicGraph(
            row_src=t(row_src), row_mask=t(row_mask), col_src=t(col_src),
            prior_grid=t(prior_grid), out_gather=t(out_gather),
            residual=t(residual),
            n2=n2, T=T, nq=nq, dr=dr, dc=dc, S1=S1, n=n, m=m)


def _shift_stack_V(V, g: PeriodicGraph):
    """W (S1*nq + 1, T, B): slab o holds V shifted so W[o*nq+q, t] =
    V[q, t-o]; final row is zeros (gather pad)."""
    nq, T, B = V.shape
    slabs = [V]
    for o in range(1, g.S1):
        slabs.append(torch.nn.functional.pad(V[:, :T - o], (0, 0, o, 0)))
    slabs.append(V.new_zeros((1, T, B)))
    return torch.cat(slabs, 0)


def _shift_stack_U(R_flat, g: PeriodicGraph):
    """U (S1*n2*dr + 1, T, B): slab o holds R shifted so
    U[o*E + e, a] = R[e, a+o]; final row zeros (gather pad)."""
    E, T, B = R_flat.shape
    slabs = [R_flat]
    for o in range(1, g.S1):
        slabs.append(torch.nn.functional.pad(R_flat[:, o:], (0, 0, 0, o)))
    slabs.append(R_flat.new_zeros((1, T, B)))
    return torch.cat(slabs, 0)


def _check_update_grid(Q, sgn_syn, alpha):
    """Min-sum check update; Q (n2, dr, T, B), sgn_syn (n2, T, B): the
    padded-CSR decoder's (``ops/bp.py::_check_update``) over the dr axis
    with (cycle, batch) flattened. Returns (R, coef, mag), R = coef * mag."""
    n2, dr, T, B = Q.shape
    R, coef, mag = tbp._check_update(Q.reshape(n2, dr, T * B),
                                     sgn_syn.reshape(n2, T * B), alpha,
                                     parts=True)
    return R.reshape(Q.shape), coef.reshape(Q.shape), mag.reshape(Q.shape)


def _variable_update_grid(R, g: PeriodicGraph, mask4):
    """R (n2, dr, T, B) -> (values (nq, T, B) f32, vals_rows (n2, dr, T,
    B)): each posterior the prior plus R summed over its pattern's slots in
    slot order in float32, as the padded-CSR decoder sums a column."""
    n2, dr, T, B = R.shape
    R_flat = torch.where(mask4, R, torch.zeros((), dtype=R.dtype,
                                               device=R.device))
    U = _shift_stack_U(R_flat.reshape(n2 * dr, T, B), g)
    R_cols = U.index_select(0, g.col_src.reshape(-1)).reshape(g.nq, g.dc,
                                                              T, B)
    acc = R_cols[:, 0].float()
    for d in range(1, g.dc):
        acc = acc + R_cols[:, d].float()
    values = g.prior_grid[:, :, None] + acc
    W = _shift_stack_V(values.to(R.dtype), g)
    vals_rows = W.index_select(0, g.row_src.reshape(-1))
    return values, vals_rows.reshape(n2, dr, T, B)


def decode_batch_grid(g: PeriodicGraph, syndrome, prior, alpha_seq,
                      maxIter: int, damping: float = 1.0,
                      clip_llr: float = 20.0, msg_dtype=torch.float32):
    """Drop-in equivalent of ``ops.bp.decode_batch`` on a PeriodicGraph.

    Same arguments and returns (syndrome (B, m), outputs in the original
    column order); float32 results are bit-identical to the padded-CSR
    layout on the CPU. One host read an iteration for the exit, as there.
    """
    dev, dt = syndrome.device, msg_dtype
    B = syndrome.shape[0]
    # (B, m) -> (n2, T, B); row index = t * n2 + c
    syn = (syndrome.reshape(B, g.T, g.n2).permute(2, 1, 0)
           .to(torch.int32).contiguous())
    sgn_syn = 1.0 - 2.0 * syn.to(torch.float32)
    prior = prior.to(device=dev, dtype=torch.float32)
    alpha_seq = torch.as_tensor(alpha_seq, device=dev).to(torch.float32)
    mask4 = g.row_mask[:, :, :, None]
    big = torch.tensor(_BIG, dtype=dt, device=dev)
    d_new = torch.tensor(damping, dtype=dt, device=dev)
    d_old = torch.tensor(1.0 - damping, dtype=dt, device=dev)

    pg = g.prior_grid[:, :, None].to(dt).expand(g.nq, g.T, B)
    Q = _shift_stack_V(pg, g).index_select(0, g.row_src.reshape(-1))
    Q = torch.where(mask4, Q.reshape(g.n2, g.dr, g.T, B), big)
    Qold = Q
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    vals = torch.zeros((g.nq, g.T, B), dtype=torch.float32, device=dev)
    iters = torch.full((B,), maxIter - 1, dtype=torch.int32, device=dev)
    for it in range(maxIter):
        if bool(done.all()):
            break
        R, coef, mag = _check_update_grid(Q, sgn_syn, alpha_seq[it])
        values, vals_rows = _variable_update_grid(R, g, mask4)
        Q_new = torch.clamp(tbp._fused_sub(vals_rows, coef, mag),
                            -clip_llr, clip_llr)
        if damping != 1.0:
            Q_new = torch.clamp(tbp._fused_mix(d_new, Q_new, d_old, Qold),
                                -clip_llr, clip_llr)
        Q = torch.where(mask4, Q_new, big)
        hard_rows = (vals_rows < 0.0) & mask4
        parity = hard_rows.sum(1) & 1                          # (n2, T, B)
        ok = (parity == syn).all(0).all(0)                     # (B,)
        vals = torch.where(done[None, None, :], vals, values)
        iters = torch.where(ok & ~done, it, iters)
        done = done | ok
        if damping != 1.0:
            Qold = Q

    # grid -> original column order; residual (edge-free) cols keep prior
    flat = vals.reshape(g.nq * g.T, B)
    vals_n = flat.index_select(0, g.out_gather)                # (n, B)
    vals_n = torch.where(g.residual[:, None], prior[:, None], vals_n)
    return dict(hard=(vals_n < 0.0).to(torch.int8).T.contiguous(),
                converged=done, values=vals_n.T.contiguous(),
                iterations=iters)


def iterations_run(out, maxIter: int) -> int:
    """The iterations a decode ran: to the last shot's convergence, else
    all ``maxIter``."""
    if bool(out["converged"].all()):
        return int(out["iterations"].max()) + 1
    return maxIter


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("code", nargs="?", default="[[144, 12, 12]]")
    ap.add_argument("p", nargs="?", type=float, default=0.004)
    ap.add_argument("batch", nargs="?", type=int, default=512)
    ap.add_argument("maxIter", nargs="?", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B, mi = args.batch, args.maxIter
    print(card_line(dev), flush=True)
    code = get_code(args.code)
    cycles = code.distance
    _circ, M = cached_matrices(code, cycles, args.p)
    H = (np.asarray(M["HdecZ"]) != 0).astype(np.uint8)
    prior_np = channel_llrs(M["channel_probsZ"]).astype(np.float32)
    g = PeriodicGraph.try_from_dense(H, H.shape[0] // (cycles + 2),
                                     prior_np, device=dev)
    if g is None:
        raise RuntimeError(f"{args.code}'s basis-Z graph is not periodic")
    graph = TannerGraph.from_dense(H, device=dev)
    prior = torch.as_tensor(prior_np, device=dev)
    seq = torch.as_tensor(alpha_schedule("dynamical", mi), device=dev)
    rng = np.random.default_rng(SEED)
    errors = (rng.random((B, H.shape[1])) < M["channel_probsZ"]).astype(
        np.int64)
    syn = torch.as_tensor((errors @ H.T) % 2, dtype=torch.int8, device=dev)
    print(f"{args.code} p={args.p} B={B} maxIter={mi} H={H.shape}: "
          f"padded CSR dr={graph.dr} dc={graph.dc}; grid T={g.T} n2={g.n2} "
          f"nq={g.nq} dr={g.dr} dc={g.dc} S1={g.S1}", flush=True)
    rows = {}
    outs = {}
    for name, fn in (
            ("padded-CSR decode_batch f32",
             lambda: decode_batch(graph, syn, prior, seq, mi)),
            ("grid decode_batch_grid f32",
             lambda: decode_batch_grid(g, syn, prior, seq, mi))):
        outs[name], ms = timed(name, fn, REPS, dev, stat="mean", width=44)
        its = iterations_run(outs[name], mi)
        launches, busy = device_profile(fn, dev)
        rows[name] = dict(ms=ms, iterations=its, ms_per_iter=ms / its,
                          launches_per_iter=(None if launches is None
                                             else launches / its),
                          busy_ms_per_iter=(None if busy is None
                                            else busy / its))
        prof = ("" if launches is None else
                f", {launches / its:.1f} launches and {busy / its:.4f} ms "
                f"device busy an iteration")
        print(f"    {ms / its:.4f} ms an iteration over {its} "
              f"iterations{prof}", flush=True)
    a, b = outs.values()
    for key in ("hard", "converged", "iterations"):
        if not torch.equal(a[key], b[key]):
            raise RuntimeError(f"the grid layout's {key} differs from "
                               "padded CSR")
    diff = float((a["values"] - b["values"]).abs().max())
    print(f"hard, converged and iterations identical; values differ by at "
          f"most {diff:g}; converged {int(a['converged'].sum())}/{B}",
          flush=True)
    return dict(rows=rows, max_value_diff=diff,
                converged=int(a["converged"].sum()))


if __name__ == "__main__":
    main()
