"""Lifted (circulant-structured) layout for the min-sum BP decoder.

The circuit-level decoding graphs of BB codes are full *lifts* of a tiny base
graph by the code's Z_ell x Z_m translation group crossed with time: every
fault-equivalence class (column of HdecZ/HdecX) is a (translation,
time-shift) copy of one of ~10 base patterns, and the checks of one cycle
form a single translation orbit (check c = x*m + y). Verified at build time,
never assumed; see ``LiftedGraph.try_from_dense``.

  messages Q     : (EB, ell, m, T, B)   EB = base-graph edge slots (~35)
  posteriors V   : (NB, ell, m, T, B)   NB = base patterns (~10)
  syndrome       : (ell, m, T, B)

An edge slot eb = (base pattern pb, offset o, rep-check (cx, cy)) connects
column (pb, gx, gy, a) to check (gx+cx, gy+cy, a+o).

``decode_batch_lift`` (flooding, with damping and bfloat16 messages) and
``decode_batch_lift_layered`` (the time-layered schedule) are the
roll-based PyTorch twins of the JAX package's XLA lifts; the CUDA kernels and their gather-based plain versions
live in ops/bp_lift_cuda.py (flooding) and ops/bp_lift_layered_cuda.py
(layered). Algorithm: normalized min-sum, per-iteration (per-sweep)
syndrome check, per-shot convergence freezing, magnitude
select by ``|Q| == min1`` (at ties min1 == min2, so every edge receives the
same magnitude as with first-argmin), posterior summed per column in base
slot order, then the prior added.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from .bp import _BIG, _fused_mix, _fused_sub

_DEAD_PRIOR = 50.0  # prior of dead grid slots: hard bit 0


@dataclasses.dataclass
class LiftedGraph:
    """Static lift structure of a decoding matrix (build via
    :func:`try_from_dense`; ``None`` means not (cleanly) lifted)."""

    prior_grid: torch.Tensor  # (NB, ell, mm, T) f32; dead slots +_DEAD_PRIOR
    slot_mask: torch.Tensor   # (NB, ell, mm, T) bool — live column slots
    cmask: torch.Tensor       # (EB, ell, mm, T) bool — edge mask, check side
    out_gather: torch.Tensor  # (n,) int64 into V.reshape(NB*ell*mm*T, B)
    residual: torch.Tensor    # (n,) bool — edge-free columns (keep prior)
    eb_pb: tuple              # (EB,) base-pattern index per edge slot
    eb_o: tuple               # (EB,) time offset per edge slot
    eb_cx: tuple              # (EB,) rep-check x per edge slot
    eb_cy: tuple              # (EB,) rep-check y per edge slot
    NB: int
    ell: int
    mm: int
    T: int
    n: int
    m: int
    # derived per-device tables (ops/bp_lift_cuda.flood_tables)
    cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)

    @property
    def EB(self) -> int:
        return len(self.eb_pb)

    @staticmethod
    def try_from_dense(H: np.ndarray, ell: int, mm: int, prior: np.ndarray,
                       device=None):
        """Detect the lifted structure of ``H`` (rows = cycle-major syndrome
        bits, ell*mm per cycle, check index c = x*mm + y translated by the
        code's Z_ell x Z_mm group). Returns a LiftedGraph on ``device``, or
        None when any of the following fails to hold exactly: cycle
        periodicity, pattern orbits of size exactly ell*mm closed under
        translation, one column per (pattern, anchor) grid slot, residual
        columns edge-free."""
        dev = resolve_device(device)
        H = np.asarray(H) != 0
        m, n = H.shape
        n2 = ell * mm
        if n2 <= 0 or m % n2:
            return None
        T = m // n2
        if T < 2:
            return None
        # --- cycle-pattern detection ---
        patterns: dict = {}
        pat_edges: list = []
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
            if off.max() >= T:
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
        if nq == 0 or nq % n2:
            return None
        # one column per (anchor, pattern)
        live = ~residual
        a_l, q_l, j_l = col_anchor[live], col_q[live], np.nonzero(live)[0]
        if np.unique(a_l * nq + q_l).size != j_l.size:
            return None
        grid_col = np.full((T, nq), -1, np.int64)
        grid_col[a_l, q_l] = j_l

        # --- translation orbits of the patterns ---
        def tr_check(c, gx, gy):
            x, y = c // mm, c % mm
            return ((x + gx) % ell) * mm + (y + gy) % mm

        def tr_pattern(q, gx, gy):
            offs, checks = (tuple(o for o, _ in pat_edges[q]),
                            tuple(c for _, c in pat_edges[q]))
            edges = sorted(zip(offs, (tr_check(c, gx, gy) for c in checks)))
            key = (tuple(o for o, _ in edges), tuple(c for _, c in edges))
            return patterns.get(key, -1)

        pat_rep = np.full(nq, -1, np.int64)    # orbit representative
        pat_g = np.full((nq, 2), -1, np.int64)  # translation rep -> pattern
        reps = []
        for q0 in range(nq):
            if pat_rep[q0] >= 0:
                continue
            for gx in range(ell):
                for gy in range(mm):
                    q = tr_pattern(q0, gx, gy)
                    if q < 0 or (pat_rep[q] >= 0 and not
                                 (q == q0 and gx == 0 and gy == 0)):
                        return None  # open orbit or non-trivial stabilizer
                    pat_rep[q] = q0
                    pat_g[q] = (gx, gy)
            reps.append(q0)
        NB = len(reps)
        if NB * n2 != nq:
            return None
        rep_of = {q0: pb for pb, q0 in enumerate(reps)}

        # --- edge slots: rep-pattern edges sorted by (offset, rep check) ---
        eb_pb, eb_o, eb_cx, eb_cy = [], [], [], []
        for pb, q0 in enumerate(reps):
            for o, c in sorted(pat_edges[q0]):
                eb_pb.append(pb)
                eb_o.append(int(o))
                eb_cx.append(int(c // mm))
                eb_cy.append(int(c % mm))
        EB = len(eb_pb)

        # --- grids ---
        q_of = np.full((NB, ell, mm), -1, np.int64)
        for q in range(nq):
            pb = rep_of[int(pat_rep[q])]
            gx, gy = pat_g[q]
            q_of[pb, gx, gy] = q
        if (q_of < 0).any():
            return None
        col_grid = grid_col[:, q_of].transpose(1, 2, 3, 0)  # (NB,ell,mm,T)
        slot_mask = col_grid >= 0

        prior = np.asarray(prior, np.float32)
        prior_grid = np.full((NB, ell, mm, T), _DEAD_PRIOR, np.float32)
        prior_grid[slot_mask] = prior[col_grid[slot_mask]]

        # check-layout edge masks: cmask[eb](x,y,t) =
        #   slot_mask[pb][x-cx, y-cy, t-o]
        cmask = np.zeros((EB, ell, mm, T), bool)
        for e in range(EB):
            r = np.roll(slot_mask[eb_pb[e]], (eb_cx[e], eb_cy[e]),
                        axis=(0, 1))
            o = eb_o[e]
            cmask[e, :, :, o:] = r[:, :, :T - o] if o else r
        # sanity: every check edge count equals the row degree of H
        deg = cmask.sum(0).transpose(2, 0, 1).reshape(m)  # (t,x,y)->row
        if not np.array_equal(deg, H.sum(1)):
            return None

        out_gather = np.zeros(n, np.int64)
        flat = col_grid.reshape(-1)
        pos = np.nonzero(flat >= 0)[0]
        out_gather[flat[pos]] = pos

        return LiftedGraph(
            prior_grid=torch.as_tensor(prior_grid, device=dev),
            slot_mask=torch.as_tensor(slot_mask, device=dev),
            cmask=torch.as_tensor(cmask, device=dev),
            out_gather=torch.as_tensor(out_gather, device=dev),
            residual=torch.as_tensor(residual, device=dev),
            eb_pb=tuple(eb_pb), eb_o=tuple(eb_o),
            eb_cx=tuple(eb_cx), eb_cy=tuple(eb_cy),
            NB=NB, ell=ell, mm=mm, T=T, n=n, m=m)


def _to_check(A, e, g: LiftedGraph, dead):
    """Column layout (ell, mm, T, B) -> check layout for edge slot e:
    out[x, y, t] = A[x-cx, y-cy, t-o] (x/y wrap, t does not)."""
    cx, cy, o = g.eb_cx[e], g.eb_cy[e], g.eb_o[e]
    if cx:
        A = torch.roll(A, cx, dims=0)
    if cy:
        A = torch.roll(A, cy, dims=1)
    if o:
        pad = torch.full(A.shape[:2] + (o,) + A.shape[3:], dead,
                         dtype=A.dtype, device=A.device)
        A = torch.cat([pad, A[:, :, :-o]], dim=2)
    return A


def _to_col(A, e, g: LiftedGraph, dead):
    """Check layout -> column layout for edge slot e (inverse of
    :func:`_to_check`): out[gx, gy, a] = A[gx+cx, gy+cy, a+o]."""
    cx, cy, o = g.eb_cx[e], g.eb_cy[e], g.eb_o[e]
    if cx:
        A = torch.roll(A, -cx, dims=0)
    if cy:
        A = torch.roll(A, -cy, dims=1)
    if o:
        pad = torch.full(A.shape[:2] + (o,) + A.shape[3:], dead,
                         dtype=A.dtype, device=A.device)
        A = torch.cat([A[:, :, o:], pad], dim=2)
    return A


def decode_batch_lift(g: LiftedGraph, syndrome, prior, alpha_seq,
                      maxIter: int, damping: float = 1.0,
                      clip_llr: float = 20.0, msg_dtype=torch.float32,
                      exit_check: bool = True):
    """Roll-based min-sum on a LiftedGraph: the twin of the JAX package's
    ``decode_batch_lift``, and the port's damped lifted decoder.

    syndrome (B, m) with rows t*ell*mm + x*mm + y; prior (n,) f32;
    alpha_seq (maxIter,) f32; ``msg_dtype`` torch.float32 or torch.bfloat16
    for the edge messages (posteriors are summed in float32). With
    ``damping`` != 1 each new message is clip(d*q + (1-d)*q_prev), clipped
    again, with the JAX XLA program's fused multiply-adds (ops/bp.py,
    ``_fused_sub``); damping 1 keeps the Pallas kernel's (and K1's)
    unfused arithmetic. Returns dict hard (B, n) int8, converged (B,) bool, values (B, n)
    f32 (frozen at each shot's first convergence), iterations (B,) int32.

    Edge messages live in CHECK layout, so the check update and the syndrome
    parity are reductions over the EB axis; the only cross-layout traffic is
    two rolls per edge per iteration. Runs until every shot has converged or
    maxIter (one host read per iteration; ``exit_check=False`` runs all
    maxIter iterations without it, the outputs unchanged, for timing that
    read). Damping 1 on the card is kernel K1's (ops/bp_lift_cuda.py); this
    runs the damped path there."""
    B = syndrome.shape[0]
    dev = syndrome.device
    ell, mm, T, NB, EB = g.ell, g.mm, g.T, g.NB, g.EB
    f32, dt = torch.float32, msg_dtype
    big = torch.tensor(_BIG, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    d_new = torch.tensor(damping, dtype=dt, device=dev)
    d_old = torch.tensor(1.0 - damping, dtype=dt, device=dev)
    pb_start = [0] * (NB + 1)
    for e, pb in enumerate(g.eb_pb):
        pb_start[pb + 1] = e + 1

    syn = syndrome.T.reshape(T, ell, mm, B).permute(1, 2, 0, 3)
    syn = syn.to(torch.int32)
    sgn_syn = (1.0 - 2.0 * syn.to(f32)).to(dt)
    prior = prior.to(f32)
    alpha_seq = torch.as_tensor(alpha_seq, device=dev).to(f32)

    cmask = g.cmask[..., None]                            # (EB,ell,mm,T,1)
    pg = g.prior_grid[..., None]                          # (NB,ell,mm,T,1)
    pg_dt = pg.to(dt)

    Q = torch.stack([_to_check(pg_dt[g.eb_pb[e]].expand(ell, mm, T, B), e,
                               g, _BIG) for e in range(EB)])
    Q = torch.where(cmask, Q, big)
    Qold = Q
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    vals = torch.zeros((NB, ell, mm, T, B), dtype=f32, device=dev)
    iters = torch.full((B,), maxIter - 1, dtype=torch.int32, device=dev)
    it = 0
    while it < maxIter and not (exit_check and bool(done.all())):
        alpha = alpha_seq[it].to(dt)
        # --- check pass: pure reductions over the EB axis ---
        absQ = Q.abs()                       # dead positions hold +_BIG
        m1 = absQ.amin(0)
        is_min = absQ == m1[None]
        nmin = is_min.sum(0)
        m2d = torch.where(is_min, big, absQ).amin(0)
        m2 = torch.where(nmin > 1, m1, m2d)
        neg = Q < 0.0
        negtot = neg.sum(0) & 1
        sgn = torch.where(negtot == 1, -1.0, 1.0).to(dt) * sgn_syn
        mag = torch.where(is_min, m2[None], m1[None])
        sq = torch.where(neg, -1.0, 1.0).to(dt)
        coef = alpha * sgn[None] * sq
        Rchk = torch.where(cmask, coef * mag, zero)

        # --- posterior sum per base pattern (column layout), float32 ---
        Rcol = [_to_col(Rchk[e], e, g, 0.0) for e in range(EB)]
        V = torch.stack([
            pg[pb] + sum(Rcol[e].to(f32) for e in range(pb_start[pb],
                                                        pb_start[pb + 1]))
            for pb in range(NB)])                        # (NB,...,B) f32

        # --- Q update + syndrome parity (one V->check roll per edge) ---
        Qn = []
        par = torch.zeros((ell, mm, T, B), dtype=torch.int32, device=dev)
        for e in range(EB):
            vhc = _to_check(V[g.eb_pb[e]].to(dt), e, g, _BIG)
            par = par + (cmask[e] & (vhc < 0.0)).to(torch.int32)
            if damping != 1.0:
                # the JAX package's damped lift is an XLA program whose
                # multiply-adds are fused (ops/bp.py, _fused_sub)
                q = torch.clamp(_fused_sub(vhc, coef[e], mag[e]),
                                -clip_llr, clip_llr)
                q = torch.clamp(_fused_mix(d_new, q, d_old, Qold[e]),
                                -clip_llr, clip_llr)
            else:
                q = torch.clamp(vhc - Rchk[e], -clip_llr, clip_llr)
            Qn.append(torch.where(cmask[e], q, big))
        Q = torch.stack(Qn)
        ok = ((par & 1) == syn).reshape(-1, B).all(0)

        vals = torch.where(done[None, None, None, None, :], vals, V)
        iters = torch.where(ok & ~done, it, iters)
        done = done | ok
        if damping != 1.0:
            Qold = Q
        it += 1

    return _epilogue(g, vals, prior, done, iters)


def _epilogue(g: LiftedGraph, vals, prior, done, iters):
    """Grid posteriors (NB, ell, mm, T, B) -> the decode dict in original
    column order; edge-free columns keep the prior."""
    B = vals.shape[-1]
    flat = vals.reshape(g.NB * g.ell * g.mm * g.T, B)
    vals_n = flat.index_select(0, g.out_gather)              # (n, B)
    vals_n = torch.where(g.residual[:, None], prior[:, None], vals_n)
    hard = (vals_n < 0.0).to(torch.int8)
    return dict(hard=hard.T.contiguous(), converged=done,
                values=vals_n.T.contiguous(), iterations=iters)


def decode_batch_lift_layered(g: LiftedGraph, syndrome, prior, alpha_seq,
                              maxIter: int, clip_llr: float = 20.0):
    """Roll-based float32 time-layered min-sum on a LiftedGraph (the twin of
    the JAX package's ``decode_batch_lift_layered``; damping 1).

    Each iteration is one SWEEP of two half-updates: first every check at an
    even time slice t = row // (ell*mm), then every check at an odd one,
    with the posteriors rebuilt from all committed messages between the
    halves. A half computes Q = clip(V - R) at every check and commits the
    new R on its layer's checks only (so the very first half already
    clips). ``alpha_seq`` is indexed by sweep; convergence is checked once
    per sweep on the post-sweep posteriors, and ``iterations`` counts
    sweeps. Same arguments and outputs as :func:`decode_batch_lift`; values
    are frozen at each shot's converging sweep."""
    B = syndrome.shape[0]
    dev = syndrome.device
    ell, mm, T, NB, EB = g.ell, g.mm, g.T, g.NB, g.EB
    f32 = torch.float32
    big = torch.tensor(_BIG, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    pb_start = [0] * (NB + 1)
    for e, pb in enumerate(g.eb_pb):
        pb_start[pb + 1] = e + 1

    syn = syndrome.T.reshape(T, ell, mm, B).permute(1, 2, 0, 3)
    syn = syn.to(torch.int32)
    sgn_syn = 1.0 - 2.0 * syn.to(f32)
    prior = prior.to(f32)
    alpha_seq = alpha_seq.to(f32)

    cmask = g.cmask[..., None]                            # (EB,ell,mm,T,1)
    pg = g.prior_grid[..., None]                          # (NB,ell,mm,T,1)
    t_even = torch.arange(T, device=dev) % 2 == 0
    lmasks = [t_even[None, None, :, None], ~t_even[None, None, :, None]]

    def half(V, R, alpha, lm):
        Q = torch.stack([
            torch.where(cmask[e],
                        torch.clamp(_to_check(V[g.eb_pb[e]], e, g, _BIG)
                                    - R[e], -clip_llr, clip_llr), big)
            for e in range(EB)])
        absQ = Q.abs()
        m1 = absQ.amin(0)
        is_min = absQ == m1[None]
        nmin = is_min.sum(0)
        m2d = torch.where(is_min, big, absQ).amin(0)
        m2 = torch.where(nmin > 1, m1, m2d)
        neg = Q < 0.0
        negtot = neg.sum(0) & 1
        sgn = torch.where(negtot == 1, -1.0, 1.0).to(f32) * sgn_syn
        mag = torch.where(is_min, m2[None], m1[None])
        sq = torch.where(neg, -1.0, 1.0).to(f32)
        Rl = torch.where(cmask, alpha * sgn[None] * sq * mag, zero)
        R = torch.where(lm[None], Rl, R)                  # commit the layer
        Rcol = [_to_col(R[e], e, g, 0.0) for e in range(EB)]
        V = torch.stack([
            pg[pb] + sum(Rcol[e] for e in range(pb_start[pb],
                                                pb_start[pb + 1]))
            for pb in range(NB)])
        return V, R

    V = pg.expand(NB, ell, mm, T, B).clone()
    R = torch.zeros((EB, ell, mm, T, B), dtype=f32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    vals = torch.zeros((NB, ell, mm, T, B), dtype=f32, device=dev)
    iters = torch.full((B,), maxIter - 1, dtype=torch.int32, device=dev)
    it = 0
    while it < maxIter and not bool(done.all()):
        alpha = alpha_seq[it]
        V, R = half(V, R, alpha, lmasks[0])
        V, R = half(V, R, alpha, lmasks[1])
        par = torch.zeros((ell, mm, T, B), dtype=torch.int32, device=dev)
        for e in range(EB):
            vhc = _to_check(V[g.eb_pb[e]], e, g, _BIG)
            par = par + (cmask[e] & (vhc < 0.0)).to(torch.int32)
        ok = ((par & 1) == syn).reshape(-1, B).all(0)
        vals = torch.where(done[None, None, None, None, :], vals, V)
        iters = torch.where(ok & ~done, it, iters)
        done = done | ok
        it += 1
    # shots still unconverged report their final posteriors
    vals = torch.where(done[None, None, None, None, :], vals, V)
    return _epilogue(g, vals, prior, done, iters)
