"""Flooding normalized min-sum BP on a padded row layout.

Per iteration t (alpha_t from the configuration's schedule):

* each edge sends Q = posterior - R to its check, clipped to +-clip (at
  t = 0 the prior itself, unclipped);
* each check answers R = alpha_t * s * |Q|min_extrinsic, where the sign s is
  the product of the syndrome sign and the other edges' signs, and the
  magnitude is the least |Q| of the other edges (the second least where
  the edge holds the least, the least itself where it is tied);
* each column's posterior is its prior plus its R summed from zero in the
  column's sum order (:func:`sum_keys`); the hard decision is posterior < 0;
* a shot whose hard decision meets its syndrome stops: its decision,
  posteriors and iteration count are kept from that iteration.

``msg_dtype`` rounds Q and R to a narrower type (the control runs
bfloat16 messages); the posteriors are float32 either way.
"""
from __future__ import annotations

import numpy as np
import torch

BIG = 1e30  # an absent edge's |Q|: positive, never a row's least


def sum_keys(rows, cols, n: int, ell: int, mm: int) -> np.ndarray:
    """The position of each edge (rows[i], cols[i]) of H in its column's
    float32 sum, as the program's lifted layout sums it. H's rows are
    cycle-major checks c = x*mm + y of the code's Z_ell x Z_mm group. A
    column's pattern is its (cycle offset from its first cycle, check) pairs;
    the translations of the group carry patterns into patterns, and each
    orbit's representative is the pattern that occurs first in column order.
    A column translated by g from its representative sums its edges in the
    representative's (offset, check) order, that is by (offset, check
    translated back by -g). Columns whose pattern no translation reaches
    keep ascending row order."""
    n2 = ell * mm
    order = np.lexsort((rows, cols))
    r, c = rows[order], cols[order]
    starts = np.concatenate([[0], np.cumsum(np.bincount(c, minlength=n))])
    anchor = np.zeros(n, np.int64)
    pattern = np.full(n, -1, np.int64)
    patterns, pat_edges = {}, []
    for j in range(n):
        rj = r[starts[j]:starts[j + 1]]
        if rj.size == 0:
            continue
        anchor[j] = rj.min() // n2
        edges = tuple(zip((rj // n2 - anchor[j]).tolist(),
                          (rj % n2).tolist()))
        pattern[j] = patterns.setdefault(edges, len(pat_edges))
        if pattern[j] == len(pat_edges):
            pat_edges.append(edges)

    def moved(c, gx, gy):
        return ((c // mm + gx) % ell) * mm + (c % mm + gy) % mm

    shift = {}                          # pattern -> g from its representative
    for q0 in range(len(pat_edges)):
        if q0 in shift:
            continue
        for gx in range(ell):
            for gy in range(mm):
                q = patterns.get(tuple(sorted(
                    (o, moved(ch, gx, gy)) for o, ch in pat_edges[q0])))
                if q is not None and q not in shift:
                    shift[q] = (gx, gy)
    g = np.array([shift.get(int(q), (0, 0)) for q in pattern], np.int64)
    gx, gy = g[cols, 0], g[cols, 1]
    back = moved(rows % n2, -gx, -gy)
    return (rows // n2 - anchor[cols]) * n2 + back


class Graph:
    """The padded row and column layouts of a decoding matrix H (m, n) of a
    code over Z_ell x Z_mm."""

    def __init__(self, H: np.ndarray, prior: np.ndarray, ell: int, mm: int,
                 device):
        H = np.asarray(H) != 0
        m, n = H.shape
        dev = torch.device(device)
        rows, cols = np.nonzero(H)                      # row-major
        deg_r = np.bincount(rows, minlength=m)
        dr = int(deg_r.max())
        slot = np.arange(rows.size) - np.concatenate([[0], np.cumsum(deg_r)])[
            rows]
        row_cols = np.full((m, dr), n, np.int64)        # n: a dummy column
        row_cols[rows, slot] = cols
        by_col = np.lexsort((sum_keys(rows, cols, n, ell, mm), cols))
        c = cols[by_col]
        deg_c = np.bincount(cols, minlength=n)
        dc = max(int(deg_c.max()), 1)
        cslot = np.arange(c.size) - np.concatenate([[0], np.cumsum(deg_c)])[c]
        col_edges = np.full((n, dc), m * dr, np.int64)  # m*dr: a zero slot
        col_edges[c, cslot] = (rows * dr + slot)[by_col]
        self.m, self.n, self.dr, self.dc = m, n, dr, dc
        self.layer_rows = ell * mm      # the checks of one cycle
        self.edges = int(rows.size)
        self.row_cols = torch.as_tensor(row_cols, device=dev)
        self.mask = self.row_cols < n
        self.col_edges = torch.as_tensor(col_edges, device=dev)
        self.prior = torch.as_tensor(np.asarray(prior, np.float32),
                                     device=dev)


def check_messages(Q, mask, sgn_syn, alpha_t, msg_dtype):
    """New R (B, rows, dr) of the checks whose Q (B, rows, dr) is given:
    R = (alpha_t * s) * |Q|min_extrinsic, absent edges (``mask`` false)
    sending nothing and answered 0; ``sgn_syn`` (B, rows) the syndrome
    signs."""
    dt, dev = msg_dtype, Q.device
    big = torch.tensor(BIG, dtype=dt, device=dev)
    Q = torch.where(mask, Q, big)
    absQ = Q.abs()
    m1 = absQ.amin(2, keepdim=True)
    is_min = absQ == m1
    m2 = torch.where(is_min, big, absQ).amin(2, keepdim=True)
    m2 = torch.where(is_min.sum(2, keepdim=True) > 1, m1, m2)
    neg = Q < 0
    sgn = torch.where(neg.sum(2) % 2 == 1, -1.0, 1.0) * sgn_syn
    rpos = (alpha_t * sgn).to(dt)[:, :, None] * torch.where(is_min, m2, m1)
    return torch.where(mask, torch.where(neg, -rpos, rpos),
                       torch.zeros((), dtype=dt, device=dev))


def posteriors(g: Graph, R):
    """V (B, n + 1) float32: each column's prior plus its R (B, m, dr)
    summed from zero in the column's sum order; the last column a zero
    pad."""
    B, dev = R.shape[0], R.device
    Rf = torch.cat([R.reshape(B, -1).to(torch.float32),
                    torch.zeros((B, 1), device=dev)], 1)
    acc = torch.zeros((B, g.n), device=dev)
    for d in range(g.dc):
        acc = acc + Rf[:, g.col_edges[:, d]]
    return torch.cat([g.prior[None] + acc, torch.zeros((B, 1), device=dev)],
                     1)


def satisfied(g: Graph, V, syn):
    """(B,) whether the hard decision of V meets the syndrome syn (B, m)."""
    hard = V[:, g.row_cols] < 0
    return ((hard & g.mask).sum(2) % 2 == syn).all(1)


def decode(g: Graph, syndrome, alpha, max_iter: int, clip: float,
           msg_dtype=torch.float32) -> dict:
    """syndrome (B, m) 0/1. Returns values (B, n) f32, hard (B, n) bool,
    converged (B,) bool, iterations (B,) int64: the iterations each shot
    ran (its converging one counted; max_iter when it never converged)."""
    dev = syndrome.device
    B = syndrome.shape[0]
    dt = msg_dtype
    syn = syndrome.to(torch.int64)
    sgn_syn = (1 - 2 * syn).to(torch.float32)
    alpha = torch.as_tensor(np.asarray(alpha, np.float32), device=dev)
    prior_pad = torch.cat([g.prior, torch.zeros(1, device=dev)])
    V = prior_pad[None].expand(B, -1).clone()           # (B, n + 1)
    R = torch.zeros((B, g.m, g.dr), dtype=dt, device=dev)
    values = V[:, :g.n].clone()
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.full((B,), max_iter, dtype=torch.int64, device=dev)
    for t in range(max_iter):
        Vr = V[:, g.row_cols].to(dt)
        Q = Vr if t == 0 else torch.clamp(Vr - R, -clip, clip)
        R = check_messages(Q, g.mask, sgn_syn, alpha[t], dt)
        V = posteriors(g, R)
        ok = satisfied(g, V, syn)
        new = ok & ~done
        values = torch.where(done[:, None], values, V[:, :g.n])
        iters = torch.where(new, t + 1, iters)
        done = done | ok
        if bool(done.all()):
            break
    return dict(values=values, hard=values < 0, converged=done,
                iterations=iters)
