"""Ordered-statistics decoding, as the JAX package defines it.

For a shot that BP left unconverged, with posterior LLRs ``values`` and
hard decision ``hard``: the correction ``e`` must reproduce the residual
syndrome ``syndrome ^ H hard``. Columns are taken in ascending |LLR|
(stable: ties keep column order); the first K = min(n, 256 * ceil((m +
margin) / 256)) of them, then a fixed column basis of H (the greedy,
first-independent columns in natural order) appended so that full rank is
always reached. A greedy swap-free Gauss-Jordan pivots them in that order:
each column takes the first unused row that holds it, and is cleared from
every other row; it stops once the residual lies in the pivot span (every
unused row's reduced syndrome bit is 0), which changes no answer. OSD-0
sets each pivot column to its row's reduced syndrome bit and every other
column to 0.

When OSD-0 does not reproduce the residual (the shot is rank deficient),
order-w reprocessing flips every set of up to w of the first ``order + 10``
non-pivot columns (in the same column order) and keeps, among OSD-0 and
the flips in enumeration order (weight 1 first), the first with the least
unsatisfied checks and then the least sum of |LLR| over the decoded error
(hard XOR correction).
"""
from __future__ import annotations

from itertools import combinations

import numpy as np
import torch

WORD = 64
COMPACT_EVERY = 16   # columns between drops of the shots that have stopped


def choose_k(m: int, n: int, margin: int) -> int:
    return min(n, -(-(m + margin) // 256) * 256)


def pack_columns(HT: torch.Tensor, cols: torch.Tensor, block: int):
    """(S, m, W) int64: row r of shot s holds bit j of word w for column
    ``cols[s, 64 w + j]`` of H (HT: (n, m) bool, H transposed)."""
    S, KT = cols.shape
    m = HT.shape[1]
    W = -(-KT // WORD)
    shifts = torch.arange(WORD, device=HT.device, dtype=torch.int64)
    out = torch.empty((S, m, W), dtype=torch.int64, device=HT.device)
    pad = torch.zeros((block, W * WORD - KT, m), dtype=torch.bool,
                      device=HT.device)
    for s0 in range(0, S, block):
        c = cols[s0:s0 + block]
        bits = torch.cat([HT[c], pad[:len(c)]], 1)      # (b, W*64, m)
        words = (bits.view(len(c), W, WORD, m).to(torch.int64)
                 << shifts[:, None]).sum(2)              # distinct bits: OR
        out[s0:s0 + block] = words.transpose(1, 2)
    return out


def eliminate(A: torch.Tensor, s: torch.Tensor, ncols: int,
              exit_on_valid: bool = True, full: bool = False):
    """Greedy swap-free Gauss-Jordan of each shot's (m, ncols) bit matrix
    ``A`` (S, m, W) int64 against its syndrome ``s`` (S, m) int64, in column
    order. Returns (s_red (S, m), used (S, m) bool, prow (S, ncols) int64:
    the pivot row of each column or -1). ``full`` keeps every word of the
    reduced matrix in ``A`` (in place); otherwise only the words from the
    current column on are updated, which is all the pivots and the
    syndrome need. With ``exit_on_valid`` a shot stops once its syndrome
    lies in its pivot span; shots that have stopped are dropped from the
    batch every ``COMPACT_EVERY`` columns."""
    S, m, W = A.shape
    dev = A.device
    s = s.clone()
    used = torch.zeros((S, m), dtype=torch.bool, device=dev)
    prow = torch.full((S, ncols), -1, dtype=torch.int64, device=dev)
    rows = torch.arange(m, device=dev)
    live = torch.arange(S, device=dev)      # the shots still running
    a, sl, ul = A, s.clone(), used.clone()

    def write_back():
        s[live], used[live] = sl, ul
        if full and a is not A:
            A[live] = a

    for c in range(ncols):
        if exit_on_valid and c % COMPACT_EVERY == 0:
            write_back()
            going = (torch.where(ul, 0, sl) != 0).any(1)
            if not bool(going.any()):
                break
            live = live[going]
            a, sl, ul = a[going], sl[going], ul[going]
        w, bit = divmod(c, WORD)
        w0 = 0 if full else w
        colbits = ((a[:, :, w] >> bit) & 1) == 1
        cand = colbits & ~ul
        has = cand.any(1)
        piv = cand.to(torch.int8).argmax(1)
        ar = torch.arange(len(live), device=dev)
        prow_words = a[ar, piv, w0:]
        elim = colbits & (rows[None] != piv[:, None]) & has[:, None]
        a[:, :, w0:] ^= torch.where(elim[:, :, None], prow_words[:, None], 0)
        sl = sl ^ torch.where(elim, sl[ar, piv][:, None], 0)
        ul = ul | ((rows[None] == piv[:, None]) & has[:, None])
        prow[live, c] = torch.where(has, piv, -1)
    write_back()
    return s, used, prow


def column_basis(H: np.ndarray, device) -> np.ndarray:
    """The greedy column basis of H (m, n): the columns that pivot in a
    Gauss-Jordan over all columns in natural order."""
    m, n = H.shape
    HT = torch.as_tensor(np.asarray(H).T != 0, device=device)
    cols = torch.arange(n, device=device)[None]
    A = pack_columns(HT, cols, 1)
    s = torch.zeros((1, m), dtype=torch.int64, device=device)
    _, _, prow = eliminate(A, s, n, exit_on_valid=False)
    return np.nonzero(prow[0].cpu().numpy() >= 0)[0]


def _reprocess(Ared, s_red, used, prow, llr, hard, cols, order: int,
               num_test: int):
    """Order-w search for one rank-deficient shot (NumPy). Ared (m, KT) the
    fully reduced bit matrix. Returns the correction (KT,) over ``cols``."""
    pivot = prow >= 0
    e0 = np.where(pivot, s_red[np.maximum(prow, 0)], 0)
    test = np.nonzero(~pivot)[0][:num_test]
    absl = np.abs(llr)

    def metric(e):
        corr = np.zeros(len(llr), np.int64)
        np.add.at(corr, cols, e)
        return np.float32((absl * ((hard + corr) % 2)).sum(dtype=np.float32))

    best, best_key = e0, (int((s_red[~used] != 0).sum()), metric(e0))
    for w in range(1, order + 1):
        for combo in combinations(test, w):
            par = Ared[:, list(combo)].sum(1) % 2
            r = s_red ^ par
            e = np.where(pivot, r[np.maximum(prow, 0)], 0)
            e[list(combo)] = 1
            key = (int((r[~used] != 0).sum()), metric(e))
            if key < best_key:
                best, best_key = e, key
    return best


def osd(HT: torch.Tensor, basis_cols: torch.Tensor,
        syndrome, values, hard, K: int, order: int, logical: torch.Tensor,
        block: int):
    """OSD of the shots given (all of them BP-failed). logical (n, k) int64
    0/1: each column's logical action. Returns (logical delta (S, k) int64,
    rank deficient (S,) bool)."""
    dev = values.device
    S = values.shape[0]
    k = logical.shape[1]
    if S == 0:
        return (torch.zeros((0, k), dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    Hf = HT.to(torch.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        hsyn = (hard.to(torch.float32) @ Hf).to(torch.int64) & 1
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    residual = syndrome.to(torch.int64) ^ hsyn
    order_idx = torch.sort(values.abs(), dim=1, stable=True).indices
    cols = torch.cat([order_idx[:, :K],
                      basis_cols[None].expand(S, -1)], 1)
    KT = cols.shape[1]
    A = pack_columns(HT, cols, block)
    s_red, used, prow = eliminate(A, residual, KT)
    e = torch.where(prow >= 0, s_red.gather(1, prow.clamp(min=0)), 0)
    bad = (torch.where(used, 0, s_red) != 0).any(1)
    if bool(bad.any()):
        idx = torch.nonzero(bad)[:, 0]
        Ab = pack_columns(HT, cols[idx], block)
        sb, ub, pb = eliminate(Ab, residual[idx], KT, exit_on_valid=False,
                               full=True)
        shifts = torch.arange(WORD, device=dev)
        Ared = ((Ab[:, :, :, None] >> shifts) & 1).flatten(2)[:, :, :KT]
        for j, i in enumerate(idx.tolist()):
            e[i] = torch.as_tensor(_reprocess(
                Ared[j].cpu().numpy(), sb[j].cpu().numpy(),
                ub[j].cpu().numpy(), pb[j].cpu().numpy(),
                values[i].cpu().numpy(),
                hard[i].cpu().numpy().astype(np.int64),
                cols[i].cpu().numpy(), order, order + 10), device=dev)
    delta = (e[:, :, None] * logical[cols]).sum(1) & 1
    return delta, bad
