"""Batched ordered-statistics decoding (OSD) with bit-packed GF(2) elimination.

Per-shot reliability-ordered Gauss-Jordan elimination over a whole batch of
failed-BP shots: columns are sorted by |posterior LLR| per shot, the K
least-reliable columns are gathered and bit-packed 32 per int32 word, and a
swap-free greedy elimination (ops/osd_cuda.py: kernel K2 on the GPU, its
plain version on the CPU) pivots them.

Truncation: elimination runs over the first K = rank + margin columns in
reliability order PLUS a fixed rank-completing column basis appended after
them (``basis_cols``), so full rank is always reached without scanning all
n columns. The greedy pivot set is identical to the full scan's whenever the
K-prefix already reaches full rank; for the rare truncation-deficient shot
the completing pivots come from the appended basis.

Order-w reprocessing follows the reference's rule: OSD-0 is returned
whenever it reproduces the syndrome; otherwise flips of up to ``order`` of
the ``num_test`` least-reliable non-pivot columns are scored by
(unsatisfied checks, sum |LLR|) and the first minimum wins.

Host reads: the staged scan reads the uncovered count, the basis rerun
reads whether any shot is uncovered, and order-w reprocessing reads whether
any OSD-0 failed — each decides whether (and on how many shots) the next
elimination launch runs.
"""
from __future__ import annotations

from itertools import combinations

import numpy as np
import torch

from .osd_cuda import eliminate_blocks


def _combo_masks(num_test: int, order: int) -> np.ndarray:
    """(Ncombo, num_test) 0/1 masks for all flip sets of size 1..order, in
    the reference's enumeration order (weight-1 combos first)."""
    rows = []
    for w in range(1, order + 1):
        for combo in combinations(range(num_test), w):
            row = np.zeros(num_test, dtype=np.int32)
            row[list(combo)] = 1
            rows.append(row)
    if not rows:
        return np.zeros((0, num_test), dtype=np.int32)
    return np.stack(rows)


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding 32-bit patterns in [0, 2^32) -> int32, same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _pack_columns(bits: torch.Tensor) -> torch.Tensor:
    """(..., K) 0/1 -> (..., K//32) int32, bit c of word w = column 32w+c."""
    K = bits.shape[-1]
    assert K % 32 == 0
    b = bits.to(torch.int64).reshape(*bits.shape[:-1], K // 32, 32)
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    return _to_int32((b << shifts).sum(-1))


def _gather_pack(HT_u8, colsK, Kp: int, chunk: int = 256,
                 words_major: bool = False) -> torch.Tensor:
    """Per-shot column gather + bit-pack from the (n, m) uint8 transpose of
    H, chunked over columns so the unpacked gather never exceeds
    (B, chunk, m) bytes. Columns past K (up to Kp) pack as zeros.

    Returns (B, m, Kp//32), or the eliminator's (B, Kp//32, m) layout when
    words_major=True."""
    B, K = colsK.shape
    m = HT_u8.shape[1]
    dev = HT_u8.device
    words = []
    for c0 in range(0, Kp, chunk):
        c1 = min(c0 + chunk, Kp)
        nw = (c1 - c0) // 32
        acc = torch.zeros((B, nw, m), dtype=torch.int64, device=dev)
        if c0 < K:
            g = HT_u8[colsK[:, c0:min(c1, K)]]                 # (B, c, m)
            if c1 > K:  # zero-pad the final partial chunk
                g = torch.cat([g, torch.zeros((B, c1 - K, m), dtype=g.dtype,
                                              device=dev)], 1)
            g = g.view(B, nw, 32, m)
            for c in range(32):
                acc |= g[:, :, c, :].to(torch.int64) << c
        words.append(_to_int32(acc))
    packed = torch.cat(words, 1)                               # (B, W, m)
    return packed if words_major else packed.transpose(1, 2)


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis of an int32 tensor (pairwise tree)."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], -1)
        x = x[..., 0::2] ^ x[..., 1::2]
    return x[..., 0]


def osd_batch(H, HT, syndrome, llr, hard, K: int, order: int = 0,
              num_test: int = 0, use_blocks: bool = True, rank: int = None,
              basis_cols=None, logical_pack=None,
              return_solution: bool = True, stage1_cols: int = None):
    """Batched OSD post-processing of failed-BP shots.

    Args:
      H: (m, n) uint8 dense decoding matrix (class-level).
      HT: (n, m) float32 transpose of H (for the residual matmul).
      syndrome: (B, m) 0/1 target syndromes.
      llr: (B, n) f32 posterior LLRs from BP.
      hard: (B, n) int8 BP hard decisions (starting point).
      K: column budget for the elimination (multiple of 32 with basis_cols).
      order: OSD reprocessing order (0 = OSD-0 only).
      num_test: number of least-reliable non-pivot test positions
        (the reference uses order + 10; pass 0 with order=0).
      use_blocks: eliminate with ``eliminate_blocks`` (kernel K2 on CUDA
        tensors) through the staged scan; False runs ``_eliminate_xla``,
        the twin of the JAX package's XLA path, over prefix + basis.
      basis_cols: optional (R,) int — a fixed column basis of H, appended
        after the K reliability-ordered columns.
      stage1_cols: staged-scan stage-1 width. None = auto (768 when
        K >= 2048, 256 when K >= 512, else single-stage); 0 disables.
        Stage 1 scans a narrow prefix for every shot, and only the shots it
        leaves uncovered are rescanned at the full prefix width. Consumed
        outputs are identical to the single-stage scan.
      logical_pack: optional (n,) int32 — column j's logical action packed
        as bits. When given, the output gains ``logical_delta_packed`` (B,)
        int32, the packed logical action of the OSD correction alone.
      return_solution: skip materializing the (B, n) solution when False.

    Returns dict: solution (B, n) int8 (if return_solution), valid (B,) bool
    (syndrome exactly reproduced), rank_deficient (B,) bool,
    logical_delta_packed (B,) int32 (if logical_pack is given)."""
    B, n = llr.shape
    m = H.shape[0]
    dev = llr.device
    i32 = torch.int32
    if not 0 < K <= n:
        raise ValueError(f"need 0 < K <= n={n}, got K={K}")
    Kp = -(-K // 32) * 32  # packed prefix width (zero-padded beyond K)
    HT_u8 = H.T.contiguous()

    # residual syndrome the correction must reproduce; float32 keeps the
    # counts exact (see ops/sampler.py)
    hard_syn = (hard.to(torch.float32) @ HT).to(i32) & 1
    residual = syndrome.to(i32) ^ hard_syn                       # (B, m)

    # reliability ordering (stable: ties keep column order)
    order_idx = torch.sort(llr.abs(), dim=1, stable=True).indices
    colsK = order_idx[:, :K]
    lp_sorted = (logical_pack.to(i32)[order_idx]
                 if logical_pack is not None else None)

    if basis_cols is not None and K == n:
        basis_cols = None  # full-width prefix: nothing left to complete
    if basis_cols is not None:
        if K % 32:
            raise ValueError("basis_cols requires K % 32 == 0")
        basis_cols = basis_cols.to(device=dev, dtype=torch.int64)
        R = basis_cols.shape[0]
        Rp = -(-R // 32) * 32
        Hb_bits = torch.zeros((m, Rp), dtype=torch.uint8, device=dev)
        Hb_bits[:, :R] = H[:, basis_cols]
        Hb_words = _pack_columns(Hb_bits)                        # (m, Rp/32)
        colsE = torch.cat([colsK,
                           torch.zeros((B, Kp - K), dtype=colsK.dtype,
                                       device=dev),
                           basis_cols[None].expand(B, R)], 1)    # (B, KT)
        KT = Kp + R
        if lp_sorted is not None:
            lp_perm = torch.cat(
                [lp_sorted[:, :K], torch.zeros((B, Kp - K), dtype=i32,
                                               device=dev),
                 logical_pack.to(i32)[basis_cols][None].expand(B, R)], 1)
    else:
        Hb_words = None
        colsE = colsK
        KT = K
        if lp_sorted is not None:
            lp_perm = lp_sorted[:, :K]

    def pad_prow(p):
        return torch.cat([p, torch.full((p.shape[0], KT - p.shape[1]), -1,
                                        dtype=i32, device=dev)], 1)

    refine_for_reprocess = None
    if use_blocks:
        def gather_pref(cols, Kx):
            """Gather + pack of the first Kx reliability columns in the
            eliminator's (B, W, m) layout."""
            return _gather_pack(HT_u8, cols[:, :min(Kx, K)], Kx,
                                words_major=True)

        if Hb_words is not None:
            HbT = Hb_words.T.contiguous()                        # (Wb, m)
        if stage1_cols is None:
            stage1_cols = 768 if K >= 2048 else 256 if K >= 512 else 0
        staged = bool(stage1_cols) and stage1_cols < K

        HpT_pref = None if staged else gather_pref(colsK, Kp)

        def full_HpT(idx=None):
            if HpT_pref is not None:
                pref = HpT_pref if idx is None else HpT_pref[idx]
            else:
                pref = gather_pref(colsK if idx is None else colsK[idx], Kp)
            if Hb_words is None:
                return pref
            return torch.cat([pref, HbT[None].expand(pref.shape[0],
                                                      *HbT.shape)], 1)

        if staged:
            # --- staged scan: narrow stage-1 + full-prefix tail ---
            K1 = stage1_cols
            Hp_s1 = gather_pref(colsK, -(-K1 // 32) * 32)
            _, s1, prow1, used1, cf1 = eliminate_blocks(Hp_s1, residual, K1,
                                                        m, rank=rank)
            covered = torch.where(used1, 0, s1).sum(1) == 0
            prow1 = pad_prow(prow1)
            # coverage sort (stable): uncovered shots form a contiguous
            # tail, which starts at a 32-shot boundary as in the JAX scan
            # (boundary shots already covered are rescanned; their consumed
            # outputs are unchanged). One launch covers the whole tail.
            order2 = torch.sort((~covered).to(i32), stable=True).indices
            u0 = B - int((~covered).sum())                       # host read
            c_start = (u0 // 32) * 32
            if c_start < B:
                idx = order2[c_start:]
                _, s2, prow2, used2, cf2 = eliminate_blocks(
                    gather_pref(colsK[idx], Kp), residual[idx], K, m,
                    rank=rank)
                s1[idx], prow1[idx] = s2, pad_prow(prow2)
                used1[idx], cf1[idx] = used2, cf2
        else:
            _, s1, prow1, used1, cf1 = eliminate_blocks(HpT_pref, residual,
                                                        K, m, rank=rank)
            prow1 = pad_prow(prow1)
        if Hb_words is not None:
            # basis completion: shots the prefix left uncovered rerun at
            # full width (prefix + basis words); the others keep their
            # prefix outputs (the full-width run is consumed-identical)
            bad = torch.where(used1, 0, s1).sum(1) != 0
            if bool(bad.any()):                                  # host read
                idx = torch.nonzero(bad)[:, 0]
                _, s2, prow2, used2, cf2 = eliminate_blocks(
                    full_HpT(idx), residual[idx], KT, m, rank=rank)
                s1[idx], prow1[idx], used1[idx], cf1[idx] = (s2, prow2,
                                                             used2, cf2)
        s_red, prow_of_col, used, cf = s1, prow1, used1, cf1
        Hp = None  # only the (rare) reprocess path materializes it
        # OSD-0 correction scattered from row space: e0[colofrow[r]] =
        # s_red[r] for pivot rows; unused rows dump into slot KT
        tgt = torch.where(used, cf.long(), KT)
        e0_perm = torch.zeros((B, KT + 1), dtype=i32, device=dev).scatter_(
            1, tgt, s_red)[:, :KT]

        def refine_for_reprocess():
            hp_full = eliminate_blocks(full_HpT(), residual, KT, m,
                                       rank=rank, full_jordan=True)[0]
            return hp_full.transpose(1, 2)                       # (B, m, W)
    else:
        Hp = _gather_pack(HT_u8, colsK, Kp)                      # (B, m, W)
        if Hb_words is not None:
            Hp = torch.cat([Hp, Hb_words[None].expand(B, *Hb_words.shape)],
                           -1)
        Hp, s_red, used, prow_of_col = _eliminate_xla(Hp, residual, KT, m, B)
        e0_perm = torch.where(
            prow_of_col >= 0,
            s_red.gather(1, prow_of_col.clamp(min=0).long()), 0)

    is_pivot = prow_of_col >= 0                                  # (B, KT)
    # validity: un-pivoted rows must carry zero reduced syndrome
    unsat0 = torch.where(used, 0, s_red).sum(1)
    valid0 = unsat0 == 0
    rank_deficient = ~valid0

    if order > 0 and num_test > 0 and not bool(valid0.all()):    # host read
        Hp_full = Hp if refine_for_reprocess is None \
            else refine_for_reprocess()
        e_perm, valid = _reprocess(
            Hp_full, s_red, used, prow_of_col, is_pivot, e0_perm, valid0,
            llr, hard, colsE, order, num_test, B, KT, m)
    else:
        e_perm, valid = e0_perm.to(i32), valid0

    out = dict(valid=valid, rank_deficient=rank_deficient)
    if logical_pack is not None:
        out["logical_delta_packed"] = _xor_reduce(
            torch.where(e_perm > 0, lp_perm, 0))
    if return_solution:
        corr = torch.zeros((B, n), dtype=i32, device=dev).scatter_add_(
            1, colsE.long(), e_perm)
        out["solution"] = (hard.to(i32) ^ corr).to(torch.int8)
    return out


def _eliminate_xla(Hp, residual, K: int, m: int, B: int,
                   exit_on_valid: bool = True):
    """Whole-batch swap-free Gauss-Jordan over (B, m, W) words — the twin
    of the JAX package's XLA path. Every step touches the full matrix.

    Validity exit: the scan stops once EVERY shot's residual lies in its
    pivot span; from there on every new pivot's correction bit is zero, so
    all consumed outputs equal the full scan's. Returns (Hp, s_red, used,
    prow_of_col)."""
    dev = Hp.device
    row_ids = torch.arange(m, device=dev)[None, :]
    bidx = torch.arange(B, device=dev)
    Hp = Hp.to(torch.int32).clone()
    s = residual.to(torch.int32).clone()
    used = torch.zeros((B, m), dtype=torch.bool, device=dev)
    prow_of_col = torch.full((B, K), -1, dtype=torch.int32, device=dev)
    if exit_on_valid and bool((residual == 0).all()):
        return Hp, s, used, prow_of_col
    for col in range(K):
        w, bit = col // 32, col % 32
        colbits = ((Hp[:, :, w] >> bit) & 1) == 1               # (B, m)
        cand = colbits & ~used
        has = cand.any(1)
        piv = cand.to(torch.int32).argmax(1)                     # first True
        prow = Hp[bidx, piv]                                     # (B, W)
        ps = s[bidx, piv]
        elim = colbits & (row_ids != piv[:, None]) & has[:, None]
        Hp = torch.where(elim[:, :, None], Hp ^ prow[:, None, :], Hp)
        s = torch.where(elim, s ^ ps[:, None], s)
        used = used | ((row_ids == piv[:, None]) & has[:, None])
        prow_of_col[:, col] = torch.where(has, piv.to(torch.int32), -1)
        if exit_on_valid and bool(
                (torch.where(used, 0, s).sum(1) == 0).all()):
            break
    return Hp, s, used, prow_of_col


def _reprocess(Hp, s_red, used, prow_of_col, is_pivot, e0_perm, valid0,
               llr, hard, colsK, order, num_test, B, K, m):
    """Order-w flip search over the least-reliable non-pivot columns.

    Only consulted for shots whose OSD-0 syndrome fails (the reference
    returns OSD-0 immediately otherwise). Hp is (B, m, W)."""
    dev = llr.device
    f32, i32 = torch.float32, torch.int32
    # test positions: first num_test non-pivot column slots (ascending |LLR|)
    nonpiv = ~is_pivot                                           # (B, K)
    np_rank = torch.cumsum(nonpiv.to(i32), 1) - 1
    slot_ids = torch.arange(K, device=dev, dtype=i32)[None].expand(B, K)
    cand_rank = torch.where(nonpiv & (np_rank < num_test), np_rank, num_test)
    slot_of_rank = torch.zeros((B, num_test + 1), dtype=i32,
                               device=dev).scatter_(
        1, cand_rank.long(), slot_ids)[:, :num_test]

    # reduced-matrix bit columns at the test slots: (B, m, num_test)
    w_idx = (slot_of_rank // 32).long()
    b_idx = slot_of_rank % 32
    words = Hp.gather(2, w_idx[:, None, :].expand(B, m, num_test))
    test_cols = (words >> b_idx[:, None, :]) & 1

    combos = torch.as_tensor(_combo_masks(num_test, order), device=dev)
    # parity of flipped test columns at every row: (B, m, C)
    par_rows = (test_cols.to(f32) @ combos.T.to(f32)).to(i32) & 1
    unsat = torch.where(used[:, :, None], 0,
                        s_red[:, :, None] ^ par_rows).sum(1)     # (B, C)

    # (unsat, sum|LLR|) lexicographic metric relative to hard, derived in
    # row space (see the JAX package's osd._reprocess)
    abs_llr = llr.abs()
    hard_f = hard.to(f32)
    base_metric = (abs_llr * hard_f).sum(1)
    wperm = (abs_llr * (1 - 2 * hard_f)).gather(1, colsK.long())
    prow_clamped = prow_of_col.clamp(min=0).long()
    base_piv = s_red.gather(1, prow_clamped)                     # (B, K)
    wp = torch.where(is_pivot, wperm, 0.0)
    const_piv = (wp * base_piv).sum(1)
    wrow = torch.zeros((B, s_red.shape[1]), dtype=f32, device=dev
                       ).scatter_add_(1, prow_clamped,
                                      wp * (1.0 - 2.0 * base_piv))
    delta_piv = torch.einsum("bmc,bm->bc", par_rows.to(f32), wrow)
    wtest = wperm.gather(1, slot_of_rank.long())
    delta_flip = wtest @ combos.T.to(f32)
    metric_c = base_metric[:, None] + const_piv[:, None] + delta_piv \
        + delta_flip

    # OSD-0 candidate first (its metric), then combos; first minimum wins
    e0_delta = (e0_perm.to(f32) * wperm).sum(1)
    unsat0 = torch.where(used, 0, s_red).sum(1)
    all_llr = torch.cat([(base_metric + e0_delta)[:, None], metric_c], 1)
    all_unsat = torch.cat([unsat0[:, None], unsat], 1)
    eligible = all_unsat == all_unsat.amin(1, keepdim=True)
    best = torch.where(eligible, all_llr, torch.inf).argmin(1)   # (B,)

    # materialize the correction for the selected combo only
    pick_combo = (best - 1).clamp(min=0)
    par_best_rows = par_rows.gather(
        2, pick_combo[:, None, None].expand(B, m, 1))[:, :, 0]
    par_best_piv = par_best_rows.gather(1, prow_clamped)
    e_best = torch.where(is_pivot, base_piv ^ par_best_piv, 0)
    combo_best = combos[pick_combo].to(e_best.dtype)             # (B, T)
    e_best = e_best.scatter_reduce(1, slot_of_rank.long(), combo_best,
                                   "amax")
    e_perm = torch.where((best == 0)[:, None], e0_perm, e_best)
    unsat_best = torch.where(best == 0, unsat0,
                             unsat.gather(1, pick_combo[:, None])[:, 0])
    e_perm = torch.where(valid0[:, None], e0_perm, e_perm)
    valid = torch.where(valid0, True, unsat_best == 0)
    return e_perm.to(i32), valid


def choose_K(m: int, n: int, margin: int = 512) -> int:
    """Elimination column budget: rank bound + margin, capped at n, rounded
    up to a multiple of 256 (extra columns are free robustness against
    per-shot rank deficiency; the early exit stops at full rank)."""
    K = -(-(m + margin) // 256) * 256
    return min(n, K)
