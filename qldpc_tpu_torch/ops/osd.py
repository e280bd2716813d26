"""Batched ordered-statistics decoding (OSD) with bit-packed GF(2) elimination.

Per-shot reliability-ordered Gauss-Jordan elimination over a whole batch of
failed-BP shots: columns are sorted by |posterior LLR| per shot, the K
least-reliable columns are gathered and bit-packed into the eliminator's
own column bitsets (ops/osd_cuda.py: kernel G1 on the GPU, its plain
version on the CPU), and a swap-free greedy elimination (kernel K2, or
K4 / K5) pivots them, copying its input as it is or, where its columns live
in device memory, eliminating it in place.

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

No host read: every decision the JAX package takes on the device with
``lax.cond`` or ``lax.while_loop`` is a device range here, which G1 and the
eliminator read in their kernels (the gate, ops/osd_cuda.py). The batch's
live shots (``n_live``: the engine's chunk of the sorted pool), the staged
scan's uncovered tail, the basis rerun's uncovered shots and the shots
whose OSD-0 failed are each sorted to one end of the batch and gated there,
and the results merge back with ``torch.where`` on device masks. The one
step whose PyTorch ops cannot be gated per shot, the order-w reprocess,
runs on a fixed slice of ``reprocess_slice`` shots, the failed ones first
(JAX's small-slice rule); a failed shot past the slice keeps OSD-0's answer
and is flagged in ``reprocess_overflow``, and the engine replays such a
round with the whole batch as the slice.
"""
from __future__ import annotations

import os
from itertools import combinations

import numpy as np
import torch

from . import osd_cuda
from .osd_cuda import (_gather_pack, _to_int32, bp_residual, column_index,
                       eliminate_blocks, gather_pack)
from ..utils import telemetry

# Shots the order-w reprocess holds per OSD call in the engine's rounds.
# The reprocess runs on this slice in every chunk and basis, whether or not
# a shot needs it (no host read decides it); the pooled round's default
# chunk is its whole pool wherever that fits (engine.pooled_osd_chunk), so
# the slice then holds a basis's whole pool. The full-Jordan elimination
# inside is gated to the shots whose OSD-0 failed, but the flip search's
# PyTorch ops cost the slice's size (a (32, m, 78) parity table at
# [[144,12,12]], order 2). Physical syndromes almost never fail OSD-0 with
# the basis appended (0 rank-deficient shot-bases in every recorded run),
# so a small slice suffices; a chunk with more failures than it holds is
# flagged and its round replayed with the whole chunk as the slice.
REPROCESS_SLICE = 32

# The points after which ``osd_batch(..., stop_after=...)`` returns, in
# pipeline order: timing each prefix gives each stage's cost by difference
# (``scripts/osd_microbench.py``).
PREFIXES = ("residual", "sort", "stage1", "tail", "basis", "reprocess")

# The staged tail's and the basis rerun's shared-memory budget a block, in
# KB, read when ``osd_batch`` is called; unset: the eliminators' own plan.
# The counterpart of the JAX package's QLDPC_OSD_TAIL_MB (osd_batch below).
TAIL_BUDGET_ENV = "QLDPC_OSD_TAIL_SMEM_KB"


def auto_stage1(K: int) -> int:
    """``osd_batch``'s stage-1 width when ``stage1_cols`` is None: 768
    columns when K >= 2048, 256 when K >= 512, else 0 (single-stage)."""
    return 768 if K >= 2048 else 256 if K >= 512 else 0


def tail_smem_budget():
    """The tail budget in bytes from ``QLDPC_OSD_TAIL_SMEM_KB``, or None
    when it is unset (the plan's own rule)."""
    kb = os.environ.get(TAIL_BUDGET_ENV, "").strip()
    return int(kb) * 1024 if kb else None

_combo_cache: dict = {}


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


def _combos(num_test: int, order: int, dev) -> torch.Tensor:
    """:func:`_combo_masks` on ``dev``, copied there once."""
    key = (num_test, order, str(dev))
    if key not in _combo_cache:
        _combo_cache[key] = torch.as_tensor(_combo_masks(num_test, order),
                                            device=dev)
    return _combo_cache[key]


def _pack_columns(bits: torch.Tensor) -> torch.Tensor:
    """(..., K) 0/1 -> (..., K//32) int32, bit c of word w = column 32w+c."""
    K = bits.shape[-1]
    assert K % 32 == 0
    b = bits.to(torch.int64).reshape(*bits.shape[:-1], K // 32, 32)
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    return _to_int32((b << shifts).sum(-1))


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis of an int32 tensor (pairwise tree)."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], -1)
        x = x[..., 0::2] ^ x[..., 1::2]
    return x[..., 0]


def _span(lo, hi, dev) -> torch.Tensor:
    """[lo, hi) as the device int32 pair the kernels gate on; ``lo`` and
    ``hi`` are ints or 0-d tensors on ``dev`` (no host read)."""
    return torch.stack([
        x.reshape(()).to(torch.int32) if torch.is_tensor(x)
        else torch.full((), x, dtype=torch.int32, device=dev)
        for x in (lo, hi)])


def _merge(perm, take, old: tuple, new: tuple) -> tuple:
    """Outputs of a gated run over the batch permuted by ``perm`` merged
    back: shot ``perm[i]`` takes ``new[i]`` where ``take[i]``, else keeps
    its ``old`` value."""
    out = []
    for o, n_ in zip(old, new):
        t = take.view(-1, *([1] * (o.dim() - 1)))
        out.append(o.index_copy(0, perm, torch.where(t, n_, o[perm])))
    return tuple(out)


def osd_batch(H, HT, syndrome, llr, hard, K: int, order: int = 0,
              num_test: int = 0, use_blocks: bool = True, rank: int = None,
              basis_cols=None, logical_pack=None,
              return_solution: bool = True, stage1_cols: int = None,
              n_live=None, reprocess_slice: int = None, col_index=None,
              stop_after: str = None, residual=None):
    """Batched OSD post-processing of failed-BP shots.

    Args:
      H: (m, n) uint8 dense decoding matrix (class-level).
      HT: (n, m) float32 transpose of H (the residual's plain version).
      syndrome: (B, m) 0/1 target syndromes (unread when ``residual`` is
        given).
      llr: (B, n) f32 posterior LLRs from BP.
      hard: (B, n) int8 BP hard decisions (starting point).
      K: column budget for the elimination (multiple of 32 with basis_cols).
      order: OSD reprocessing order (0 = OSD-0 only).
      num_test: number of least-reliable non-pivot test positions
        (the reference uses order + 10; pass 0 with order=0).
      use_blocks: gather with G1 and eliminate with ``eliminate_blocks``
        (kernel K2 on CUDA tensors) through the staged scan; False runs
        ``_eliminate_xla``, the twin of the JAX package's XLA path, over
        prefix + basis (with host reads; off the engine's path).
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
      n_live: optional 0-d int tensor on the device: only the first
        ``n_live`` shots are decoded (use_blocks only); the outputs of the
        others are unspecified. None: all B.
      reprocess_slice: shots the order-w reprocess holds (the failed ones
        first); None = all B, which never overflows.
      col_index: the :class:`~qldpc_tpu_torch.ops.osd_cuda.ColumnIndex` of
        H that G1 and R1 read; None builds it here where a kernel needs it
        (a host copy of H: callers in a loop pass it).
      stop_after: one of :data:`PREFIXES`: return the stage's outputs (a
        tuple of tensors) right after it, for timing the pipeline's
        prefixes (use_blocks only past "sort"; "tail" is "stage1"'s when
        the scan is single-stage). None runs the whole OSD.
      residual: optional (B, m) int32, the BP residual syndrome
        ``syndrome ^ H @ hard`` as ``osd_cuda.bp_residual`` gives it (a
        caller that already computed it for these shots passes their rows);
        None computes it here, with R1 on CUDA tensors.

    The block shape (use_blocks): every eliminator launch asks
    ``osd_cuda.pick_block_shots`` for its shots a block at its width, where
    the JAX package's ``osd_batch`` asks ``osd_pallas.pick_block_shots``
    (stage 1, the tail, the unstaged prefix, the basis rerun, the
    full-Jordan reprocess), so a script can patch it as JAX's sweep does.
    The tail and the basis rerun pass the tail budget, read from
    ``QLDPC_OSD_TAIL_SMEM_KB`` at the call (:func:`tail_smem_budget`) as
    their ``smem_budget``; the other sites pass none. With neither set,
    ``pick_block_shots`` gives None and every launch takes the plan's own
    rule. The budget maps JAX's ``QLDPC_OSD_TAIL_MB`` (default 78; 26 MB
    elsewhere), the TPU VMEM its tail blocks of shots are sized against,
    to the card's terms: an H100 block holds at most
    ``_kernels.SMEM_PER_BLOCK`` (~227 KB) of shared memory, so a budget in
    MB has no meaning there, and the counterpart is the shared memory a
    tail block may take for its teams' columns, in KB. A budget of one
    team's columns gives one team a block; below it, the device-memory
    branch. Consumed outputs do not depend on the block shape.

    Telemetry (utils/telemetry.py): each step runs in its span,
    ``osd.prep`` (residual, unless given, with its counter
    ``osd.hard_ones``; reliability sort, the columns), ``osd.stage1``,
    ``osd.tail``, ``osd.basis`` (each step's G1 pack, eliminator and
    merge; a single-stage scan is ``osd.stage1``), ``osd.osd0`` (the
    OSD-0 scatter and validity), ``osd.reprocess`` (with the failed count
    ``osd.reprocess_failed``) and ``osd.delta``.

    Returns dict: solution (B, n) int8 (if return_solution), valid (B,) bool
    (syndrome exactly reproduced), rank_deficient (B,) bool,
    reprocess_overflow (B,) bool (OSD-0 failed and the reprocess slice did
    not hold the shot: its outputs are OSD-0's), logical_delta_packed (B,)
    int32 (if logical_pack is given)."""
    B, n = llr.shape
    m = H.shape[0]
    dev = llr.device
    i32 = torch.int32
    if not 0 < K <= n:
        raise ValueError(f"need 0 < K <= n={n}, got K={K}")
    Kp = -(-K // 32) * 32  # packed prefix width (zero-padded beyond K)
    lane = torch.arange(B, device=dev)
    live = None if n_live is None or not use_blocks else lane < n_live

    with telemetry.span("osd.prep"):
        # residual syndrome the correction must reproduce
        if residual is None:
            if col_index is None and dev.type == "cuda":
                col_index = column_index(H)
            residual = bp_residual(syndrome, hard, HT, col_index)[0]
        elif residual.shape != (B, m):
            raise ValueError(f"residual {tuple(residual.shape)}, need "
                             f"{(B, m)}")
        residual = residual.to(i32)                              # (B, m)
        if stop_after == "residual":
            return (residual,)
        if stop_after not in (None,) + PREFIXES or (
                not use_blocks and stop_after in ("stage1", "tail", "basis")):
            raise ValueError(f"stop_after={stop_after!r}")

        # reliability ordering (stable: ties keep column order)
        order_idx = torch.sort(llr.abs(), dim=1, stable=True).indices
        colsK = order_idx[:, :K]
        lp_sorted = (logical_pack.to(i32)[order_idx]
                     if logical_pack is not None else None)
        if stop_after == "sort":
            return residual, colsK

        if basis_cols is not None and K == n:
            basis_cols = None  # full-width prefix: nothing left to complete
        if basis_cols is not None:
            if K % 32:
                raise ValueError("basis_cols requires K % 32 == 0")
            basis_cols = basis_cols.to(device=dev, dtype=torch.int64)
            R = basis_cols.shape[0]
            # K % 32 == 0: the basis columns start a word
            colsE = torch.cat([colsK, basis_cols[None].expand(B, R)], 1)
            KT = K + R
            if lp_sorted is not None:
                lp_perm = torch.cat(
                    [lp_sorted[:, :K],
                     logical_pack.to(i32)[basis_cols][None].expand(B, R)], 1)
        else:
            colsE = colsK
            KT = K
            if lp_sorted is not None:
                lp_perm = lp_sorted[:, :K]
        KTp = -(-KT // 32) * 32

    def pad_prow(p):
        return torch.cat([p, torch.full((p.shape[0], KT - p.shape[1]), -1,
                                        dtype=i32, device=dev)], 1)

    if use_blocks:
        if col_index is None:
            col_index = column_index(H)

        def pack(cols, Kx, span):
            """G1 over the first Kx of ``cols`` in the eliminator's column
            layout, gated to ``span``: a fresh tensor, which the
            eliminator consumes."""
            return gather_pack(col_index, cols[:, :min(Kx, cols.shape[1])],
                               Kx, live=span)

        tail_budget = tail_smem_budget()

        def eliminate(Hp, s, Kx, span, budget=None, **kw):
            """The eliminator on ``pack``'s output, gated to ``span``, in
            the block shape ``osd_cuda.pick_block_shots`` gives at its
            width under ``budget``; the reduced matrix only where
            ``want_matrix`` is passed."""
            kw.setdefault("want_matrix", False)
            shots = osd_cuda.pick_block_shots(m, -(-Kx // 32),
                                              smem_budget=budget)
            return eliminate_blocks(Hp, s, Kx, m, rank=rank, live=span,
                                    block_shots=shots, smem_budget=budget,
                                    **kw)

        if stage1_cols is None:
            stage1_cols = auto_stage1(K)
        staged = bool(stage1_cols) and stage1_cols < K
        span = None if live is None else _span(0, n_live, dev)
        if staged:
            # --- staged scan: narrow stage-1 + full-prefix tail ---
            K1 = stage1_cols
            with telemetry.span("osd.stage1"):
                _, s1, prow1, used1, cf1 = eliminate(
                    pack(colsK, -(-K1 // 32) * 32, span), residual, K1, span)
            if stop_after == "stage1":
                return s1, prow1, used1, cf1
            with telemetry.span("osd.tail"):
                covered = torch.where(used1, 0, s1).sum(1) == 0
                if live is not None:
                    covered |= ~live
                prow1 = pad_prow(prow1)
                # coverage sort (stable): uncovered shots form a contiguous
                # tail, which starts at a 32-shot boundary as in the JAX
                # scan (boundary shots already covered are rescanned; their
                # consumed outputs are unchanged). One gated launch covers
                # the tail.
                order2 = torch.sort((~covered).to(i32), stable=True).indices
                c_start = (B - (~covered).sum()) // 32 * 32
                span2 = _span(c_start, B, dev)
                _, s2, prow2, used2, cf2 = eliminate(
                    pack(colsK[order2], Kp, span2), residual[order2], K,
                    span2, tail_budget)
                s1, prow1, used1, cf1 = _merge(
                    order2, lane >= c_start, (s1, prow1, used1, cf1),
                    (s2, pad_prow(prow2), used2, cf2))
        else:
            with telemetry.span("osd.stage1"):
                _, s1, prow1, used1, cf1 = eliminate(
                    pack(colsK, Kp, span), residual, K, span)
                prow1 = pad_prow(prow1)
        if stop_after in ("stage1", "tail"):
            return s1, prow1, used1, cf1
        if basis_cols is not None:
            # basis completion: shots the prefix left uncovered, sorted
            # first, rerun at full width (prefix + basis words); the others
            # keep their prefix outputs (the full-width run is
            # consumed-identical)
            with telemetry.span("osd.basis"):
                bad = torch.where(used1, 0, s1).sum(1) != 0
                if live is not None:
                    bad &= live
                perm = torch.sort((~bad).to(i32), stable=True).indices
                nbad = bad.sum()
                span3 = _span(0, nbad, dev)
                _, s2, prow2, used2, cf2 = eliminate(
                    pack(colsE[perm], KTp, span3), residual[perm], KT, span3,
                    tail_budget)
                s1, prow1, used1, cf1 = _merge(perm, lane < nbad,
                                               (s1, prow1, used1, cf1),
                                               (s2, prow2, used2, cf2))
        if stop_after == "basis":
            return s1, prow1, used1, cf1
        s_red, prow_of_col, used, cf = s1, prow1, used1, cf1

        def reduced_for_reprocess(idx, span_r):
            """Full Gauss-Jordan of the shots ``idx`` at full width, gated
            to ``span_r``: (S, m, W)."""
            hp_full = eliminate(
                pack(colsE[idx], KTp, span_r), residual[idx], KT, span_r,
                full_jordan=True, want_matrix=True)[0]
            return hp_full.transpose(1, 2)
    else:
        HT_u8 = H.T.contiguous()
        Hp = _gather_pack(HT_u8, colsK, Kp)                      # (B, m, W)
        if basis_cols is not None:
            Hb_bits = torch.zeros((m, KTp - K), dtype=torch.uint8,
                                  device=dev)
            Hb_bits[:, :KT - K] = H[:, basis_cols]
            Hb_words = _pack_columns(Hb_bits)                    # (m, Wb)
            Hp = torch.cat([Hp, Hb_words[None].expand(B, *Hb_words.shape)],
                           -1)
        Hp, s_red, used, prow_of_col = _eliminate_xla(Hp, residual, KT, m, B)

        def reduced_for_reprocess(idx, span_r):
            return Hp[idx]

    with telemetry.span("osd.osd0"):
        if use_blocks:
            # OSD-0 correction scattered from row space: e0[colofrow[r]] =
            # s_red[r] for pivot rows; unused rows dump into slot KT
            tgt = torch.where(used, cf.long(), KT)
            e0_perm = torch.zeros((B, KT + 1), dtype=i32,
                                  device=dev).scatter_(1, tgt, s_red)[:, :KT]
        else:
            e0_perm = torch.where(
                prow_of_col >= 0,
                s_red.gather(1, prow_of_col.clamp(min=0).long()), 0)
        is_pivot = prow_of_col >= 0                              # (B, KT)
        # validity: un-pivoted rows must carry zero reduced syndrome
        unsat0 = torch.where(used, 0, s_red).sum(1)
        valid0 = unsat0 == 0
        rank_deficient = ~valid0

    e_perm, valid = e0_perm.to(i32), valid0
    overflow = torch.zeros(B, dtype=torch.bool, device=dev)
    if order > 0 and num_test > 0:
        # the order-w search on the failed shots, sorted first into a slice
        # of S shots (JAX's small-slice rule); _reprocess keeps OSD-0 for
        # the valid shots the slice also holds
        with telemetry.span("osd.reprocess"):
            failed = ~valid0 if live is None else ~valid0 & live
            S = (B if reprocess_slice is None
                 else max(0, min(reprocess_slice, B)))
            overflow = failed & (torch.cumsum(failed.to(i32), 0) > S)
            if S:
                n_failed = failed.sum()
                telemetry.count("osd.reprocess_failed", n_failed)
                idx = torch.sort((~failed).to(i32), stable=True).indices[:S]
                Hp_full = reduced_for_reprocess(idx, _span(0, n_failed, dev))
                e_r, valid_r = _reprocess(
                    Hp_full, s_red[idx], used[idx], prow_of_col[idx],
                    is_pivot[idx], e0_perm[idx], valid0[idx], llr[idx],
                    hard[idx], colsE[idx], order, num_test, S, KT, m)
                e_perm = e_perm.index_copy(0, idx, e_r)
                valid = valid.index_copy(0, idx, valid_r)
    if stop_after == "reprocess":
        return e_perm, valid, overflow

    out = dict(valid=valid, rank_deficient=rank_deficient,
               reprocess_overflow=overflow)
    if logical_pack is not None:
        with telemetry.span("osd.delta"):
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

    combos = _combos(num_test, order, dev)
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
