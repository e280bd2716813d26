"""Batched bit-packed GF(2) elimination: CUDA kernel K2 and its plain twin.

``eliminate_blocks`` has the signature and outputs of the JAX package's
``osd_pallas.eliminate_blocks`` without its TPU block sizing: every shot is
one CUDA thread block (``csrc/gf2_elim.cu``) and exits on its own. On a CUDA
tensor it launches the kernel or raises; on a CPU tensor it runs
``eliminate_blocks_plain``.

Words travel as int32 (bit c of word w = column 32w + c): PyTorch's uint32
support is thin, and ``(w >> b) & 1`` is exact after an arithmetic shift.

Exit points: with ``exit_on_valid=True`` a shot stops once its residual
syndrome lies in its pivot span, so ``prow_of_col``, ``used``, ``colofrow``
and the reduced matrix depend on where it stopped; ``s_red``, the OSD-0
bits, validity and the logical delta do not. With ``exit_on_valid=False``
every output equals the full scan. The kernel and the plain version exit at
the same column for every shot, so they agree on every output either way.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _kernels

_SMEM_LIMIT = 232448 - 1024  # dynamic shared bytes a block may take
_MAX_ROWS_PER_THREAD = 4     # GF2_MAXR in csrc/gf2_elim.cu


def _check_inputs(Hp, s, K: int, m: int):
    if Hp.dim() != 3 or s.dim() != 2 or s.shape != (Hp.shape[0], Hp.shape[2]):
        raise ValueError(f"need Hp (B, W, M) and s (B, M); got "
                         f"{tuple(Hp.shape)} and {tuple(s.shape)}")
    B, W, M = Hp.shape
    if K > 32 * W or m > M:
        raise ValueError(f"K={K} exceeds 32*W={32 * W} or m={m} > M={M}")


def prow_of_col_from(colofrow, K: int):
    """Invert row -> column (colofrow) into prow_of_col (B, K), -1 where a
    column did not pivot."""
    B, M = colofrow.shape
    used = colofrow >= 0
    lane = torch.arange(M, device=colofrow.device).expand(B, M)
    target = torch.where(used, colofrow.long(), K)       # dump slot K
    prow = torch.full((B, K + 1), -1, dtype=torch.int32,
                      device=colofrow.device)
    prow.scatter_(1, target, lane.to(torch.int32))
    return prow[:, :K]


def eliminate_blocks(Hp, s, K: int, m: int, rank: int = None,
                     full_jordan: bool = False, exit_on_valid: bool = True,
                     return_steps: bool = False):
    """Batched elimination. Hp (B, W, M) int32 words (M >= m rows; rows at
    or beyond m never pivot), s (B, M) int32 residual syndrome.

    Returns (Hp_reduced (B, W, M), s_reduced (B, M), prow_of_col (B, K),
    used (B, M) bool, colofrow (B, M)), plus steps (B,) int32 — the column
    steps each shot ran — when ``return_steps``.

    full_jordan=False skips already-passed words: s_reduced, prow_of_col,
    used and all pivot columns equal full Gauss-Jordan; dependent columns
    left of a pivot's word stay stale. full_jordan=True reduces them too.
    ``eliminate_blocks.launches`` counts the kernel launches."""
    _check_inputs(Hp, s, K, m)
    if Hp.device.type == "cpu":
        return eliminate_blocks_plain(Hp, s, K, m, rank, full_jordan,
                                      exit_on_valid, return_steps)
    if Hp.device.type != "cuda":
        raise ValueError(f"unsupported device {Hp.device}")
    B, W, M = Hp.shape
    threads = min(1024, max(32, -(-M // 32) * 32))
    if M > threads * _MAX_ROWS_PER_THREAD:
        raise ValueError(f"M={M} rows exceed the kernel's "
                         f"{threads * _MAX_ROWS_PER_THREAD}")
    out_hp = Hp.to(torch.int32).contiguous().clone()
    out_s = s.to(device=Hp.device, dtype=torch.int32).contiguous().clone()
    cf = torch.empty((B, M), dtype=torch.int32, device=Hp.device)
    steps = torch.empty((B,), dtype=torch.int32, device=Hp.device)
    code = _lib().gf2_elim_launch(
        out_hp.data_ptr(), out_s.data_ptr(), cf.data_ptr(), steps.data_ptr(),
        B, W, M, m, K, m if rank is None else rank, int(full_jordan),
        int(exit_on_valid), threads, _SMEM_LIMIT,
        _kernels.stream_ptr(Hp.device))
    _kernels.check(code, "gf2_elim_kernel")
    eliminate_blocks.launches += 1
    out = (out_hp, out_s, prow_of_col_from(cf, K), cf >= 0, cf)
    return out + (steps,) if return_steps else out


eliminate_blocks.launches = 0


def _lib():
    lib = _kernels.load("gf2_elim")
    fn = lib.gf2_elim_launch
    if not fn.argtypes:
        P = ctypes.c_void_p
        fn.argtypes = [P] * 4 + [ctypes.c_int] * 10 + [P]
        fn.restype = ctypes.c_int
    return lib


def eliminate_blocks_plain(Hp, s, K: int, m: int, rank: int = None,
                           full_jordan: bool = False,
                           exit_on_valid: bool = True,
                           return_steps: bool = False):
    """Plain PyTorch version of kernel K2: the same per-shot column steps,
    vectorized over shots, each shot frozen once it is done. One host read
    per column step."""
    _check_inputs(Hp, s, K, m)
    B, W, M = Hp.shape
    dev = Hp.device
    rank = m if rank is None else rank
    Hp = Hp.to(torch.int32).clone()
    s = s.to(device=dev, dtype=torch.int32).clone()
    cf = torch.full((B, M), -1, dtype=torch.int32, device=dev)
    lane = torch.arange(M, device=dev)[None]
    valid = lane < m
    bidx = torch.arange(B, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    if exit_on_valid:
        done = ~((s != 0) & valid).any(1)
    npiv = torch.zeros(B, dtype=torch.int32, device=dev)
    steps = torch.zeros(B, dtype=torch.int32, device=dev)
    for col in range(K):
        if bool(done.all()):
            break
        steps += (~done).to(torch.int32)
        w, bit = col // 32, col % 32
        colbits = ((Hp[:, w, :] >> bit) & 1) == 1               # (B, M)
        cand = colbits & (cf < 0) & valid & ~done[:, None]
        piv = torch.where(cand, lane, M).amin(1)                # (B,)
        has = piv < M
        pivc = piv.clamp(max=M - 1)
        pivmask = (lane == piv[:, None]) & has[:, None]
        w0 = 0 if full_jordan else w
        tail = Hp[:, w0:, :]
        prow = tail[bidx, :, pivc]                              # (B, W-w0)
        ps = s[bidx, pivc]
        elim = colbits & ~pivmask & has[:, None]
        Hp[:, w0:, :] = torch.where(elim[:, None, :], tail ^ prow[:, :, None],
                                    tail)
        s = torch.where(elim, s ^ ps[:, None], s)
        cf = torch.where(pivmask, col, cf)
        npiv += has.to(torch.int32)
        shot_done = npiv >= rank
        if exit_on_valid:
            shot_done |= ~((cf < 0) & valid & (s != 0)).any(1)
        done = done | shot_done
    out = (Hp, s, prow_of_col_from(cf, K), cf >= 0, cf)
    return out + (steps,) if return_steps else out
