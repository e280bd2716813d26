"""Batched bit-packed GF(2) elimination: CUDA kernels K2, K4, K5 and their
plain twins.

``eliminate_blocks`` has the signature and outputs of the JAX package's
``osd_pallas.eliminate_blocks`` without its TPU block sizing. It dispatches
on ``_KERNEL_VERSION``, read from ``QLDPC_OSD_KERNEL`` (default 1) as the JAX
package reads it, and set on this module to switch at run time:

  1 -> ``eliminate_blocks_v1``: kernel K2 (``csrc/gf2_elim.cu``), a team
       of warps per shot over column bitsets, exit tested after every
       column.
  2 -> ``eliminate_blocks_fused``: kernel K4 (``csrc/gf2_elim_fused.cu``),
       four pivots chosen per fused tail update, exit tested once per
       4-column group.
  3 -> ``eliminate_blocks_pair``: kernel K5 (``csrc/gf2_elim_pair.cu``),
       two shots per thread block advancing through one column loop, each
       exiting on its own.

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs its
plain version on a CPU tensor: ``eliminate_blocks_plain`` for K2 and K5
(K5 computes exactly K2's per-shot function), ``eliminate_blocks_fused_plain``
for K4.

Words travel as int32 (bit c of word w = column 32w + c): PyTorch's uint32
support is thin, and ``(w >> b) & 1`` is exact after an arithmetic shift.

Exit points: with ``exit_on_valid=True`` a shot stops once its residual
syndrome lies in its pivot span, so ``prow_of_col``, ``used``, ``colofrow``
and the reduced matrix depend on where it stopped; ``s_red``, the OSD-0
bits, validity and the logical delta do not. K4 tests the exit once per
4-column group, so it may stop up to 3 columns after K2; with
``exit_on_valid=False`` all three versions give every output of the full
scan. Each kernel exits at the same column as its plain version for every
shot, so the two agree on every output either way.
"""
from __future__ import annotations

import ctypes
import os

import torch

from .. import _kernels

_SMEM_LIMIT = _kernels.SMEM_PER_BLOCK - 1024  # dynamic bytes a block takes
_MAX_ROWS_PER_THREAD = 4     # GF2_MAXR in csrc/gf2_elim_{fused,pair}.cu
_K2_MAX_ROWS = 32 * 32 * 4   # 32 lanes x GF2_MAXR words of 32 rows (K2)
_FUSED_GROUP = 4             # columns per K4 group (GF2_GROUP)
K2_RANGE = "K2 launch"       # profiler range of each K2 launch, by width

# Eliminator generation, as osd_pallas._KERNEL_VERSION in the JAX package.
_KERNEL_VERSION = int(os.environ.get("QLDPC_OSD_KERNEL", "1"))


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
    Runs the eliminator ``_KERNEL_VERSION`` selects (module docstring)."""
    fn = _ELIMINATORS.get(_KERNEL_VERSION)
    if fn is None:
        raise ValueError(f"QLDPC_OSD_KERNEL={_KERNEL_VERSION}: the "
                         f"eliminator versions are {sorted(_ELIMINATORS)}")
    return fn(Hp, s, K, m, rank, full_jordan, exit_on_valid, return_steps)


def _launch(wrapper, lib_name: str, fn_name: str, plain, Hp, s, K, m, rank,
            full_jordan, exit_on_valid, return_steps):
    """Shared body of the K4 and K5 wrappers: the plain version on a CPU
    tensor, else one launch of ``fn_name`` from ``csrc/<lib_name>.cu``
    (same C signature for both kernels), counted on ``wrapper``."""
    _check_inputs(Hp, s, K, m)
    if Hp.device.type == "cpu":
        return plain(Hp, s, K, m, rank, full_jordan, exit_on_valid,
                     return_steps)
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
    code = getattr(_lib(lib_name), fn_name)(
        out_hp.data_ptr(), out_s.data_ptr(), cf.data_ptr(), steps.data_ptr(),
        B, W, M, m, K, m if rank is None else rank, int(full_jordan),
        int(exit_on_valid), threads, _SMEM_LIMIT,
        _kernels.stream_ptr(Hp.device))
    _kernels.check(code, fn_name)
    wrapper.launches += 1
    out = (out_hp, out_s, prow_of_col_from(cf, K), cf >= 0, cf)
    return out + (steps,) if return_steps else out


def eliminate_blocks_v1(Hp, s, K: int, m: int, rank: int = None,
                        full_jordan: bool = False, exit_on_valid: bool = True,
                        return_steps: bool = False):
    """Kernel K2 (``csrc/gf2_elim.cu``: a team of warps per shot over
    column bitsets); arguments and outputs as :func:`eliminate_blocks`. s
    holds 0/1 bits. ``eliminate_blocks_v1.launches`` counts the kernel
    launches."""
    _check_inputs(Hp, s, K, m)
    if Hp.device.type == "cpu":
        return eliminate_blocks_plain(Hp, s, K, m, rank, full_jordan,
                                      exit_on_valid, return_steps)
    launch, finish = prepare_elim_launch(Hp, s, K, m, rank, full_jordan,
                                         exit_on_valid)
    launch()
    return finish(return_steps)


def prepare_elim_launch(Hp, s, K: int, m: int, rank: int = None,
                        full_jordan: bool = False,
                        exit_on_valid: bool = True):
    """K2 on CUDA tensors, prepared but not launched: input casts, output
    and slab allocation, library load. Returns (launch, finish): each
    ``launch()`` runs the kernel once from the unchanged inputs (it writes
    its outputs apart from them), inside a ``torch.profiler`` range named
    ``K2_RANGE`` with the width, and counts it on ``eliminate_blocks_v1``;
    ``finish(return_steps)`` gives :func:`eliminate_blocks`'s outputs. A
    caller can so time the kernel alone."""
    _check_inputs(Hp, s, K, m)
    if Hp.device.type != "cuda":
        raise ValueError(f"unsupported device {Hp.device}")
    B, W, M = Hp.shape
    if M > _K2_MAX_ROWS:
        raise ValueError(f"M={M} rows exceed the kernel's {_K2_MAX_ROWS}")
    dev = Hp.device
    hp_in = Hp.to(torch.int32).contiguous()
    s_in = s.to(device=dev, dtype=torch.int32).contiguous()
    hp_out = torch.empty_like(hp_in)
    s_out = torch.empty_like(s_in)
    cf = torch.empty((B, M), dtype=torch.int32, device=dev)
    steps = torch.empty((B,), dtype=torch.int32, device=dev)
    sizes = elim_sizes(W, M)
    slab = None
    if sizes["device_memory"]:  # the kernel's rule: the columns in a slab
        slab = torch.empty((B, sizes["shot_bytes"]), dtype=torch.uint8,
                           device=dev)
    fn = _k2_lib().gf2_elim_launch
    args = (B, W, M, m, K, m if rank is None else rank, int(full_jordan),
            int(exit_on_valid), _SMEM_LIMIT)
    label = f"{K2_RANGE}: {W} words" + (", full_jordan" if full_jordan
                                        else "")

    def launch():
        # the inputs and the slab stay referenced by this closure
        with torch.profiler.record_function(label):
            code = fn(hp_in.data_ptr(), hp_out.data_ptr(), s_in.data_ptr(),
                      s_out.data_ptr(), cf.data_ptr(), steps.data_ptr(),
                      None if slab is None else slab.data_ptr(), *args,
                      _kernels.stream_ptr(dev))
        _kernels.check(code, "gf2_elim_launch")
        eliminate_blocks_v1.launches += 1

    def finish(return_steps: bool = False):
        out = (hp_out, s_out, prow_of_col_from(cf, K), cf >= 0, cf)
        return out + (steps,) if return_steps else out

    return launch, finish


def _k2_lib():
    lib = _kernels.load("gf2_elim")
    if not lib.gf2_elim_launch.argtypes:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.gf2_elim_launch.argtypes = [P] * 7 + [I] * 9 + [P]
        lib.gf2_elim_launch.restype = I
        lib.gf2_elim_sizes.argtypes = [I, I, I, P]
        lib.gf2_elim_sizes.restype = I
        lib.gf2_elim_info.argtypes = [I] * 4 + [P]
        lib.gf2_elim_info.restype = I
    return lib


def elim_sizes(W: int, M: int) -> dict:
    """K2's layout of one shot of W words by M rows, as csrc/gf2_elim.cu
    reports it: its column bytes (the device-memory slab takes this much a
    shot), the column stride in words, the row words a lane holds, and
    whether the columns go to the device-memory slab (they exceed
    ``_SMEM_LIMIT``)."""
    out = (ctypes.c_longlong * 4)()
    _kernels.check(_k2_lib().gf2_elim_sizes(W, M, _SMEM_LIMIT, out),
                   "gf2_elim_sizes")
    return dict(shot_bytes=out[0], column_stride=out[1],
                words_per_lane=out[2], device_memory=bool(out[3]))


def elim_launch_info(B: int, W: int, M: int, device) -> dict:
    """K2's shape on the card for B shots of W words by M rows: registers
    and spilled bytes a thread, column bytes a shot and where they live,
    warps a shot, shots a block, shared memory a block, blocks, and blocks
    and shots resident per SM."""
    out = (ctypes.c_int * 8)()
    with torch.cuda.device(device):
        _kernels.check(_k2_lib().gf2_elim_info(B, W, M, _SMEM_LIMIT, out),
                       "gf2_elim_info")
    return dict(elim_sizes(W, M), registers=out[0], local_bytes=out[1],
                shots_per_block=out[2], smem_bytes=out[3],
                columns_in="device memory" if out[4] else "shared memory",
                warps_per_shot=out[7], blocks=out[5], blocks_per_sm=out[6],
                shots_per_sm=out[6] * out[2])


def eliminate_blocks_fused(Hp, s, K: int, m: int, rank: int = None,
                           full_jordan: bool = False,
                           exit_on_valid: bool = True,
                           return_steps: bool = False):
    """Kernel K4 (``csrc/gf2_elim_fused.cu``): K2's function with the
    pivots of each 4-column group chosen one after another on their word
    and applied to the remaining words in one fused pass, the exit tested
    once per group. ``eliminate_blocks_fused.launches`` counts the kernel
    launches."""
    return _launch(eliminate_blocks_fused, "gf2_elim_fused",
                   "gf2_elim_fused_launch", eliminate_blocks_fused_plain,
                   Hp, s, K, m, rank, full_jordan, exit_on_valid,
                   return_steps)


def eliminate_blocks_pair(Hp, s, K: int, m: int, rank: int = None,
                          full_jordan: bool = False,
                          exit_on_valid: bool = True,
                          return_steps: bool = False):
    """Kernel K5 (``csrc/gf2_elim_pair.cu``): K2's per-shot function with
    two shots per thread block; every output equals K2's.
    ``eliminate_blocks_pair.launches`` counts the kernel launches."""
    return _launch(eliminate_blocks_pair, "gf2_elim_pair",
                   "gf2_elim_pair_launch", eliminate_blocks_plain, Hp, s, K,
                   m, rank, full_jordan, exit_on_valid, return_steps)


for _fn in (eliminate_blocks_v1, eliminate_blocks_fused,
            eliminate_blocks_pair):
    _fn.launches = 0
_ELIMINATORS = {1: eliminate_blocks_v1, 2: eliminate_blocks_fused,
                3: eliminate_blocks_pair}


def _lib(name: str):
    lib = _kernels.load(name)
    fn = getattr(lib, f"{name}_launch")
    if not fn.argtypes:
        P = ctypes.c_void_p
        fn.argtypes = [P] * 4 + [ctypes.c_int] * 10 + [P]
        fn.restype = ctypes.c_int
    return lib


def eliminate_blocks_plain(Hp, s, K: int, m: int, rank: int = None,
                           full_jordan: bool = False,
                           exit_on_valid: bool = True,
                           return_steps: bool = False,
                           count_xor_words: bool = False):
    """Plain PyTorch version of kernels K2 and K5: the same per-shot column
    steps, vectorized over shots, each shot frozen once it is done. One
    host read per column step.

    ``count_xor_words`` appends a (B,) int64 count of the word XORs the
    steps did: per step, the rows the pivot row was XORed into times the
    words it updated (those from the pivot's word on, or all of them under
    ``full_jordan``). It measures the elimination's data-dependent work for
    the kernels' operation bound; the decode path never asks for it."""
    return _eliminate_plain(Hp, s, K, m, rank, full_jordan, exit_on_valid,
                            return_steps, group=1,
                            count_xor_words=count_xor_words)


def eliminate_blocks_fused_plain(Hp, s, K: int, m: int, rank: int = None,
                                 full_jordan: bool = False,
                                 exit_on_valid: bool = True,
                                 return_steps: bool = False):
    """Plain PyTorch version of kernel K4: K2's column steps, with the exit
    (rank reached, or residual inside the pivot span) tested only at the
    end of each 4-column group, and the columns of the last group at or
    beyond K never pivoting. ``steps`` counts the columns of the groups a
    shot ran, at most K."""
    return _eliminate_plain(Hp, s, K, m, rank, full_jordan, exit_on_valid,
                            return_steps, group=_FUSED_GROUP)


def _eliminate_plain(Hp, s, K, m, rank, full_jordan, exit_on_valid,
                     return_steps, group: int, count_xor_words: bool = False):
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
    active = ~done
    npiv = torch.zeros(B, dtype=torch.int32, device=dev)
    steps = torch.zeros(B, dtype=torch.int32, device=dev)
    xor_words = torch.zeros(B, dtype=torch.int64, device=dev)
    for col in range(-(-K // group) * group):
        if col % group == 0:
            if bool(done.all()):
                break
            active = ~done
            steps += active.to(torch.int32) * min(group, K - col)
        if col < K:
            w, bit = col // 32, col % 32
            colbits = ((Hp[:, w, :] >> bit) & 1) == 1           # (B, M)
            cand = colbits & (cf < 0) & valid & active[:, None]
            piv = torch.where(cand, lane, M).amin(1)            # (B,)
            has = piv < M
            pivc = piv.clamp(max=M - 1)
            pivmask = (lane == piv[:, None]) & has[:, None]
            w0 = 0 if full_jordan else w
            tail = Hp[:, w0:, :]
            prow = tail[bidx, :, pivc]                          # (B, W-w0)
            ps = s[bidx, pivc]
            elim = colbits & ~pivmask & has[:, None]
            Hp[:, w0:, :] = torch.where(elim[:, None, :],
                                        tail ^ prow[:, :, None], tail)
            s = torch.where(elim, s ^ ps[:, None], s)
            if count_xor_words:
                xor_words += elim.sum(1) * (W - w0)
            cf = torch.where(pivmask, col, cf)
            npiv += has.to(torch.int32)
        if (col + 1) % group == 0:
            shot_done = npiv >= rank
            if exit_on_valid:
                shot_done |= ~((cf < 0) & valid & (s != 0)).any(1)
            done = done | shot_done
    out = (Hp, s, prow_of_col_from(cf, K), cf >= 0, cf)
    if return_steps:
        out += (steps,)
    return out + (xor_words,) if count_xor_words else out
