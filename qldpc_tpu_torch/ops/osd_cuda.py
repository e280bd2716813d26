"""Batched bit-packed GF(2) elimination: CUDA kernels K2, K4, K5 and their
plain twins; and the gather-pack that builds their input, kernel G1.

``eliminate_blocks`` has the signature and outputs of the JAX package's
``osd_pallas.eliminate_blocks`` without its TPU block sizing. It dispatches
on ``_KERNEL_VERSION``, read from ``QLDPC_OSD_KERNEL`` (default 1) as the JAX
package reads it, and set on this module to switch at run time:

  1 -> ``eliminate_blocks_v1``: kernel K2 (``csrc/gf2_elim.cu``), a team
       of warps per shot over column bitsets, exit tested after every
       column.
  2 -> ``eliminate_blocks_fused``: kernel K4 (``csrc/gf2_elim_fused.cu``),
       K2's layout, four pivots per team barrier and one fused tail pass
       per 4-column group, exit tested once per group.
  3 -> ``eliminate_blocks_pair``: kernel K5 (``csrc/gf2_elim_pair.cu``),
       K2's layout, two shots through one team of warps, each exiting on
       its own.

All three share the column-bitset layout, the plan and the host entry
points (``csrc/gf2_elim_common.cuh``) and one Python launch path
(:func:`prepare_elim_launch`): a device-memory slab where a team's columns
exceed ``_SMEM_LIMIT``, a ``torch.profiler`` range per launch named with
the kernel and the width (``K2_RANGE``, ``K4_RANGE``, ``K5_RANGE``), and
the launch count on the wrapper.

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs its
plain version on a CPU tensor: ``eliminate_blocks_plain`` for K2 and K5
(K5 computes exactly K2's per-shot function), ``eliminate_blocks_fused_plain``
for K4.

Words travel as int32 (bit c of word w = column 32w + c): PyTorch's uint32
support is thin, and ``(w >> b) & 1`` is exact after an arithmetic shift.

The gate: every eliminator and G1 take ``live``, a device int32 pair
``[lo, hi)`` of the batch's live shots (None: every shot). The launch
covers the whole batch and the kernel reads the pair, so no host read sizes
it; a shot outside the range leaves at once. Its eliminator outputs are
unspecified except ``colofrow`` (-1: no pivot), ``used``, ``prow_of_col``
and ``steps`` (0), and its G1 words are left unwritten; the OSD
(ops/osd.py) never consumes them. The plain versions read the pair with
``int()`` and run the live slice (gated-off shots keep their inputs, G1's
read zero).

G1 (``gather_pack``, ``csrc/gather_pack.cu``) writes
``_gather_pack(..., words_major=True)``'s (B, Kp/32, m) layout from a CSC
copy of the decoding matrix (:class:`ColumnIndex`, built once a matrix);
``_gather_pack``, the dense port of the JAX package's XLA gather-pack, is
its plain version.

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
import dataclasses
import os

import numpy as np
import torch

from .. import _kernels

_SMEM_LIMIT = _kernels.SMEM_PER_BLOCK - 1024  # dynamic bytes a block takes
_MAX_ROWS = 32 * 32 * 4      # 32 lanes x GF2_MAXR words of 32 rows
_FUSED_GROUP = 4             # columns per K4 group (GF2_GROUP)
# profiler range of each launch, named with the width, by kernel
K2_RANGE, K4_RANGE, K5_RANGE = "K2 launch", "K4 launch", "K5 launch"
# each kernel's library (csrc/<name>.cu, exporting <name>_launch, _sizes and
# _info), the shots a team carries, and its profiler range
_ELIM_KERNELS = {"K2": ("gf2_elim", 1, K2_RANGE),
                 "K4": ("gf2_elim_fused", 1, K4_RANGE),
                 "K5": ("gf2_elim_pair", 2, K5_RANGE)}

# Eliminator generation, as osd_pallas._KERNEL_VERSION in the JAX package.
_KERNEL_VERSION = int(os.environ.get("QLDPC_OSD_KERNEL", "1"))


@dataclasses.dataclass(frozen=True)
class ColumnIndex:
    """A decoding matrix's columns as G1 reads them: the CSC form (each
    column's rows) on the device, and the dense (n, m) uint8 transpose that
    the plain version gathers from."""

    HT: torch.Tensor      # (n, m) uint8
    colptr: torch.Tensor  # (n + 1,) int32: column j's rows at [colptr[j],
    rows: torch.Tensor    # (nnz,) int32      colptr[j + 1]) of rows
    m: int


def column_index(H, device=None) -> ColumnIndex:
    """The :class:`ColumnIndex` of a (m, n) 0/1 matrix (numpy or a tensor),
    on ``device`` (default: the tensor's own, else the CPU). Built once a
    decoding matrix: it copies H to the host."""
    if device is None:
        device = H.device if torch.is_tensor(H) else torch.device("cpu")
    Hn = (H.cpu().numpy() if torch.is_tensor(H) else np.asarray(H)) != 0
    n = Hn.shape[1]
    col, row = np.nonzero(Hn.T)          # column-major: by column, then row
    colptr = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(col, minlength=n), out=colptr[1:])
    return ColumnIndex(
        HT=torch.as_tensor(np.ascontiguousarray(Hn.T, np.uint8),
                           device=device),
        colptr=torch.as_tensor(colptr, device=device),
        rows=torch.as_tensor(row.astype(np.int32), device=device),
        m=Hn.shape[0])


def _live_bounds(live, B: int) -> tuple:
    """[lo, hi) of a ``live`` pair clamped to [0, B) (a host read: the
    plain versions only)."""
    if live is None:
        return 0, B
    lo, hi = (int(v) for v in live.tolist())
    lo = min(max(lo, 0), B)
    return lo, max(lo, min(hi, B))


def _check_live(live, dev):
    if live is not None and (live.dtype != torch.int32 or live.numel() != 2
                             or live.device != dev
                             or not live.is_contiguous()):
        raise ValueError(f"live must be a contiguous (2,) int32 tensor on "
                         f"{dev}, got {live.dtype} {tuple(live.shape)} on "
                         f"{live.device}")


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding 32-bit patterns in [0, 2^32) -> int32, same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _gather_pack(HT_u8, colsK, Kp: int, chunk: int = 256,
                 words_major: bool = False) -> torch.Tensor:
    """Per-shot column gather + bit-pack from the (n, m) uint8 transpose of
    H, chunked over columns so the unpacked gather never exceeds
    (B, chunk, m) bytes. Columns past K (up to Kp) pack as zeros. The port
    of the JAX package's ``osd._gather_pack``, and G1's plain version.

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


def gather_pack(index: ColumnIndex, cols, Kp: int, live=None):
    """Kernel G1 (``csrc/gather_pack.cu``): each shot's columns ``cols``
    (B, K) of the matrix behind ``index``, K <= Kp, bit-packed into the
    eliminators' (B, Kp/32, m) int32 words-major layout (bit c of word w at
    row r is H[r, cols[b, 32w + c]]; columns at or past K pack as zeros).
    ``live``: a device int32 pair [lo, hi) of the shots to pack (module
    docstring). Runs :func:`gather_pack_plain` on a CPU tensor.
    ``gather_pack.launches`` counts the kernel launches."""
    B, K = cols.shape
    if Kp % 32 or K > Kp:
        raise ValueError(f"need K={K} <= Kp={Kp}, Kp a multiple of 32")
    if cols.device.type == "cpu":
        return gather_pack_plain(index, cols, Kp, live)
    if cols.device.type != "cuda":
        raise ValueError(f"unsupported device {cols.device}")
    dev = cols.device
    _check_live(live, dev)
    cols = cols.to(torch.int64)
    if cols.stride(1) != 1:
        cols = cols.contiguous()
    W = Kp // 32
    out = torch.empty((B, W, index.m), dtype=torch.int32, device=dev)
    fn = _gather_pack_lib().gather_pack_launch
    _kernels.check(fn(index.colptr.data_ptr(), index.rows.data_ptr(),
                      cols.data_ptr(), cols.stride(0),
                      None if live is None else live.data_ptr(),
                      out.data_ptr(), B, K, W, index.m,
                      _kernels.stream_ptr(dev)), "gather_pack_launch")
    gather_pack.launches += 1
    return out


gather_pack.launches = 0


def gather_pack_plain(index: ColumnIndex, cols, Kp: int, live=None):
    """Plain PyTorch version of G1: ``_gather_pack(..., words_major=True)``
    over the live slice; gated-off shots read zero."""
    B = cols.shape[0]
    lo, hi = _live_bounds(live, B)
    if (lo, hi) == (0, B):
        return _gather_pack(index.HT, cols, Kp, words_major=True)
    out = torch.zeros((B, Kp // 32, index.m), dtype=torch.int32,
                      device=cols.device)
    if hi > lo:
        out[lo:hi] = _gather_pack(index.HT, cols[lo:hi], Kp,
                                  words_major=True)
    return out


def _gather_pack_lib():
    lib = _kernels.load("gather_pack")
    if not lib.gather_pack_launch.argtypes:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.gather_pack_launch.argtypes = [P, P, P, ctypes.c_longlong, P, P,
                                           I, I, I, I, P]
        lib.gather_pack_launch.restype = I
    return lib


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
                     return_steps: bool = False, live=None):
    """Batched elimination. Hp (B, W, M) int32 words (M >= m rows; rows at
    or beyond m never pivot), s (B, M) int32 residual syndrome; ``live``,
    a device int32 pair [lo, hi), gates the launch to those shots (module
    docstring; None: every shot).

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
    return fn(Hp, s, K, m, rank, full_jordan, exit_on_valid, return_steps,
              live)


def _run(kernel: str, plain, Hp, s, K, m, rank, full_jordan, exit_on_valid,
         return_steps, live):
    """Shared body of the three wrappers: the plain version on a CPU
    tensor, else one launch of ``kernel``."""
    _check_inputs(Hp, s, K, m)
    if Hp.device.type == "cpu":
        return plain(Hp, s, K, m, rank, full_jordan, exit_on_valid,
                     return_steps, live=live)
    launch, finish = prepare_elim_launch(Hp, s, K, m, rank, full_jordan,
                                         exit_on_valid, kernel=kernel,
                                         live=live)
    launch()
    return finish(return_steps)


def eliminate_blocks_v1(Hp, s, K: int, m: int, rank: int = None,
                        full_jordan: bool = False, exit_on_valid: bool = True,
                        return_steps: bool = False, live=None):
    """Kernel K2 (``csrc/gf2_elim.cu``: a team of warps per shot over
    column bitsets); arguments and outputs as :func:`eliminate_blocks`. s
    holds 0/1 bits. ``eliminate_blocks_v1.launches`` counts the kernel
    launches."""
    return _run("K2", eliminate_blocks_plain, Hp, s, K, m, rank, full_jordan,
                exit_on_valid, return_steps, live)


def eliminate_blocks_fused(Hp, s, K: int, m: int, rank: int = None,
                           full_jordan: bool = False,
                           exit_on_valid: bool = True,
                           return_steps: bool = False, live=None):
    """Kernel K4 (``csrc/gf2_elim_fused.cu``): K2's column steps four
    pivots per team barrier, the tail columns updated in one fused pass per
    4-column group, the exit tested once per group.
    ``eliminate_blocks_fused.launches`` counts the kernel launches."""
    return _run("K4", eliminate_blocks_fused_plain, Hp, s, K, m, rank,
                full_jordan, exit_on_valid, return_steps, live)


def eliminate_blocks_pair(Hp, s, K: int, m: int, rank: int = None,
                          full_jordan: bool = False,
                          exit_on_valid: bool = True,
                          return_steps: bool = False, live=None):
    """Kernel K5 (``csrc/gf2_elim_pair.cu``): K2's per-shot function with
    two shots through one team of warps; every output equals K2's.
    ``eliminate_blocks_pair.launches`` counts the kernel launches."""
    return _run("K5", eliminate_blocks_plain, Hp, s, K, m, rank, full_jordan,
                exit_on_valid, return_steps, live)


for _fn in (eliminate_blocks_v1, eliminate_blocks_fused,
            eliminate_blocks_pair):
    _fn.launches = 0
_ELIMINATORS = {1: eliminate_blocks_v1, 2: eliminate_blocks_fused,
                3: eliminate_blocks_pair}
_WRAPPERS = {"K2": eliminate_blocks_v1, "K4": eliminate_blocks_fused,
             "K5": eliminate_blocks_pair}


def prepare_elim_launch(Hp, s, K: int, m: int, rank: int = None,
                        full_jordan: bool = False,
                        exit_on_valid: bool = True, kernel: str = "K2",
                        live=None):
    """``kernel`` (K2, K4 or K5) on CUDA tensors, gated to ``live`` (a
    device int32 pair [lo, hi), or None), prepared but not launched: input
    casts, output and slab allocation, library load.
    Returns (launch, finish): each ``launch()`` runs the kernel once from
    the unchanged inputs (it writes its outputs apart from them), inside a
    ``torch.profiler`` range named by the kernel's ``*_RANGE`` with the
    width, and counts it on the kernel's wrapper; ``finish(return_steps)``
    gives :func:`eliminate_blocks`'s outputs. A caller can so time the
    kernel alone."""
    _check_inputs(Hp, s, K, m)
    if Hp.device.type != "cuda":
        raise ValueError(f"unsupported device {Hp.device}")
    B, W, M = Hp.shape
    if M > _MAX_ROWS:
        raise ValueError(f"M={M} rows exceed the kernel's {_MAX_ROWS}")
    name, spt, label = _ELIM_KERNELS[kernel]
    wrapper = _WRAPPERS[kernel]
    dev = Hp.device
    _check_live(live, dev)
    hp_in = Hp.to(torch.int32).contiguous()
    s_in = s.to(device=dev, dtype=torch.int32).contiguous()
    hp_out = torch.empty_like(hp_in)
    s_out = torch.empty_like(s_in)
    cf = torch.empty((B, M), dtype=torch.int32, device=dev)
    steps = torch.empty((B,), dtype=torch.int32, device=dev)
    sizes = elim_sizes(W, M, kernel)
    slab = None
    if sizes["device_memory"]:  # the kernel's rule: the columns in a slab
        slab = torch.empty((-(-B // spt), sizes["team_bytes"]),
                           dtype=torch.uint8, device=dev)
    fn = getattr(_lib(name), f"{name}_launch")
    args = (B, W, M, m, K, m if rank is None else rank, int(full_jordan),
            int(exit_on_valid), _SMEM_LIMIT)
    label = f"{label}: {W} words" + (", full_jordan" if full_jordan else "")

    def launch():
        # the inputs and the slab stay referenced by this closure
        with torch.profiler.record_function(label):
            code = fn(hp_in.data_ptr(), hp_out.data_ptr(), s_in.data_ptr(),
                      s_out.data_ptr(), cf.data_ptr(), steps.data_ptr(),
                      None if slab is None else slab.data_ptr(),
                      None if live is None else live.data_ptr(), *args,
                      _kernels.stream_ptr(dev))
        _kernels.check(code, f"{name}_launch")
        wrapper.launches += 1

    def finish(return_steps: bool = False):
        out = (hp_out, s_out, prow_of_col_from(cf, K), cf >= 0, cf)
        return out + (steps,) if return_steps else out

    return launch, finish


def _lib(name: str):
    """``csrc/<name>.cu``'s library with its three entry points typed."""
    lib = _kernels.load(name)
    launch = getattr(lib, f"{name}_launch")
    if not launch.argtypes:
        P, I = ctypes.c_void_p, ctypes.c_int
        launch.argtypes = [P] * 8 + [I] * 9 + [P]
        launch.restype = I
        sizes = getattr(lib, f"{name}_sizes")
        sizes.argtypes = [I, I, I, P]
        sizes.restype = I
        info = getattr(lib, f"{name}_info")
        info.argtypes = [I] * 4 + [P]
        info.restype = I
    return lib


def elim_sizes(W: int, M: int, kernel: str = "K2") -> dict:
    """``kernel``'s layout of one shot of W words by M rows, as its source
    reports it: the column bytes of a shot and of a team (the shots the
    kernel runs through one team of warps; the device-memory slab takes a
    team's bytes a team), the column stride in words, the row words a lane
    holds, and whether the columns go to the device-memory slab (a team's
    exceed ``_SMEM_LIMIT``)."""
    name, spt, _ = _ELIM_KERNELS[kernel]
    out = (ctypes.c_longlong * 4)()
    _kernels.check(getattr(_lib(name), f"{name}_sizes")(W, M, _SMEM_LIMIT,
                                                         out),
                   f"{name}_sizes")
    return dict(shot_bytes=out[0] // spt, team_bytes=out[0],
                shots_per_team=spt, column_stride=out[1],
                words_per_lane=out[2], device_memory=bool(out[3]))


def elim_launch_info(B: int, W: int, M: int, device,
                     kernel: str = "K2") -> dict:
    """``kernel``'s shape on the card for B shots of W words by M rows:
    registers and spilled bytes a thread, column bytes a shot and where
    they live, warps a team and shots a team, shots a block, shared memory
    a block, blocks, and blocks and shots resident per SM."""
    name, _, _ = _ELIM_KERNELS[kernel]
    out = (ctypes.c_int * 8)()
    with torch.cuda.device(device):
        _kernels.check(getattr(_lib(name), f"{name}_info")(
            B, W, M, _SMEM_LIMIT, out), f"{name}_info")
    return dict(elim_sizes(W, M, kernel), registers=out[0],
                local_bytes=out[1], shots_per_block=out[2],
                smem_bytes=out[3],
                columns_in="device memory" if out[4] else "shared memory",
                warps_per_shot=out[7], blocks=out[5], blocks_per_sm=out[6],
                shots_per_sm=out[6] * out[2])


def eliminate_blocks_plain(Hp, s, K: int, m: int, rank: int = None,
                           full_jordan: bool = False,
                           exit_on_valid: bool = True,
                           return_steps: bool = False,
                           count_xor_words: bool = False, live=None):
    """Plain PyTorch version of kernels K2 and K5: the same per-shot column
    steps, vectorized over shots, each shot frozen once it is done. One
    host read per column step, and one of ``live`` (the live slice runs;
    the other shots keep their inputs, with no pivot and no step).

    ``count_xor_words`` appends a (B,) int64 count of the word XORs the
    steps did: per step, the rows the pivot row was XORed into times the
    words it updated (those from the pivot's word on, or all of them under
    ``full_jordan``). It measures the elimination's data-dependent work for
    the kernels' operation bound; the decode path never asks for it."""
    return _eliminate_plain(Hp, s, K, m, rank, full_jordan, exit_on_valid,
                            return_steps, group=1,
                            count_xor_words=count_xor_words, live=live)


def eliminate_blocks_fused_plain(Hp, s, K: int, m: int, rank: int = None,
                                 full_jordan: bool = False,
                                 exit_on_valid: bool = True,
                                 return_steps: bool = False, live=None):
    """Plain PyTorch version of kernel K4: K2's column steps, with the exit
    (rank reached, or residual inside the pivot span) tested only at the
    end of each 4-column group, and the columns of the last group at or
    beyond K never pivoting. ``steps`` counts the columns of the groups a
    shot ran, at most K."""
    return _eliminate_plain(Hp, s, K, m, rank, full_jordan, exit_on_valid,
                            return_steps, group=_FUSED_GROUP, live=live)


def _eliminate_plain(Hp, s, K, m, rank, full_jordan, exit_on_valid,
                     return_steps, group: int, count_xor_words: bool = False,
                     live=None):
    _check_inputs(Hp, s, K, m)
    B, W, M = Hp.shape
    lo, hi = _live_bounds(live, B)
    if (lo, hi) != (0, B):  # the live slice; the rest keeps its inputs
        part = _eliminate_plain(Hp[lo:hi], s[lo:hi], K, m, rank,
                                full_jordan, exit_on_valid, True, group,
                                count_xor_words)
        hp = Hp.to(torch.int32).clone()
        s_out = s.to(device=Hp.device, dtype=torch.int32).clone()
        cf = torch.full((B, M), -1, dtype=torch.int32, device=Hp.device)
        steps = torch.zeros(B, dtype=torch.int32, device=Hp.device)
        xor_words = torch.zeros(B, dtype=torch.int64, device=Hp.device)
        hp[lo:hi], s_out[lo:hi], cf[lo:hi] = part[0], part[1], part[4]
        steps[lo:hi] = part[5]
        if count_xor_words:
            xor_words[lo:hi] = part[6]
        out = (hp, s_out, prow_of_col_from(cf, K), cf >= 0, cf)
        if return_steps:
            out += (steps,)
        return out + (xor_words,) if count_xor_words else out
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
