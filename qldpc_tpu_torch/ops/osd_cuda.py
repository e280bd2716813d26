"""Batched bit-packed GF(2) elimination: CUDA kernels K2, K4, K5 and their
plain twins; the gather-pack that builds their input, kernel G1; and the
BP residual syndrome they eliminate against, kernel R1 (:func:`bp_residual`,
``csrc/bp_residual.cu``: each shot's hard decision's set columns XORed from
the same CSC that G1 reads, in place of a float32 product on 0/1 operands).

``eliminate_blocks`` has the signature and outputs of the JAX package's
``osd_pallas.eliminate_blocks``, but takes its matrix in the eliminators'
column layout (below) and sizes its blocks in the card's terms (the block
shape, below). It dispatches on
``_KERNEL_VERSION``, read from ``QLDPC_OSD_KERNEL`` (default 1) as the JAX
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
(:func:`prepare_elim_launch`): a ``torch.profiler`` range per launch named
with the kernel and the width (``K2_RANGE``, ``K4_RANGE``, ``K5_RANGE``),
entered only while a profiler runs, and the launch count on the wrapper.

The column layout: (B, Kp, S) int32, column j of a shot being S words over
the rows, bit i of word l being row 32l + i; S is the eliminators' odd
column stride (:func:`column_stride`, from the kernel's ``*_sizes`` entry
point), and the words past ceil(m/32) are zero. G1 (``gather_pack``,
``csrc/gather_pack.cu``) writes it from a CSC copy of the decoding matrix
(:class:`ColumnIndex`, built once a matrix). The eliminators copy a shot's
columns into shared memory, or, where a team's columns exceed
``_SMEM_LIMIT``, eliminate them in place in device memory (such a launch
consumes its input). Their reduced matrix goes out words-major (B, W, M),
and only where ``want_matrix`` (default True; the OSD asks for it only for
the full-Jordan reprocess).

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs its
plain version on a CPU tensor. The plain versions work words-major (bit c
of word w at row r is column 32w + c): G1's is the dense
``_gather_pack(..., words_major=True)``, the port of the JAX package's XLA
gather-pack, bit-transposed by :func:`words_to_columns`; the eliminators'
are ``eliminate_blocks_plain`` for K2 and K5 (K5 computes exactly K2's
per-shot function) and ``eliminate_blocks_fused_plain`` for K4, which a
wrapper hands its column input through :func:`columns_to_words`.

Words travel as int32: PyTorch's uint32 support is thin, and
``(w >> b) & 1`` is exact after an arithmetic shift.

The block shape: every eliminator and :func:`prepare_elim_launch` and
:func:`elim_launch_info` take ``block_shots`` and ``smem_budget``, the
counterparts of JAX's ``block_shots`` and of the VMEM budget of its
``pick_block_shots``. ``block_shots`` sets the shots a block (K5 rounds an
odd count up to its team of two), clamped by what fits the budget, the
eight teams a block's named barriers allow (four on the device-memory
branch), the warps a block holds and the batch; ``smem_budget`` is the
shared memory a block may take for its teams' columns, at most
``_SMEM_LIMIT``, and a budget below one team's columns sends the launch to
the device-memory branch. None, the default, keeps the plan's own rule
(``make_plan`` in ``csrc/gf2_elim_common.cuh``: teams / SMs a block, up to
what fits ``_SMEM_LIMIT``). :func:`pick_block_shots` is JAX's rule in these
terms. The plain versions accept both and ignore them: the port's
eliminators exit per shot, so every output is a function of the shot
alone, whatever the block shape.

The gate: every eliminator and G1 take ``live``, a device int32 pair
``[lo, hi)`` of the batch's live shots (None: every shot). The launch
covers the whole batch and the kernel reads the pair, so no host read sizes
it; a shot outside the range leaves at once. Its eliminator outputs are
unspecified except ``colofrow`` (-1: no pivot), ``used``, ``prow_of_col``
and ``steps`` (0), and its G1 words are left unwritten; the OSD
(ops/osd.py) never consumes them. The plain versions read the pair with
``int()`` and run the live slice (gated-off shots keep their inputs, G1's
read zero).

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
import functools
import os

import numpy as np
import torch

from .. import _kernels
from ..utils import telemetry

_SMEM_LIMIT = _kernels.SMEM_PER_BLOCK - 1024  # dynamic bytes a block takes
_MAX_ROWS = 32 * 32 * 4      # 32 lanes x GF2_MAXR words of 32 rows
_FUSED_GROUP = 4             # columns per K4 group (GF2_GROUP)
# the plan's limits (csrc/gf2_elim_common.cuh): most teams a block holds
# (GF2_BLOCK_SHOTS, its named barriers) and most warps a team
# (GF2_MAX_TEAM)
_BLOCK_TEAMS, _MAX_TEAM = 8, 16
# profiler range of each launch, named with the width, by kernel
K2_RANGE, K4_RANGE, K5_RANGE = "K2 launch", "K4 launch", "K5 launch"
# each kernel's library (csrc/<name>.cu, exporting <name>_launch, _sizes and
# _info), the shots a team carries, its profiler range, and whether its
# block holds 512 threads where a lane holds more than one row word
# (max_block_threads' `narrow`)
_ELIM_KERNELS = {"K2": ("gf2_elim", 1, K2_RANGE, False),
                 "K4": ("gf2_elim_fused", 1, K4_RANGE, True),
                 "K5": ("gf2_elim_pair", 2, K5_RANGE, True)}

# Eliminator generation, as osd_pallas._KERNEL_VERSION in the JAX package.
_KERNEL_VERSION = int(os.environ.get("QLDPC_OSD_KERNEL", "1"))
_KERNEL_NAMES = {1: "K2", 2: "K4", 3: "K5"}


def selected_kernel() -> str:
    """The eliminator ``eliminate_blocks`` runs: K2, K4 or K5 by
    ``_KERNEL_VERSION``."""
    if _KERNEL_VERSION not in _KERNEL_NAMES:
        raise ValueError(f"QLDPC_OSD_KERNEL={_KERNEL_VERSION}: the "
                         f"eliminator versions are {sorted(_KERNEL_NAMES)}")
    return _KERNEL_NAMES[_KERNEL_VERSION]


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


def column_stride(W: int, M: int, device, kernel: str = None) -> int:
    """S, the column stride in words of the eliminators' column layout for
    W words by M rows. On a GPU from eliminator ``kernel``'s (None: the one
    ``eliminate_blocks`` runs) ``*_sizes`` entry point, the plan's one rule;
    on the CPU from the plain versions' copy of that rule, ceil(M/32) made
    odd, which ``tests/test_torch_cuda.py`` holds equal to it."""
    if (device if isinstance(device, torch.device)
            else torch.device(device)).type == "cuda":
        # the stride does not depend on the budget: G1 writes it
        return _sizes(_ELIM_KERNELS[kernel or selected_kernel()][0], W, M,
                      _SMEM_LIMIT)[1]
    return -(-M // 32) | 1


def _pack_bits32(bits: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 0/1 -> (...) int32 words, bit i = bits[..., i]
    (bytes packed, then read as little-endian words)."""
    sh = torch.arange(8, dtype=torch.uint8, device=bits.device)
    byte = (bits.reshape(*bits.shape[:-1], 4, 8) << sh).sum(
        -1, dtype=torch.uint8)
    return byte.contiguous().view(torch.int32)[..., 0]


_WORD_CHUNK = 8  # words a plain transpose step unpacks (32x their bytes)


def words_to_columns(words: torch.Tensor, S: int) -> torch.Tensor:
    """Plain bit transpose of the words-major (B, W, M) int32 layout to the
    column layout (B, 32W, S): word l of column 32w + c holds bit c of
    words[b, w, 32l + i] as bit i; words ceil(M/32)..S-1 are zero."""
    B, W, M = words.shape
    NR = -(-M // 32)
    if S < NR:
        raise ValueError(f"stride S={S} is below ceil(M/32)={NR}")
    out = torch.zeros((B, 32 * W, S), dtype=torch.int32, device=words.device)
    sh = torch.arange(32, dtype=torch.int32, device=words.device)[:, None]
    for w0 in range(0, W, _WORD_CHUNK):
        x = words[:, w0:w0 + _WORD_CHUNK].to(torch.int32)
        nw = x.shape[1]
        bits = ((x[:, :, None, :] >> sh) & 1).to(torch.uint8)  # (B,nw,32,M)
        bits = torch.nn.functional.pad(bits, (0, 32 * NR - M))
        out[:, 32 * w0:32 * (w0 + nw), :NR] = _pack_bits32(
            bits.reshape(B, 32 * nw, NR, 32))
    return out


def columns_to_words(cols: torch.Tensor, M: int) -> torch.Tensor:
    """The inverse of :func:`words_to_columns`: a (B, 32W, S) column layout
    as (B, W, M) int32 words-major rows."""
    B = cols.shape[0]
    W = cols.shape[1] // 32
    NR = -(-M // 32)
    out = torch.empty((B, W, M), dtype=torch.int32, device=cols.device)
    sh = torch.arange(32, dtype=torch.int32, device=cols.device)
    for w0 in range(0, W, _WORD_CHUNK):
        x = cols[:, 32 * w0:32 * (w0 + _WORD_CHUNK), :NR].to(torch.int32)
        nw = x.shape[1] // 32
        bits = ((x[..., None] >> sh) & 1).to(torch.uint8)      # (B,32nw,NR,32)
        bits = bits.reshape(B, nw, 32, 32 * NR)[..., :M]        # (B,nw,c,M)
        out[:, w0:w0 + nw] = _pack_bits32(bits.transpose(2, 3))
    return out


def _gather_pack(HT_u8, colsK, Kp: int, chunk: int = 256,
                 words_major: bool = False) -> torch.Tensor:
    """Per-shot column gather + bit-pack from the (n, m) uint8 transpose of
    H, chunked over columns so the unpacked gather never exceeds
    (B, chunk, m) bytes. Columns past K (up to Kp) pack as zeros. The port
    of the JAX package's ``osd._gather_pack``; with ``words_major=True``
    the words-major reference of G1 (module docstring).

    Returns (B, m, Kp//32), or the words-major (B, Kp//32, m) layout when
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


def _check_pack(cols, Kp: int) -> tuple:
    """(B, K) of G1's column indices, checked against Kp."""
    B, K = cols.shape
    if Kp % 32 or K > Kp:
        raise ValueError(f"need K={K} <= Kp={Kp}, Kp a multiple of 32")
    return B, K


def prepare_gather_pack(index: ColumnIndex, cols, Kp: int, live=None):
    """Kernel G1 on CUDA tensors, prepared but not launched: the output's
    allocation, the column indices' cast and the library load. Returns
    (launch, out): each ``launch()`` runs the kernel once into ``out`` and
    counts it on :func:`gather_pack`. A caller can so time the kernel
    alone."""
    fn, args, out, cols = _g1_args(index, cols, Kp, live)
    dev = cols.device

    def launch():
        # the stream is the current one at the launch (a graph's capture)
        _kernels.check(fn(*args, _kernels.stream_ptr(dev)),
                       "gather_pack_launch")
        gather_pack.launches += 1

    launch.tensors = (index, cols, live, out)  # what the arguments point into
    return launch, out


def _g1_args(index: ColumnIndex, cols, Kp: int, live) -> tuple:
    """(entry point, its arguments but the stream, output, the cast column
    indices that the arguments point into) of one G1 launch."""
    B, K = _check_pack(cols, Kp)
    dev = cols.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_live(live, dev)
    if cols.dtype != torch.int64:
        cols = cols.to(torch.int64)
    if cols.stride(1) != 1:
        cols = cols.contiguous()
    W = Kp // 32
    S = column_stride(W, index.m, dev)
    out = torch.empty((B, Kp, S), dtype=torch.int32, device=dev)
    args = (index.colptr.data_ptr(), index.rows.data_ptr(), cols.data_ptr(),
            cols.stride(0), None if live is None else live.data_ptr(),
            out.data_ptr(), B, K, W, S)
    return _gather_pack_lib().gather_pack_launch, args, out, cols


def gather_pack(index: ColumnIndex, cols, Kp: int, live=None):
    """Kernel G1 (``csrc/gather_pack.cu``): each shot's columns ``cols``
    (B, K) of the matrix behind ``index``, K <= Kp, bit-packed into the
    eliminators' (B, Kp, S) column layout (module docstring); columns at
    or past K pack as zeros. ``live``: a device int32 pair [lo, hi) of the
    shots to pack (module docstring). Runs :func:`gather_pack_plain` on a
    CPU tensor. ``gather_pack.launches`` counts the kernel launches."""
    if cols.device.type == "cpu":
        return gather_pack_plain(index, cols, Kp, live)
    fn, args, out, cols = _g1_args(index, cols, Kp, live)
    _kernels.check(fn(*args, _kernels.stream_ptr(cols.device)),
                   "gather_pack_launch")
    gather_pack.launches += 1
    return out


gather_pack.launches = 0


def gather_pack_plain(index: ColumnIndex, cols, Kp: int, live=None):
    """Plain PyTorch version of G1: ``_gather_pack(..., words_major=True)``
    over the live slice, bit-transposed by :func:`words_to_columns` into
    the column layout; gated-off shots read zero."""
    B, _ = _check_pack(cols, Kp)
    lo, hi = _live_bounds(live, B)
    if (lo, hi) == (0, B):
        words = _gather_pack(index.HT, cols, Kp, words_major=True)
    else:
        words = torch.zeros((B, Kp // 32, index.m), dtype=torch.int32,
                            device=cols.device)
        if hi > lo:
            words[lo:hi] = _gather_pack(index.HT, cols[lo:hi], Kp,
                                        words_major=True)
    return words_to_columns(words, column_stride(Kp // 32, index.m,
                                                 cols.device))


def _gather_pack_lib():
    lib = _kernels.load("gather_pack")
    if not lib.gather_pack_launch.argtypes:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.gather_pack_launch.argtypes = [P, P, P, ctypes.c_longlong, P, P,
                                           I, I, I, I, P]
        lib.gather_pack_launch.restype = I
    return lib


def bp_residual_plain(syndrome, hard, HT) -> tuple:
    """Plain version of R1: ``syndrome ^ (hard @ HT) & 1`` as a float32
    product (exact: its counts stay below 2^24, see ops/sampler.py) and its
    weight, the row sums; counts the odd bytes of ``hard`` as
    ``osd.hard_ones`` when telemetry is on."""
    if telemetry.enabled():
        telemetry.count("osd.hard_ones", (hard.to(torch.int8) & 1).sum())
    hard_syn = (hard.to(torch.float32) @ HT).to(torch.int32) & 1
    residual = syndrome.to(torch.int32) ^ hard_syn
    return residual, residual.sum(1, dtype=torch.int32)


def bp_residual(syndrome, hard, HT, index: ColumnIndex) -> tuple:
    """Kernel R1 (``csrc/bp_residual.cu``): the BP residual syndrome that
    an OSD correction must reproduce, ``syndrome ^ H @ hard`` over GF(2),
    (B, m) int32, and its weight (B,) int32, from the hard decision
    ``hard`` (B, n) (its bytes' low bits) and ``syndrome`` (B, m) int8.
    CUDA tensors launch the kernel on ``index``, H's
    :class:`ColumnIndex`; CPU tensors run :func:`bp_residual_plain` on
    ``HT`` (n, m) float32, H's transpose. The two agree bit for bit. With
    telemetry on, the kernel also counts the set columns it scanned into a
    device int64, ``osd.hard_ones``. ``bp_residual.launches`` counts the
    launches."""
    if hard.device.type == "cpu":
        return bp_residual_plain(syndrome, hard, HT)
    if hard.device.type != "cuda":
        raise ValueError(f"unsupported device {hard.device}")
    if index is None or index.colptr.device != hard.device:
        raise ValueError(f"R1 needs H's column index on {hard.device}")
    B, n = hard.shape
    m = index.m
    if syndrome.shape != (B, m) or index.colptr.shape[0] != n + 1:
        raise ValueError(f"hard {tuple(hard.shape)} and syndrome "
                         f"{tuple(syndrome.shape)} against a ({m}, "
                         f"{index.colptr.shape[0] - 1}) matrix")
    hard = hard.to(torch.int8).contiguous()
    syndrome = syndrome.to(torch.int8).contiguous()
    residual = torch.empty((B, m), dtype=torch.int32, device=hard.device)
    weight = torch.empty(B, dtype=torch.int32, device=hard.device)
    ones = None
    if telemetry.enabled():
        ones = torch.zeros(1, dtype=torch.int64, device=hard.device)
    _kernels.check(_r1_launch()(
        hard.data_ptr(), syndrome.data_ptr(), index.colptr.data_ptr(),
        index.rows.data_ptr(), B, n, m, residual.data_ptr(),
        weight.data_ptr(), None if ones is None else ones.data_ptr(),
        _kernels.stream_ptr(hard.device)), "bp_residual_launch")
    bp_residual.launches += 1
    if ones is not None:
        telemetry.count("osd.hard_ones", ones)
    return residual, weight


bp_residual.launches = 0


@functools.cache
def _r1_launch():
    fn = _kernels.load("bp_residual").bp_residual_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 4 + [I] * 3 + [P] * 4
    fn.restype = I
    return fn


def _check_inputs(Hp, s, K: int, m: int):
    """The words-major (B, W, M) input of the plain eliminators beside s
    (B, M); raises where the shapes do not fit."""
    if Hp.dim() != 3 or s.dim() != 2 or s.shape != (Hp.shape[0], Hp.shape[2]):
        raise ValueError(f"need Hp (B, W, M) and s (B, M); got "
                         f"{tuple(Hp.shape)} and {tuple(s.shape)}")
    B, W, M = Hp.shape
    if K > 32 * W or m > M:
        raise ValueError(f"K={K} exceeds 32*W={32 * W} or m={m} > M={M}")


def _check_columns(Hp, s, K: int, m: int, kernel: str) -> tuple:
    """(B, W, M) of an eliminator's column input Hp (B, 32W, S) at
    ``kernel``'s stride beside s (B, M); raises where the shapes do not
    fit."""
    if Hp.dim() != 3 or s.dim() != 2:
        raise ValueError(f"need a 3-d Hp and s (B, M); got {tuple(Hp.shape)}"
                         f" and {tuple(s.shape)}")
    B, M = s.shape
    W = Hp.shape[1] // 32
    S = column_stride(W, M, Hp.device, kernel)
    if Hp.shape != (B, 32 * W, S):
        raise ValueError(f"need Hp (B, 32W, {S}) columns and s (B, M); got "
                         f"{tuple(Hp.shape)} and {tuple(s.shape)}")
    if K > 32 * W or m > M:
        raise ValueError(f"K={K} exceeds 32*W={32 * W} or m={m} > M={M}")
    return B, W, M


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
                     return_steps: bool = False, live=None,
                     want_matrix: bool = True, block_shots: int = None,
                     smem_budget: int = None):
    """Batched elimination. Hp (B, 32W, S) int32, the column layout as
    :func:`gather_pack` writes it (module docstring), of M >= m rows; rows
    at or beyond m never pivot. s (B, M) int32 residual syndrome; ``live``,
    a device int32 pair [lo, hi), gates the launch to those shots (module
    docstring; None: every shot). On the card, input whose columns live in
    device memory is eliminated in place: the call consumes it.

    Returns (Hp_reduced (B, W, M) words-major, or None unless
    ``want_matrix``; s_reduced (B, M), prow_of_col (B, K), used (B, M)
    bool, colofrow (B, M)), plus steps (B,) int32 — the column steps each
    shot ran — when ``return_steps``.

    full_jordan=False skips already-passed words: s_reduced, prow_of_col,
    used and all pivot columns equal full Gauss-Jordan; dependent columns
    left of a pivot's word stay stale. full_jordan=True reduces them too.
    ``block_shots`` and ``smem_budget`` set the launch's block shape (module
    docstring; None: the plan's own). Runs the eliminator
    ``_KERNEL_VERSION`` selects (module docstring)."""
    fn = _ELIMINATORS[selected_kernel()]
    return fn(Hp, s, K, m, rank, full_jordan, exit_on_valid, return_steps,
              live, want_matrix, block_shots, smem_budget)


def _run(kernel: str, plain, Hp, s, K, m, rank, full_jordan, exit_on_valid,
         return_steps, live, want_matrix, block_shots, smem_budget):
    """Shared body of the three wrappers: on a CPU tensor the plain
    version of the input turned words-major, else one launch of
    ``kernel``. Each call is a telemetry span ``elim`` (utils/telemetry.py)
    counting its live shots ``elim.live`` and their column steps
    ``elim.steps`` (the steps the launch writes anyway, held unread)."""
    with telemetry.span("elim", kernel=kernel, words=Hp.shape[1] // 32,
                        full_jordan=full_jordan):
        traced = telemetry.enabled()
        if Hp.device.type == "cpu":
            _, _, M = _check_columns(Hp, s, K, m, kernel)
            out = plain(columns_to_words(Hp, M), s, K, m, rank, full_jordan,
                        exit_on_valid, return_steps or traced, live=live)
            if not want_matrix:
                out = (None,) + out[1:]
        else:
            launch, finish = prepare_elim_launch(
                Hp, s, K, m, rank, full_jordan, exit_on_valid, kernel=kernel,
                live=live, want_matrix=want_matrix, block_shots=block_shots,
                smem_budget=smem_budget)
            launch()
            out = finish(return_steps or traced)
        if traced:
            telemetry.count("elim.live", Hp.shape[0] if live is None
                            else live, telemetry.live_shots)
            telemetry.count("elim.steps", out[5])
            if not return_steps:
                out = out[:5]
        return out


def eliminate_blocks_v1(Hp, s, K: int, m: int, rank: int = None,
                        full_jordan: bool = False, exit_on_valid: bool = True,
                        return_steps: bool = False, live=None,
                        want_matrix: bool = True, block_shots: int = None,
                        smem_budget: int = None):
    """Kernel K2 (``csrc/gf2_elim.cu``: a team of warps per shot over
    column bitsets); arguments and outputs as :func:`eliminate_blocks`. s
    holds 0/1 bits. ``eliminate_blocks_v1.launches`` counts the kernel
    launches."""
    return _run("K2", eliminate_blocks_plain, Hp, s, K, m, rank, full_jordan,
                exit_on_valid, return_steps, live, want_matrix, block_shots,
                smem_budget)


def eliminate_blocks_fused(Hp, s, K: int, m: int, rank: int = None,
                           full_jordan: bool = False,
                           exit_on_valid: bool = True,
                           return_steps: bool = False, live=None,
                           want_matrix: bool = True, block_shots: int = None,
                           smem_budget: int = None):
    """Kernel K4 (``csrc/gf2_elim_fused.cu``): K2's column steps four
    pivots per team barrier, the tail columns updated in one fused pass per
    4-column group, the exit tested once per group.
    ``eliminate_blocks_fused.launches`` counts the kernel launches."""
    return _run("K4", eliminate_blocks_fused_plain, Hp, s, K, m, rank,
                full_jordan, exit_on_valid, return_steps, live, want_matrix,
                block_shots, smem_budget)


def eliminate_blocks_pair(Hp, s, K: int, m: int, rank: int = None,
                          full_jordan: bool = False,
                          exit_on_valid: bool = True,
                          return_steps: bool = False, live=None,
                          want_matrix: bool = True, block_shots: int = None,
                          smem_budget: int = None):
    """Kernel K5 (``csrc/gf2_elim_pair.cu``): K2's per-shot function with
    two shots through one team of warps; every output equals K2's.
    ``eliminate_blocks_pair.launches`` counts the kernel launches."""
    return _run("K5", eliminate_blocks_plain, Hp, s, K, m, rank, full_jordan,
                exit_on_valid, return_steps, live, want_matrix, block_shots,
                smem_budget)


for _fn in (eliminate_blocks_v1, eliminate_blocks_fused,
            eliminate_blocks_pair):
    _fn.launches = 0
_ELIMINATORS = {"K2": eliminate_blocks_v1, "K4": eliminate_blocks_fused,
                "K5": eliminate_blocks_pair}


def prepare_elim_launch(Hp, s, K: int, m: int, rank: int = None,
                        full_jordan: bool = False,
                        exit_on_valid: bool = True, kernel: str = "K2",
                        live=None, want_matrix: bool = True,
                        block_shots: int = None, smem_budget: int = None):
    """``kernel`` (K2, K4 or K5) on CUDA tensors, gated to ``live`` (a
    device int32 pair [lo, hi), or None), in the block shape that
    ``block_shots`` and ``smem_budget`` set (module docstring; None: the
    plan's own), prepared but not launched: input casts, output
    allocation, library load.
    Returns (launch, finish): each ``launch()`` runs the kernel once,
    inside a ``torch.profiler`` range named by the kernel's ``*_RANGE``
    with the width where a profiler runs, and counts it on the kernel's
    wrapper;
    ``finish(return_steps)`` gives :func:`eliminate_blocks`'s outputs.
    A launch writes its outputs apart from its inputs and runs from the
    unchanged inputs each time, except where ``launch.consumes_input`` is
    true: input whose columns live in device memory is eliminated in
    place, so a caller that launches again must first restore Hp (a copy
    or a fresh G1 pack) for every launch to eliminate the same matrix. A
    caller can so time the kernel alone."""
    B, W, M = _check_columns(Hp, s, K, m, kernel)
    dev = Hp.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if M > _MAX_ROWS:
        raise ValueError(f"M={M} rows exceed the kernel's {_MAX_ROWS}")
    name, _, label, _ = _ELIM_KERNELS[kernel]
    wrapper = _ELIMINATORS[kernel]
    _check_live(live, dev)
    budget, spb = _smem_budget(smem_budget), _block_shots(block_shots)
    hp = Hp.to(torch.int32).contiguous()
    s_in = s.to(device=dev, dtype=torch.int32).contiguous()
    hp_out = (torch.empty((B, W, M), dtype=torch.int32, device=dev)
              if want_matrix else None)
    s_out = torch.empty_like(s_in)
    cf = torch.empty((B, M), dtype=torch.int32, device=dev)
    steps = torch.empty((B,), dtype=torch.int32, device=dev)
    fn = getattr(_lib(name), f"{name}_launch")
    args = (hp.data_ptr(), None if hp_out is None else hp_out.data_ptr(),
            s_in.data_ptr(), s_out.data_ptr(), cf.data_ptr(),
            steps.data_ptr(), None if live is None else live.data_ptr(),
            B, W, M, m, K, m if rank is None else rank, int(full_jordan),
            int(exit_on_valid), budget, spb)
    label = (f"{label}: {W} words" + (", full_jordan" if full_jordan else "")
             + (f", block_shots={spb}" if spb else ""))

    def launch():
        # the stream is the current one at the launch (a graph's capture);
        # the range is entered only under a running profiler
        if torch.autograd.profiler._is_profiler_enabled:
            with torch.profiler.record_function(label):
                code = fn(*args, _kernels.stream_ptr(dev))
        else:
            code = fn(*args, _kernels.stream_ptr(dev))
        _kernels.check(code, f"{name}_launch")
        wrapper.launches += 1

    launch.consumes_input = bool(_sizes(name, W, M, budget)[3])
    # what the arguments point into
    launch.tensors = (hp, s_in, hp_out, s_out, cf, steps, live)

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
        launch.argtypes = [P] * 7 + [I] * 10 + [P]
        launch.restype = I
        sizes = getattr(lib, f"{name}_sizes")
        sizes.argtypes = [I, I, I, P]
        sizes.restype = I
        info = getattr(lib, f"{name}_info")
        info.argtypes = [I] * 5 + [P]
        info.restype = I
    return lib


def elim_sizes(W: int, M: int, kernel: str = "K2",
               smem_budget: int = None) -> dict:
    """``kernel``'s layout of one shot of W words by M rows, as its source
    reports it: the column bytes of a shot and of a team (the shots the
    kernel runs through one team of warps), the column stride in words, the
    row words a lane holds, and whether the columns stay in device memory
    (a team's exceed ``smem_budget``, None: ``_SMEM_LIMIT``), where the
    kernel eliminates its input in place."""
    name, spt, _, _ = _ELIM_KERNELS[kernel]
    team_bytes, stride, per_lane, dev = _sizes(name, W, M,
                                               _smem_budget(smem_budget))
    return dict(shot_bytes=team_bytes // spt, team_bytes=team_bytes,
                shots_per_team=spt, column_stride=stride,
                words_per_lane=per_lane, device_memory=bool(dev))


@functools.lru_cache(maxsize=None)
def _sizes(name: str, W: int, M: int, smem_limit: int) -> tuple:
    """``<name>_sizes`` of the kernel's library, asked once a shape (a host
    call; G1 and the eliminators ask it for every launch)."""
    out = (ctypes.c_longlong * 4)()
    _kernels.check(getattr(_lib(name), f"{name}_sizes")(W, M, smem_limit,
                                                         out),
                   f"{name}_sizes")
    return tuple(out)


def elim_launch_info(B: int, W: int, M: int, device, kernel: str = "K2",
                     block_shots: int = None, smem_budget: int = None) -> dict:
    """``kernel``'s shape on the card for B shots of W words by M rows in
    the block shape ``block_shots`` and ``smem_budget`` set (module
    docstring; None: the plan's own): registers and spilled bytes a thread,
    column bytes a shot and where they live, warps a team and shots a
    team, shots a block (after the plan's clamps), shared memory a block,
    blocks, and blocks and shots resident per SM."""
    name = _ELIM_KERNELS[kernel][0]
    budget = _smem_budget(smem_budget)
    out = (ctypes.c_int * 8)()
    with torch.cuda.device(device):
        _kernels.check(getattr(_lib(name), f"{name}_info")(
            B, W, M, budget, _block_shots(block_shots), out),
            f"{name}_info")
    return dict(elim_sizes(W, M, kernel, budget), registers=out[0],
                local_bytes=out[1], shots_per_block=out[2],
                smem_bytes=out[3],
                columns_in="device memory" if out[4] else "shared memory",
                warps_per_shot=out[7], blocks=out[5], blocks_per_sm=out[6],
                shots_per_sm=out[6] * out[2])


def _smem_budget(smem_budget) -> int:
    """The shared-memory bytes a block may take for its teams' columns:
    ``smem_budget``, at most ``_SMEM_LIMIT`` (None: ``_SMEM_LIMIT``, read
    at the call)."""
    if smem_budget is None:
        return _SMEM_LIMIT
    if smem_budget < 0:
        raise ValueError(f"smem_budget={smem_budget} is negative")
    return min(int(smem_budget), _SMEM_LIMIT)


def _block_shots(block_shots) -> int:
    """The entry points' ``block_shots`` argument: 0 (the plan's own rule)
    for None, else the shots a block asked for."""
    if block_shots is None:
        return 0
    if block_shots < 1:
        raise ValueError(f"block_shots={block_shots} is below 1")
    return int(block_shots)


def team_bytes(M: int, W: int, kernel: str = None) -> int:
    """One team's column bytes of W words by M rows for eliminator
    ``kernel`` (None: the one ``eliminate_blocks`` runs): 32 W columns of
    the odd stride ceil(M/32) | 1 words, for each shot a team carries; the
    plan's ``team_bytes``, computed without a card."""
    spt = _ELIM_KERNELS[kernel or selected_kernel()][1]
    return spt * 4 * 32 * W * (-(-M // 32) | 1)


def pick_block_shots(M: int, W: int, smem_budget: int = None,
                     cap: int = None, kernel: str = None):
    """The counterpart of the JAX package's ``osd_pallas.pick_block_shots``
    in the card's terms: the largest power of two of shots a block, at most
    ``cap`` (None: the most a block holds), whose teams' columns of W words
    by M rows fit ``smem_budget`` bytes of shared memory (None:
    ``_SMEM_LIMIT``) and whose warps fit a block, for eliminator ``kernel``
    (None: the one ``eliminate_blocks`` runs). At least 1, as JAX's: where
    one team's columns exceed the budget, the launch runs on the
    device-memory branch, one team a block. None when both ``smem_budget``
    and ``cap`` are None: the plan's own rule. Computed from the plan's
    arithmetic (``make_plan``), so it runs without a card; ``chip_smoke.py``
    holds it against the library's ``_info``."""
    if smem_budget is None and cap is None:
        return None
    kernel = kernel or selected_kernel()
    _, spt, _, narrow = _ELIM_KERNELS[kernel]
    fit = _smem_budget(smem_budget) // max(team_bytes(M, W, kernel), 1)
    warps = (512 if narrow and M > 1024 else 1024) // 32
    teams = min(fit, _BLOCK_TEAMS, warps // min(max(W // 2, 1), _MAX_TEAM))
    shots = max(teams, 1) * spt
    if cap is not None:
        shots = min(shots, cap)
    return 1 << (max(shots, 1).bit_length() - 1)


def eliminate_blocks_plain(Hp, s, K: int, m: int, rank: int = None,
                           full_jordan: bool = False,
                           exit_on_valid: bool = True,
                           return_steps: bool = False,
                           count_xor_words: bool = False, live=None,
                           block_shots: int = None, smem_budget: int = None):
    """Plain PyTorch version of kernels K2 and K5, on words-major (B, W, M)
    input: the same per-shot column steps, vectorized over shots, each shot
    frozen once it is done. One host read per column step, and one of
    ``live`` (the live slice runs; the other shots keep their inputs, with
    no pivot and no step).

    ``count_xor_words`` appends a (B,) int64 count of the word XORs the
    steps did: per step, the rows the pivot row was XORed into times the
    words it updated (those from the pivot's word on, or all of them under
    ``full_jordan``). It measures the elimination's data-dependent work for
    the kernels' operation bound; the decode path never asks for it.
    ``block_shots`` and ``smem_budget`` are accepted and ignored: every
    output is a function of the shot alone."""
    return _eliminate_plain(Hp, s, K, m, rank, full_jordan, exit_on_valid,
                            return_steps, group=1,
                            count_xor_words=count_xor_words, live=live)


def eliminate_blocks_fused_plain(Hp, s, K: int, m: int, rank: int = None,
                                 full_jordan: bool = False,
                                 exit_on_valid: bool = True,
                                 return_steps: bool = False, live=None,
                                 block_shots: int = None,
                                 smem_budget: int = None):
    """Plain PyTorch version of kernel K4, on words-major (B, W, M) input:
    K2's column steps, with the exit (rank reached, or residual inside the
    pivot span) tested only at the end of each 4-column group, and the
    columns of the last group at or beyond K never pivoting. ``steps``
    counts the columns of the groups a shot ran, at most K.
    ``block_shots`` and ``smem_budget`` are accepted and ignored."""
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
