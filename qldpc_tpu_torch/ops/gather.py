"""Gathers of the kernel studies: CUDA kernels P1 and P2 and their plain
twins.

``gather_iterate`` (P1, ``csrc/gather_iter.cu``) is the counterpart of the
JAX package's ``scripts/pallas_gather_bench.py``: ``iters`` rounds of
``y = take_along_axis(y, idx, axis=0) + 1`` over a tile kept on-chip, then
the column sum. ``take_along`` (P2, ``csrc/take_along.cu``) is the
counterpart of ``scripts/pallas_gather_probe.py``'s kernel,
``take_along_axis`` on axis 0 or 1.

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs its
plain version on a CPU tensor; ``.launches`` on the wrapper counts the
kernel launches. Indices must lie in [0, size) of the gathered axis; the
kernels do not check them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _kernels

# dynamic shared bytes a block may take: less room for the kernel's static
# reduction buffer and the tile's alignment pad
_SMEM_LIMIT = _kernels.SMEM_PER_BLOCK - 1024
_MAX_ELEMS = 36864     # GI_MAX_ELEMS in csrc/gather_iter.cu (uint16 offsets)
_WIDE_THREADS = 1024   # GI_WIDE_THREADS: up to _WIDE_STAGE elements a thread
_WIDE_STAGE = 24       # (64 registers a thread hold E values and E/2 offsets)
_DEEP_THREADS = 512    # GI_DEEP_THREADS: up to 72 elements, 128 registers
_MAX_CLUSTER = 8       # GI_MAX_CLUSTER: the portable cluster size
_SEGMENT_BYTES = 32    # a device-memory sector: the row a cluster should cover
_GATHER_DTYPES = (torch.float32, torch.bfloat16)
_TAKE_DTYPES = (torch.float32, torch.int32)
_P, _I = ctypes.c_void_p, ctypes.c_int


def _bind(source: str, name: str, argtypes: list):
    fn = getattr(_kernels.load(source), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


@functools.cache
def _p1_launch():
    return _bind("gather_iter", "gather_iter_launch",
                 [_P] * 4 + [_I] * 7 + [_P])


@functools.cache
def _p1_info():
    return _bind("gather_iter", "gather_iter_info", [_I] * 6 + [_P])


@functools.cache
def _p2_launch():
    return _bind("take_along", "take_along_launch", [_P] * 3 + [_I] * 3 + [_P])


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _operands(x, idx):
    """x and idx as the kernels take them: copied only where x is not
    contiguous or idx is not contiguous int32 on x's device."""
    if not x.is_contiguous():
        x = x.contiguous()
    if idx.dtype != torch.int32 or idx.device != x.device \
            or not idx.is_contiguous():
        idx = idx.to(device=x.device, dtype=torch.int32).contiguous()
    return x, idx


def _check_iterate(x, idx, iters: int):
    if x.dim() != 2 or idx.shape != x.shape:
        raise ValueError(f"need x (rows, lanes) and idx of its shape; got "
                         f"{tuple(x.shape)} and {tuple(idx.shape)}")
    if x.dtype not in _GATHER_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")


class Plan(NamedTuple):
    """P1's launch: L lane columns a block, C blocks a cluster, threads."""
    lanes: int
    cluster: int
    threads: int


def launch_plan(rows: int, lanes: int, itemsize: int, sms: int,
                active_clusters=None) -> Plan:
    """P1's launch at (rows, lanes) on a card of ``sms`` multiprocessors.

    L: as many lane columns as a block holds (the tile plus its uint16
    offsets within its shared memory, at most ``_MAX_ELEMS`` elements) but
    no more than spread the lanes over the multiprocessors. Threads: 1024
    while 24 elements a thread hold the tile (fewer when one does), else
    512. C: the fewest blocks (a power of two, at most 8) whose C x L
    adjacent lanes make a 32-byte row segment, so the cluster's loads and
    stores cover whole sectors; given ``active_clusters(C)``, the clusters
    of C blocks the card holds at once, the largest C that runs the launch
    in the fewest waves (an H100's GPCs hold 15 clusters of 8 blocks of one
    an SM, 120 blocks, where 128 lanes of tall columns need 128). Raises
    when one column does not fit: the kernel never falls back to device
    memory."""
    fit = min(_SMEM_LIMIT // (rows * (itemsize + 2)), _MAX_ELEMS // rows)
    if fit < 1:
        raise ValueError(
            f"a column of {rows} rows of {itemsize}-byte elements exceeds "
            f"what one block holds on-chip ({_SMEM_LIMIT} bytes of shared "
            f"memory, {_MAX_ELEMS} elements)")
    L = max(1, min(fit, lanes // sms))
    n = rows * L
    threads = (min(_WIDE_THREADS, -(-n // 32) * 32)
               if n <= _WIDE_THREADS * _WIDE_STAGE else _DEEP_THREADS)
    C = 1
    while C < _MAX_CLUSTER and C * L * itemsize < _SEGMENT_BYTES:
        C *= 2
    if active_clusters is not None:
        blocks = -(-lanes // L)
        waves = {}
        for c in (C >> k for k in range(C.bit_length())):  # C, C / 2, .., 1
            clusters = -(-blocks // c)
            waves[c] = -(-clusters // max(1, active_clusters(c)))
        C = next(c for c, w in waves.items() if w == min(waves.values()))
    return Plan(L, C, threads)


def _launch_info(rows, lanes, plan, is_bf16, index) -> dict:
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(index):
        code = _p1_info()(rows, lanes, plan.lanes, plan.cluster, is_bf16,
                          plan.threads, out)
    _kernels.check(code, "gather_iter_info")
    return dict(zip(("active_clusters", "registers", "local_bytes", "stage",
                     "blocks", "smem_bytes"), out))


@functools.lru_cache(maxsize=256)
def _device_plan(rows, lanes, itemsize, is_bf16, index) -> Plan:
    """The plan on card ``index``, its cluster size fitted to the clusters
    the card holds at once."""
    sms = _sm_count(index)
    first = launch_plan(rows, lanes, itemsize, sms)

    def active(c):
        return _launch_info(rows, lanes, first._replace(cluster=c), is_bf16,
                            index)["active_clusters"]

    return launch_plan(rows, lanes, itemsize, sms, active)


def launch_info(rows: int, lanes: int, dtype=torch.float32,
                device="cuda") -> dict:
    """P1's launch at (rows, lanes) on a CUDA ``device``: its plan and what
    the card makes of it: ``active_clusters`` (clusters of this launch the
    card holds at once), ``clusters`` (the launch's), ``registers`` and
    ``local_bytes`` (spilled) a thread, ``stage`` (E, elements a thread),
    ``blocks`` and ``smem_bytes`` a block."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    itemsize = torch.empty((), dtype=dtype).element_size()
    is_bf16 = int(dtype == torch.bfloat16)
    plan = _device_plan(rows, lanes, itemsize, is_bf16, index)
    info = _launch_info(rows, lanes, plan, is_bf16, index)
    return dict(plan._asdict(), clusters=info["blocks"] // plan.cluster,
                **info)


def gather_iterate(x, idx, iters: int):
    """P1. x (rows, lanes) float32 or bfloat16, idx (rows, lanes) int32 in
    [0, rows). Returns (total (1, lanes), tile (rows, lanes)), both in x's
    dtype: the tile after ``iters`` rounds of
    ``y[r, l] = y[idx[r, l], l] + 1`` and its column sums (accumulated in
    float32, rounded once). CUDA tensors launch the kernel; CPU tensors run
    :func:`gather_iterate_plain`."""
    _check_iterate(x, idx, iters)
    if x.device.type == "cpu":
        return gather_iterate_plain(x, idx, iters)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    rows, lanes = x.shape
    plan = _device_plan(rows, lanes, x.element_size(),
                        int(x.dtype == torch.bfloat16), x.device.index)
    out = _launch(x, idx, iters, plan)
    gather_iterate.launches += 1
    return out


gather_iterate.launches = 0


def _launch(x, idx, iters: int, plan: Plan):
    """One P1 launch of ``plan`` on CUDA tensors: (total, tile)."""
    rows, lanes = x.shape
    x, idx = _operands(x, idx)
    total = torch.empty((1, lanes), dtype=x.dtype, device=x.device)
    tile = torch.empty_like(x)
    code = _p1_launch()(x.data_ptr(), idx.data_ptr(), total.data_ptr(),
                        tile.data_ptr(), rows, lanes, plan.lanes,
                        plan.cluster, iters, int(x.dtype == torch.bfloat16),
                        plan.threads, _kernels.stream_ptr(x.device))
    _kernels.check(code, "gather_iter_launch")
    return total, tile


def gather_iterate_plain(x, idx, iters: int):
    """Plain version of P1: the JAX script's XLA line (``xla_gather``) in
    PyTorch, ``iters`` times ``acc = gather(acc, 0, idx) + 1``, then the
    column sum in float32 rounded once to x's dtype. Returns (total, tile)
    as :func:`gather_iterate`."""
    _check_iterate(x, idx, iters)
    index = idx.to(device=x.device, dtype=torch.int64)
    acc = x
    for _ in range(iters):
        acc = torch.gather(acc, 0, index) + 1
    total = acc.sum(0, keepdim=True, dtype=torch.float32).to(x.dtype)
    return total, acc


def _check_take(x, idx, axis: int):
    if x.dim() != 2 or idx.shape != x.shape:
        raise ValueError(f"need x 2-D and idx of its shape; got "
                         f"{tuple(x.shape)} and {tuple(idx.shape)}")
    if x.dtype not in _TAKE_DTYPES:
        raise ValueError(f"x must be float32 or int32, got {x.dtype}")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")


def take_along(x, idx, axis: int):
    """P2. ``take_along_axis(x, idx, axis)`` for x (rows, cols) float32 or
    int32 and idx int32 of x's shape, with indices inside ``axis``. CUDA
    tensors launch the kernel; CPU tensors run :func:`take_along_plain`."""
    _check_take(x, idx, axis)
    if x.device.type == "cpu":
        return take_along_plain(x, idx, axis)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x, idx = _operands(x, idx)
    out = torch.empty_like(x)
    code = _p2_launch()(x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                        x.shape[0], x.shape[1], axis,
                        _kernels.stream_ptr(x.device))
    _kernels.check(code, "take_along_launch")
    take_along.launches += 1
    return out


take_along.launches = 0


def take_along_plain(x, idx, axis: int):
    """Plain version of P2: the index expression written out, with the
    other axis broadcast from an arange."""
    _check_take(x, idx, axis)
    rows, cols = x.shape
    index = idx.to(device=x.device, dtype=torch.int64)
    if axis == 0:
        return x[index, torch.arange(cols, device=x.device)[None, :]]
    return x[torch.arange(rows, device=x.device)[:, None], index]

