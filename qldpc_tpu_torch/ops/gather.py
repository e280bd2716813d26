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

import torch

from .. import _kernels

# dynamic shared bytes a block may take: less room for the kernel's static
# reduction buffer and the tile's alignment pad
_SMEM_LIMIT = _kernels.SMEM_PER_BLOCK - 1024
_THREADS = 1024
_MAX_STAGE = 36        # GI_MAX_STAGE in csrc/gather_iter.cu
_GATHER_DTYPES = (torch.float32, torch.bfloat16)
_TAKE_DTYPES = (torch.float32, torch.int32)


def _check_iterate(x, idx, iters: int):
    if x.dim() != 2 or idx.shape != x.shape:
        raise ValueError(f"need x (rows, lanes) and idx of its shape; got "
                         f"{tuple(x.shape)} and {tuple(idx.shape)}")
    if x.dtype not in _GATHER_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")


def lanes_per_block(rows: int, lanes: int, itemsize: int, sms: int) -> int:
    """Lane columns one P1 block keeps in shared memory: as many as fit
    (tile plus uint16 offsets within the block's shared memory, at most
    ``_MAX_STAGE`` elements per thread) but no more than spread the lanes
    over the card's ``sms`` multiprocessors. Raises when one column does
    not fit: the kernel never falls back to device memory."""
    fit = min(_SMEM_LIMIT // (rows * (itemsize + 2)),
              _THREADS * _MAX_STAGE // rows)
    if fit < 1:
        raise ValueError(
            f"a column of {rows} rows of {itemsize}-byte elements exceeds "
            f"what one block holds on-chip ({_SMEM_LIMIT} bytes of shared "
            f"memory, {_THREADS * _MAX_STAGE} elements)")
    return max(1, min(fit, lanes // sms))


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
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    L = lanes_per_block(rows, lanes, x.element_size(), sms)
    x = x.contiguous()
    idx = idx.to(device=x.device, dtype=torch.int32).contiguous()
    total = torch.empty((1, lanes), dtype=x.dtype, device=x.device)
    tile = torch.empty_like(x)
    threads = min(_THREADS, max(32, -(-rows * L // 32) * 32))
    fn = _kernels.load("gather_iter").gather_iter_launch
    if not fn.argtypes:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 4 + [I] * 6 + [P]
        fn.restype = ctypes.c_int
    code = fn(x.data_ptr(), idx.data_ptr(), total.data_ptr(),
              tile.data_ptr(), rows, lanes, L, iters,
              int(x.dtype == torch.bfloat16), threads,
              _kernels.stream_ptr(x.device))
    _kernels.check(code, "gather_iter_launch")
    gather_iterate.launches += 1
    return total, tile


gather_iterate.launches = 0


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
    rows, cols = x.shape
    x = x.contiguous()
    idx = idx.to(device=x.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(x)
    fn = _kernels.load("take_along").take_along_launch
    if not fn.argtypes:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 3 + [I] * 3 + [P]
        fn.restype = ctypes.c_int
    code = fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, cols,
              axis, _kernels.stream_ptr(x.device))
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

