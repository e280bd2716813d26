"""Compile-on-demand ctypes bindings for the native host kernels.

Builds ``gf2kernels.cc`` beside this file with ``g++ -O3`` at first use
into ``build/native/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source, the flags and the host
CPU's features, so an edited source, or another CPU, rebuilds and an
unchanged one is reused. Every entry point returns
None when no toolchain is available: callers fall back to the NumPy paths
(``models/gf2.py``, ``models/pauli_frame.py``) or, for the baseline, to an
estimate. This is host code; no device path depends on it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "gf2kernels.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_lib = None
_tried = False


def _cpu_flags() -> bytes:
    """The host CPU's feature flags (``-march=native`` compiles for them),
    so a checkout copied to another machine builds its own library."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        return b""


def _target() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_cpu_flags())
    return BUILD_DIR / f"libgf2kernels-{h.hexdigest()[:12]}.so"


def _compile() -> Optional[Path]:
    so = _target()
    if so.exists():
        return so
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None


def get_lib():
    """The loaded native library, or None if it cannot be built."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _compile()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.propagate_frames.argtypes = [
            i32p, i32p, i32p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            i64p, i64p, i64p, ctypes.c_int64, u64p, u64p]
        lib.propagate_frames.restype = None
        lib.gf2_eliminate_packed.argtypes = [
            u64p, u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i64p]
        lib.gf2_eliminate_packed.restype = ctypes.c_int64
        lib.baseline_decode_trials.argtypes = [
            ctypes.c_int64, ctypes.c_int64, i64p, i32p, f32p, u8p,
            ctypes.c_int64, ctypes.c_int64, f32p, ctypes.c_float,
            ctypes.c_int64, ctypes.c_int64, u8p, f64p, u8p]
        lib.baseline_decode_trials.restype = ctypes.c_double
        _lib = lib
        return _lib


def propagate_frames_native(ops, q1, q2, basis_z: bool, op_prep: int,
                            op_meas: int, total_qubits: int, num_meas: int,
                            inj_pos, inj_q, inj_bit, nbatch: int):
    """Native batched frame propagation; returns (syn, state) packed uint64
    arrays, or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    W = (nbatch + 63) // 64
    state = np.zeros((total_qubits, W), dtype=np.uint64)
    syn = np.zeros((max(num_meas, 1), W), dtype=np.uint64)
    lib.propagate_frames(
        np.ascontiguousarray(ops, np.int32),
        np.ascontiguousarray(q1, np.int32),
        np.ascontiguousarray(q2, np.int32),
        len(ops), int(basis_z), op_prep, op_meas, W,
        np.ascontiguousarray(inj_pos, np.int64),
        np.ascontiguousarray(inj_q, np.int64),
        np.ascontiguousarray(inj_bit, np.int64),
        len(inj_pos), state, syn)
    return syn[:num_meas], state


def baseline_decode_native(H, prior, syndromes, maxIter: int, alpha_seq,
                           clip: float = 20.0, order: int = 2,
                           num_test: int = 12, return_solutions: bool = False):
    """Measured single-core native decode: min-sum BP + OSD-``order``
    fallback over ``syndromes`` (ntrials, m). Returns (elapsed_sec,
    conv_flags), plus the (ntrials, n) solutions when
    ``return_solutions``, or None if the native library is unavailable.
    This is the denominator of the bench's ``vs_baseline``: a C++
    rendering of the reference's per-trial decode path (reference
    src/decoding/kernels.py:234-366 + src/decoding/osd.py:5-77)."""
    lib = get_lib()
    if lib is None:
        return None
    H = np.asarray(H) != 0
    m, n = H.shape
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(H.sum(axis=1), out=indptr[1:])
    indices = np.concatenate([np.nonzero(H[i])[0] for i in range(m)]).astype(
        np.int32)
    syndromes = np.ascontiguousarray(syndromes, np.uint8)
    ntrials = syndromes.shape[0]
    conv = np.zeros(ntrials, dtype=np.uint8)
    wsum = np.zeros(1, dtype=np.float64)
    sol = np.zeros((ntrials, n), dtype=np.uint8)
    elapsed = lib.baseline_decode_trials(
        m, n, indptr, indices,
        np.ascontiguousarray(prior, np.float32), syndromes, ntrials,
        maxIter, np.ascontiguousarray(alpha_seq, np.float32),
        float(clip), order, num_test, conv, wsum, sol)
    if return_solutions:
        return float(elapsed), conv, sol
    return float(elapsed), conv


def gf2_eliminate_native(A_packed: np.ndarray, s: np.ndarray, ncols: int):
    """In-place native Gauss-Jordan of (m, W) uint64 row words; returns
    prow_of_col (ncols,) int64, or None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    m, W = A_packed.shape
    prow = np.empty(ncols, dtype=np.int64)
    lib.gf2_eliminate_packed(A_packed, s, m, W, ncols, prow)
    return prow
