"""Content-hash decoding-matrix cache, file-compatible with the JAX package.

The port's own copy of ``qldpc_tpu/utils/caching.py``: the same key
(sha256 over Hx|Hz|Lx|Lz bytes + num_cycles + "%.6f" rate, first 16 hex)
and the same ``matrices_<key>.npz`` layout (integer metadata stored as
one-element arrays), so a cache written by either package loads in the
other.
"""
from __future__ import annotations

import hashlib
import os
import zipfile
from typing import Any, Dict, Optional

import numpy as np

_INT_KEYS = ("first_logical_rowZ", "first_logical_rowX", "num_cycles", "k")


def compute_cache_key(Hx, Hz, Lx, Lz, num_cycles, error_rate) -> str:
    hasher = hashlib.sha256()
    for arr in [Hx, Hz, Lx, Lz]:
        hasher.update(np.asarray(arr).tobytes())
    hasher.update(str(num_cycles).encode())
    hasher.update(f"{error_rate:.6f}".encode())
    return hasher.hexdigest()[:16]


def save_matrices(cache_dir: str, cache_key: str, matrices: Dict) -> str:
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"matrices_{cache_key}.npz")
    payload = {}
    for k, v in matrices.items():
        payload[k] = np.asarray([v]) if k in _INT_KEYS else np.asarray(v)
    np.savez_compressed(path, **payload)
    return path


def load_matrices(cache_dir: str, cache_key: str) -> Optional[Dict[str, Any]]:
    """The cached matrices, or None when the file is missing or unreadable
    (a torn or foreign file is rebuilt rather than trusted)."""
    path = os.path.join(cache_dir, f"matrices_{cache_key}.npz")
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as data:
            return {k: int(data[k][0]) if k in _INT_KEYS else data[k]
                    for k in data.files}
    except (OSError, EOFError, ValueError, KeyError, IndexError,
            zipfile.BadZipFile):
        return None
