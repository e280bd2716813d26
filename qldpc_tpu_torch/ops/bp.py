"""Min-sum BP constants and alpha schedules shared by the lifted decoders.

The generic padded-CSR decoder of the JAX package (``TannerGraph``,
``decode_batch``) is not ported yet; this module holds what the flooding
lifted path needs.
"""
from __future__ import annotations

import numpy as np

_BIG = 1e30  # padded-lane magnitude: sign +, never the row min


def alpha_schedule(mode: str, maxIter: int, alpha=1.0) -> np.ndarray:
    """Per-iteration normalization factors (reference dense.py:47-51)."""
    if mode == "dynamical":
        return (1.0 - 2.0 ** (-(np.arange(maxIter) + 1.0))).astype(np.float32)
    if mode == "alvarado":
        a = float(alpha)
        if a <= 0:
            raise ValueError("alpha must be > 0 when alpha_mode='alvarado'")
        return np.full(maxIter, a, dtype=np.float32)
    if mode == "alvarado-autoregressive":
        seq = np.asarray(alpha, dtype=np.float32).ravel()
        if seq.size == 0:
            raise ValueError("alpha sequence must be non-empty")
        if seq.size >= maxIter:
            return seq[:maxIter].copy()
        return np.concatenate([seq, np.full(maxIter - seq.size, seq[-1],
                                            dtype=np.float32)])
    raise ValueError(f"Unsupported alpha_mode: {mode}")
