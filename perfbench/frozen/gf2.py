"""Host-side GF(2) linear algebra (NumPy, setup-time only).

Used for code construction (logical operators).
All functions operate on uint8 0/1 matrices.

Capability parity: the reference derives logical operators from the external
``qldpc`` package (reference generate_codes.py:131-145); this module makes the
framework self-contained by computing a valid symplectic logical basis from
(Hx, Hz) alone.
"""
from __future__ import annotations

import numpy as np


def _as_bits(a) -> np.ndarray:
    return (np.asarray(a) % 2).astype(np.uint8)


def row_reduce(A, full: bool = True):
    """Gauss(-Jordan) elimination over GF(2).

    Returns (R, pivot_cols) where R is the (reduced) row-echelon form of A.
    """
    R = _as_bits(A).copy()
    m, n = R.shape
    pivot_cols = []
    row = 0
    for col in range(n):
        if row >= m:
            break
        sub = np.nonzero(R[row:, col])[0]
        if sub.size == 0:
            continue
        piv = row + sub[0]
        if piv != row:
            R[[row, piv]] = R[[piv, row]]
        if full:
            others = np.nonzero(R[:, col])[0]
            others = others[others != row]
        else:
            others = row + 1 + np.nonzero(R[row + 1:, col])[0]
        R[others] ^= R[row]
        pivot_cols.append(col)
        row += 1
    return R, np.array(pivot_cols, dtype=np.int64)


def rank(A) -> int:
    _, piv = row_reduce(A, full=False)
    return len(piv)


def nullspace(A) -> np.ndarray:
    """Basis (rows) of {x : A x = 0 over GF(2)}. Shape (n - rank, n)."""
    A = _as_bits(A)
    m, n = A.shape
    R, piv = row_reduce(A, full=True)
    piv_set = set(piv.tolist())
    free = [j for j in range(n) if j not in piv_set]
    basis = np.zeros((len(free), n), dtype=np.uint8)
    for bi, j in enumerate(free):
        basis[bi, j] = 1
        # pivot rows: x[piv[r]] = sum of free entries in row r
        for r, pc in enumerate(piv):
            if R[r, j]:
                basis[bi, pc] = 1
    return basis


def css_logical_ops(Hx, Hz):
    """Compute paired logical operators (Lx, Lz) of a CSS code.

    Lx rows span ker(Hz)/rowspace(Hx); Lz rows span ker(Hx)/rowspace(Hz);
    the bases are paired so that Lx @ Lz.T = I_k over GF(2).

    Any valid basis is acceptable for logical-error-rate estimation (a
    residual fault pattern either acts trivially on the code space or not,
    independent of basis choice); reference parity for the *structure*
    (commutation/anticommutation) is tested in tests/test_codes.py.
    """
    Hx = _as_bits(Hx)
    Hz = _as_bits(Hz)
    n = Hx.shape[1]
    k = n - rank(Hx) - rank(Hz)
    if k <= 0:
        return np.zeros((0, n), np.uint8), np.zeros((0, n), np.uint8)

    # Candidate logicals: kernel vectors modulo stabilizer rowspace.
    def coset_reps(H_kernel_of, H_stab):
        ker = nullspace(H_kernel_of)
        reps = []
        span = _as_bits(H_stab).copy()
        r0 = rank(span)
        for v in ker:
            if rank(np.vstack([span, v[None, :]])) > r0:
                reps.append(v)
                span = np.vstack([span, v[None, :]])
                r0 += 1
            if len(reps) == k:
                break
        return np.array(reps, dtype=np.uint8)

    LX = coset_reps(Hz, Hx)  # X-type: commute with Z stabilizers
    LZ = coset_reps(Hx, Hz)  # Z-type: commute with X stabilizers
    assert LX.shape[0] == k and LZ.shape[0] == k

    # Symplectic Gram-Schmidt pairing: make M = LX @ LZ.T the identity.
    M = (LX @ LZ.T) % 2
    LX = LX.copy()
    LZ = LZ.copy()
    for i in range(k):
        # find partner column j >= i with M[i, j] = 1 (exists: LZ spans the
        # dual of the quotient, so row i of M is nonzero mod processed cols)
        js = np.nonzero(M[i, i:])[0]
        if js.size == 0:
            # swap in a later LX row whose pairing row is nonzero at >= i
            rs = [r for r in range(i + 1, k) if np.any(M[r, i:])]
            assert rs, "symplectic pairing failed"
            r = rs[0]
            LX[[i, r]] = LX[[r, i]]
            M[[i, r]] = M[[r, i]]
            js = np.nonzero(M[i, i:])[0]
        j = i + js[0]
        if j != i:
            LZ[[i, j]] = LZ[[j, i]]
            M[:, [i, j]] = M[:, [j, i]]
        # clear other pairings of row i / column i
        for r in range(k):
            if r != i and M[r, i]:
                LX[r] ^= LX[i]
                M[r] ^= M[i]
        for c in range(k):
            if c != i and M[i, c]:
                LZ[c] ^= LZ[i]
                M[:, c] ^= M[:, i]
    assert np.array_equal((LX @ LZ.T) % 2, np.eye(k, dtype=np.uint8))
    return LX, LZ
