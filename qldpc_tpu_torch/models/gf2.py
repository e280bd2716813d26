"""Host-side GF(2) linear algebra (NumPy, setup-time only; ranks and column
bases of decoding matrices through the native eliminator of
``native/build.py`` where g++ is present).

Used for code construction (logical operators, rank checks) and as the
oracle tier for the batched on-device GF(2) routines in ``qldpc_tpu_torch.ops``.
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


def _native_pivots(A: np.ndarray):
    """prow_of_col (n,) of A's greedy elimination by the native bit-packed
    eliminator (``native/build.py``), or None without a toolchain."""
    from ..native.build import gf2_eliminate_native
    m, n = A.shape
    packed = np.packbits(A, axis=1, bitorder="little")
    pad = (-packed.shape[1]) % 8
    if pad:
        packed = np.pad(packed, ((0, 0), (0, pad)))
    words = np.ascontiguousarray(packed).view(np.uint64)
    return gf2_eliminate_native(words, np.zeros(m, dtype=np.uint8), n)


def rank_fast(A) -> int:
    """GF(2) rank via the native bit-packed eliminator, or the NumPy
    elimination without a toolchain (large decoding matrices take minutes
    there)."""
    A = _as_bits(A)
    prow = _native_pivots(A)
    if prow is not None:
        return int((prow >= 0).sum())
    return rank(A)


def column_basis(A) -> np.ndarray:
    """Indices of the greedy (first-independent, natural order) column basis
    of A over GF(2) — the lexicographically-first ``rank`` columns that span
    the column space. Used by OSD to complete per-shot reliability-ordered
    eliminations to full rank (see ops/osd.py). Native eliminator, or NumPy
    without a toolchain."""
    A = _as_bits(A)
    prow = _native_pivots(A)
    if prow is not None:
        return np.nonzero(prow >= 0)[0].astype(np.int32)
    _, piv = row_reduce(A, full=False)
    return piv.astype(np.int32)


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


def solve(A, b):
    """One solution x of A x = b over GF(2), or None if inconsistent."""
    A = _as_bits(A)
    b = _as_bits(b).reshape(-1)
    m, n = A.shape
    aug = np.concatenate([A, b[:, None]], axis=1)
    R, piv = row_reduce(aug, full=True)
    # Inconsistent if a pivot lands in the augmented column.
    if len(piv) and piv[-1] == n:
        return None
    x = np.zeros(n, dtype=np.uint8)
    for r, pc in enumerate(piv):
        x[pc] = R[r, n]
    return x


def in_rowspace(A, v) -> bool:
    A = _as_bits(A)
    v = _as_bits(v).reshape(1, -1)
    return rank(np.vstack([A, v])) == rank(A)


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


def css_standard_form_logicals(Hx, Hz):
    """Paired logical operators (Lx, Lz) of a CSS code in standard form.

    The columns split into the pivot columns P of Hx's reduced row-echelon
    form, the pivot columns Q of Hz's reduced form on the remaining
    columns, and the k columns T left over. Logical j is the unit vector
    on T[j] completed into a kernel vector: Lz[j] = e_T[j] plus Hx's
    reduced column T[j] on P (zero on Q), Lx[j] = e_T[j] plus Hz's reduced
    column T[j] on Q (zero on P). So Lx @ Lz.T = I. This is the basis in
    which the reference's sampled trials record their true logicals
    (``scripts/oracle_data/``); :func:`css_logical_ops` gives another
    basis of the same logical operators."""
    Hx = _as_bits(Hx)
    Hz = _as_bits(Hz)
    n = Hx.shape[1]
    Rx, px = row_reduce(Hx)
    rest = np.setdiff1d(np.arange(n), px)
    Rz, qz = row_reduce(Hz[:, rest])
    T = np.setdiff1d(np.arange(len(rest)), qz)
    k = len(T)
    Lx = np.zeros((k, n), np.uint8)
    Lz = np.zeros((k, n), np.uint8)
    for j, t in enumerate(T):
        Lz[j, rest[t]] = Lx[j, rest[t]] = 1
        Lz[j, px] = Rx[:len(px), rest[t]]
        Lx[j, rest[qz]] = Rz[:len(qz), t]
    return Lx, Lz
