"""Bivariate Bicycle (BB) code construction.

A BB code is defined by two bivariate polynomials A(x, y), B(x, y) over the
group algebra of Z_ell x Z_m:

    A = sum_i x^{a_x_i} + sum_j y^{a_y_j}
    B = sum_i y^{b_y_i} + sum_j x^{b_x_j}

with x -> kron(roll(I_ell, p), I_m) and y -> kron(I_ell, roll(I_m, p)).
The CSS parity checks are Hx = [A | B] and Hz = [B^T | A^T].

Capability parity with the reference's offline generator
(reference generate_codes.py:16-128, which reconstructs A,B from powers the
same way and verifies against the external `qldpc` package) and with the
in-simulation reconstruction (reference src/codes/bb_code.py:50-71) — but
self-contained: logical operators come from models.gf2 instead of
an external dependency.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from . import gf2


def _x_mat(ell: int, m: int, p: int) -> np.ndarray:
    return np.kron(np.roll(np.eye(ell, dtype=np.uint8), p, axis=1),
                   np.eye(m, dtype=np.uint8))


def _y_mat(ell: int, m: int, p: int) -> np.ndarray:
    return np.kron(np.eye(ell, dtype=np.uint8),
                   np.roll(np.eye(m, dtype=np.uint8), p, axis=1))


@dataclasses.dataclass
class BBCode:
    """A bivariate bicycle code with its circuit-construction metadata."""

    name: str
    ell: int
    m: int
    a_x_powers: Sequence[int]
    a_y_powers: Sequence[int]
    b_y_powers: Sequence[int]
    b_x_powers: Sequence[int]
    distance: int
    Hx: np.ndarray = dataclasses.field(default=None, repr=False)
    Hz: np.ndarray = dataclasses.field(default=None, repr=False)
    Lx: np.ndarray = dataclasses.field(default=None, repr=False)
    Lz: np.ndarray = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.Hx is None:
            A = self.A_components()
            B = self.B_components()
            Asum = np.bitwise_xor.reduce(np.stack(A), axis=0)
            Bsum = np.bitwise_xor.reduce(np.stack(B), axis=0)
            self.Hx = np.hstack([Asum, Bsum]).astype(np.uint8)
            self.Hz = np.hstack([Bsum.T, Asum.T]).astype(np.uint8)
        if self.Lx is None:
            self.Lx, self.Lz = gf2.css_logical_ops(self.Hx, self.Hz)

    # --- component matrices (order matters: it fixes the CNOT schedule
    # neighbor directions; matches reference bb_code.py:56-66: x-powers of A
    # first, then y-powers; y-powers of B first, then x-powers) ---
    def A_components(self):
        comps = [_x_mat(self.ell, self.m, p) for p in self.a_x_powers]
        comps += [_y_mat(self.ell, self.m, p) for p in self.a_y_powers]
        while len(comps) < 3:
            comps.append(np.zeros((self.n2, self.n2), dtype=np.uint8))
        return comps

    def B_components(self):
        comps = [_y_mat(self.ell, self.m, p) for p in self.b_y_powers]
        comps += [_x_mat(self.ell, self.m, p) for p in self.b_x_powers]
        while len(comps) < 3:
            comps.append(np.zeros((self.n2, self.n2), dtype=np.uint8))
        return comps

    @property
    def n(self) -> int:
        return 2 * self.ell * self.m

    @property
    def n2(self) -> int:
        return self.ell * self.m

    @property
    def k(self) -> int:
        return int(self.Lx.shape[0])
