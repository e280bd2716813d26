"""Bivariate Bicycle (BB) code construction and registry.

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
import os
from typing import Dict, Optional, Sequence

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

    def validate(self):
        """CSS orthogonality and logical (anti)commutation invariants."""
        assert not ((self.Hx @ self.Hz.T) % 2).any(), "Hx Hz^T != 0"
        assert not ((self.Hz @ self.Lx.T) % 2).any(), "Lx not in ker Hz"
        assert not ((self.Hx @ self.Lz.T) % 2).any(), "Lz not in ker Hx"
        k = self.k
        assert np.array_equal((self.Lx @ self.Lz.T) % 2, np.eye(k, dtype=int) % 2)
        return True

    # --- npz persistence, format-compatible with the reference's
    # codes/*.npz (keys per reference generate_codes.py:154-168) ---
    def save_npz(self, path: str):
        np.savez(
            path,
            Hx=self.Hx.astype(np.int64), Hz=self.Hz.astype(np.int64),
            Lx=self.Lx.astype(np.uint8), Lz=self.Lz.astype(np.uint8),
            distance=self.distance, ell=self.ell, m=self.m,
            a_x_powers=np.array(self.a_x_powers),
            a_y_powers=np.array(self.a_y_powers),
            b_y_powers=np.array(self.b_y_powers),
            b_x_powers=np.array(self.b_x_powers),
        )

    @classmethod
    def load_npz(cls, path: str, name: Optional[str] = None) -> "BBCode":
        d = np.load(path)
        return cls(
            name=name or os.path.splitext(os.path.basename(path))[0],
            ell=int(d["ell"]), m=int(d["m"]),
            a_x_powers=list(np.atleast_1d(d["a_x_powers"])),
            a_y_powers=list(np.atleast_1d(d["a_y_powers"])),
            b_y_powers=list(np.atleast_1d(d["b_y_powers"])),
            b_x_powers=list(np.atleast_1d(d["b_x_powers"])),
            distance=int(d["distance"]) if "distance" in d else 0,
            Hx=(np.asarray(d["Hx"]) % 2).astype(np.uint8),
            Hz=(np.asarray(d["Hz"]) % 2).astype(np.uint8),
            Lx=(np.asarray(d["Lx"]) % 2).astype(np.uint8) if "Lx" in d else None,
            Lz=(np.asarray(d["Lz"]) % 2).astype(np.uint8) if "Lz" in d else None,
        )


# The five IBM-style BB codes the reference family covers
# (polynomial parameters per reference generate_codes.py:16-88).
CODE_REGISTRY: Dict[str, dict] = {
    "[[72, 12, 6]]": dict(ell=6, m=6, a_x_powers=[3], a_y_powers=[1, 2],
                          b_y_powers=[3], b_x_powers=[1, 2], distance=6),
    "[[90, 8, 10]]": dict(ell=15, m=3, a_x_powers=[9], a_y_powers=[1, 2],
                          b_y_powers=[0], b_x_powers=[2, 7], distance=10),
    "[[108, 8, 10]]": dict(ell=9, m=6, a_x_powers=[3], a_y_powers=[1, 2],
                           b_y_powers=[3], b_x_powers=[1, 2], distance=10),
    "[[144, 12, 12]]": dict(ell=12, m=6, a_x_powers=[3], a_y_powers=[1, 2],
                            b_y_powers=[3], b_x_powers=[1, 2], distance=12),
    "[[288, 12, 18]]": dict(ell=12, m=12, a_x_powers=[3], a_y_powers=[2, 7],
                            b_y_powers=[3], b_x_powers=[1, 2], distance=18),
}


@dataclasses.dataclass
class RawCSSCode:
    """A CSS code given only by its parity-check (and optional logical)
    matrices — no polynomial structure. The circuit builder then derives
    CNOT neighbor directions from the Hx/Hz rows directly (the reference's
    fallback path, bb_code.py:132-151)."""

    Hx: np.ndarray
    Hz: np.ndarray
    Lx: np.ndarray = None
    Lz: np.ndarray = None
    name: str = "raw"
    has_component_params = False

    def __post_init__(self):
        self.Hx = (np.asarray(self.Hx) % 2).astype(np.uint8)
        self.Hz = (np.asarray(self.Hz) % 2).astype(np.uint8)
        if self.Lx is None:
            self.Lx, self.Lz = gf2.css_logical_ops(self.Hx, self.Hz)
        else:
            self.Lx = (np.asarray(self.Lx) % 2).astype(np.uint8)
            self.Lz = (np.asarray(self.Lz) % 2).astype(np.uint8)

    @property
    def n(self) -> int:
        return int(self.Hx.shape[1])

    @property
    def n2(self) -> int:
        return self.n // 2

    @property
    def k(self) -> int:
        return int(self.Lx.shape[0])


def make_code(Hx, Hz, Lx=None, Lz=None, **bb_params):
    """Build a code object from raw matrices, using polynomial metadata when
    provided (``ell, m, a_x_powers, ...`` — the reference's npz keys)."""
    if bb_params.get("ell") is not None and bb_params.get("m") is not None:
        code = BBCode(
            name=bb_params.get("name", "custom"),
            ell=int(bb_params["ell"]), m=int(bb_params["m"]),
            a_x_powers=list(np.atleast_1d(bb_params.get("a_x_powers", []))),
            a_y_powers=list(np.atleast_1d(bb_params.get("a_y_powers", []))),
            b_y_powers=list(np.atleast_1d(bb_params.get("b_y_powers", []))),
            b_x_powers=list(np.atleast_1d(bb_params.get("b_x_powers", []))),
            distance=int(bb_params.get("distance", 0)),
            Hx=(np.asarray(Hx) % 2).astype(np.uint8),
            Hz=(np.asarray(Hz) % 2).astype(np.uint8),
            Lx=None if Lx is None else (np.asarray(Lx) % 2).astype(np.uint8),
            Lz=None if Lz is None else (np.asarray(Lz) % 2).astype(np.uint8),
        )
        return code
    return RawCSSCode(Hx=Hx, Hz=Hz, Lx=Lx, Lz=Lz)


def get_code(name: str) -> BBCode:
    """Build a registry code by name, e.g. ``get_code("[[144, 12, 12]]")``."""
    if name not in CODE_REGISTRY:
        raise KeyError(f"unknown code {name!r}; known: {list(CODE_REGISTRY)}")
    return BBCode(name=name, **CODE_REGISTRY[name])
