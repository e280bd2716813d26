"""Vectorized circuit-level Pauli sampling + linear-map syndrome extraction.

Because Pauli-frame propagation is linear over GF(2), a Monte-Carlo trial
never walks the circuit on the device. The decoding-matrix builder
precomputes, for every elementary fault location, its augmented signature
(sparsified syndrome ++ logical effect). A batch of trials is then:

    1. sample per-gate-location randoms (uniform + Pauli category) from a
       ``torch.Generator`` on the device — B x n_locs, fully vectorized;
    2. derive per-elementary-location fault bits with small lookup tables
       (Y errors contribute to both the Z- and X-frames, two-qubit Paulis
       decompose into control/target legs — correlations preserved exactly);
    3. augmented = A_loc^T @ fault_bits mod 2 — one float32 matmul.

Exactness of step 3: a row of A_loc^T @ bits counts up to a few hundred set
signature bits, so the product must be exact on integers before ``& 1``.
float32 holds every integer below 2^24 and its inputs are 0/1, so the count
is exact whether or not TF32 is enabled (0 and 1 are exact in TF32 and the
accumulation stays float32). A bf16 product is NOT used: ``torch.matmul`` on
bf16 inputs returns bf16 and rounds counts above 256.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..models.builder import ROLE_CTRL, ROLE_SINGLE, ROLE_TGT
from ..models.circuit import LOC_IDLE, SyndromeCircuit

# --- two-qubit Pauli decomposition tables -------------------------------
# The 15 non-identity two-qubit Paulis, indexed as the reference samples
# them (reference src/noise/model.py:46-53): 0-2 = X/Y/Z on control,
# 3-5 = X/Y/Z on target, 6-8 = XX/YY/ZZ, 9-14 = XY,YX,YZ,ZY,XZ,ZX.
# A leg carries a Z-frame flip iff its Pauli is Y or Z, an X-frame flip iff
# its Pauli is X or Y.
_CTRL_PAULI = "XYZIIIXYZXYYZXZ"  # control-leg Pauli per category
_TGT_PAULI = "IIIXYZXYZYXZYZX"  # target-leg Pauli per category

Z_CTRL_LUT = np.array([c in "YZ" for c in _CTRL_PAULI], dtype=np.bool_)
Z_TGT_LUT = np.array([c in "YZ" for c in _TGT_PAULI], dtype=np.bool_)
X_CTRL_LUT = np.array([c in "XY" for c in _CTRL_PAULI], dtype=np.bool_)
X_TGT_LUT = np.array([c in "XY" for c in _TGT_PAULI], dtype=np.bool_)

# selector codes for per-elementary-location bit derivation
SEL_CONST = 0   # meas/prep location: error => frame flip
SEL_IDLE = 1    # idle: flip iff sampled single-qubit Pauli has the component
SEL_CTRL = 2    # CNOT control leg
SEL_TGT = 3     # CNOT target leg


@dataclasses.dataclass(frozen=True)
class TrialMaps:
    """Device-resident static data of the linear-map trial path (a basis)."""

    sel: torch.Tensor       # (L,) int32 selector per elementary location
    gate_loc: torch.Tensor  # (L,) int64 gate-location index
    A_loc_T: torch.Tensor   # (R, L) float32 per-location augmented signature
    num_syn: int            # syndrome rows (first num_syn rows of R axis)
    k: int                  # logical rows (last k rows)

    @property
    def num_locations(self) -> int:
        return self.A_loc_T.shape[1]


def trial_maps_from_arrays(sel, gate_loc, A_loc, num_syn: int, k: int,
                           device) -> TrialMaps:
    """TrialMaps from host arrays; ``A_loc`` is (L, R) 0/1."""
    dev = resolve_device(device)
    return TrialMaps(
        sel=torch.as_tensor(np.array(sel, np.int32), device=dev),
        gate_loc=torch.as_tensor(np.array(gate_loc, np.int64), device=dev),
        A_loc_T=torch.as_tensor(
            np.ascontiguousarray(np.asarray(A_loc, np.float32).T), device=dev),
        num_syn=int(num_syn), k=int(k))


def make_trial_maps(circ: SyndromeCircuit, matrices: dict, basis: str,
                    device=None) -> TrialMaps:
    """Assemble TrialMaps from builder output for basis 'Z' or 'X'."""
    b = basis.lower()
    role = matrices[f"{b}_loc_role"]
    gate_loc = matrices[f"{b}_loc_gate_loc"]
    cls = matrices[f"{b}_loc_class"]
    full = matrices["HZ_full"] if b == "z" else matrices["HX_full"]
    num_syn = matrices[f"first_logical_row{basis.upper()}"]
    kind = circ.loc_kind[gate_loc]
    sel = np.where(role == ROLE_CTRL, SEL_CTRL,
                   np.where(role == ROLE_TGT, SEL_TGT,
                            np.where(kind == LOC_IDLE, SEL_IDLE, SEL_CONST)))
    assert (role[sel == SEL_CONST] == ROLE_SINGLE).all()
    return trial_maps_from_arrays(sel, gate_loc, full[:, cls].T, num_syn,
                                  matrices["k"], device)


def sample_gate_randoms(gen: torch.Generator, batch: int, n_locs: int,
                        error_rate: float) -> tuple:
    """Per-gate-location randoms for a batch of trials, drawn on ``gen``'s
    device.

    Returns (err, pauli, cat2): err (B, n_locs) bool — an error occurred;
    pauli (B, n_locs) int32 in [0,3) — X/Y/Z choice for IDLE locations;
    cat2 (B, n_locs) int32 in [0,15) — two-qubit Pauli category for CNOTs.

    Draws two raw 32-bit words per location: one 32-bit uniform for the
    error indicator, one split 16/16 for the two categoricals via modular
    reduction (bias <= 3/2^16 relative — orders of magnitude below any
    Monte-Carlo error bar).
    """
    shape = (batch, n_locs)
    w = torch.randint(0, 1 << 32, shape, generator=gen, device=gen.device,
                      dtype=torch.int64)
    thresh = int(min(max(error_rate * 4294967296.0, 0.0), 4294967295.0))
    err = w < thresh
    c = torch.randint(0, 1 << 32, shape, generator=gen, device=gen.device,
                      dtype=torch.int64)
    pauli = ((c & 0xFFFF) % 3).to(torch.int32)
    cat2 = ((c >> 16) % 15).to(torch.int32)
    return err, pauli, cat2


_device_luts: dict = {}


def _on_device(lut, dev) -> torch.Tensor:
    """A lookup table on ``dev``, copied there once (a copy per round
    would make the host wait for the device)."""
    key = (id(lut), str(dev))
    if key not in _device_luts:
        _device_luts[key] = torch.as_tensor(lut, device=dev)
    return _device_luts[key]


def fault_bits(err, pauli, cat2, maps: TrialMaps, basis: str) -> torch.Tensor:
    """(L, B) bool fault-bit matrix for one frame basis (location-major, as
    the signature matmul consumes it)."""
    gl = maps.gate_loc
    e = err.index_select(1, gl).T                 # (L, B)
    p = pauli.index_select(1, gl).T
    t = cat2.index_select(1, gl).T.long()
    if basis.upper() == "Z":
        idle_hit = p != 0           # Y or Z has a Z component
        ctrl_lut, tgt_lut = Z_CTRL_LUT, Z_TGT_LUT
    else:
        idle_hit = p != 2           # X or Y has an X component
        ctrl_lut, tgt_lut = X_CTRL_LUT, X_TGT_LUT
    ctrl_hit = _on_device(ctrl_lut, e.device)[t]
    tgt_hit = _on_device(tgt_lut, e.device)[t]
    sel = maps.sel[:, None]
    hit = torch.where(sel == SEL_CONST, True,
                      torch.where(sel == SEL_IDLE, idle_hit,
                                  torch.where(sel == SEL_CTRL, ctrl_hit,
                                              tgt_hit)))
    return e & hit


def augmented_bits(bits_T: torch.Tensor, maps: TrialMaps) -> torch.Tensor:
    """(B, R) int8 augmented signature = (A_loc^T @ bits) mod 2, exact in
    float32 (see module docstring)."""
    counts = maps.A_loc_T @ bits_T.to(torch.float32)          # (R, B)
    return (counts.to(torch.int32) & 1).to(torch.int8).T.contiguous()


def trial_batch(gen: torch.Generator, error_rate, maps_z: TrialMaps,
                maps_x: TrialMaps, n_locs: int, batch: int,
                randoms: tuple = None) -> dict:
    """One batch of Monte-Carlo trials up to (but excluding) decoding.

    Returns syndrome_z (B, num_syn) and true_z (B, k) int8 from the Z-frame
    (decoded against HdecZ), and their X counterparts. Both frames derive
    from the same gate randoms, so Y errors and two-qubit Paulis stay
    correlated exactly. ``randoms=(err, pauli, cat2)`` replaces the draws
    from ``gen`` (which may then be None)."""
    if randoms is None:
        randoms = sample_gate_randoms(gen, batch, n_locs, error_rate)
    err, pauli, cat2 = randoms
    out = {}
    for basis, maps in (("z", maps_z), ("x", maps_x)):
        aug = augmented_bits(fault_bits(err, pauli, cat2, maps, basis), maps)
        out[f"syndrome_{basis}"] = aug[:, :maps.num_syn].contiguous()
        out[f"true_{basis}"] = aug[:, maps.num_syn:].contiguous()
    return out
