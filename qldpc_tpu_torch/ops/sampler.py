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

On a CUDA tensor steps 2 and 3 are one launch of kernel S1
(``csrc/trial_syndromes.cu``, :func:`trial_syndromes`) for both frames: it
reads each shot's ``err`` row once and, at the erring gate locations only,
XORs the flipped elementary locations' signature rows into a bitset, read
from :class:`TrialMaps`' CSR tables, the one form of A_loc^T it holds. The
two steps above are its plain version (:func:`trial_syndromes_plain`),
which CPU tensors run.

Exactness of step 3: a row of A_loc^T @ bits counts up to a few hundred set
signature bits, so the product must be exact on integers before ``& 1``.
float32 holds every integer below 2^24 and its inputs are 0/1, so the count
is exact whether or not TF32 is enabled (0 and 1 are exact in TF32 and the
accumulation stays float32). A bf16 product is NOT used: ``torch.matmul`` on
bf16 inputs returns bf16 and rounds counts above 256.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .. import _kernels, resolve_device
from ..models.builder import ROLE_CTRL, ROLE_SINGLE, ROLE_TGT
from ..models.circuit import LOC_IDLE, SyndromeCircuit
from ..utils import telemetry

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


def _mask(lut) -> int:
    return sum(1 << i for i, hit in enumerate(lut) if hit)


# The flip rules of fault_bits as S1 takes them, a frame each (Z, X): the
# idle Pauli that leaves the frame alone (X for Z, Z for X), and the 15-bit
# masks of the two-qubit categories whose control / target leg flips it.
FRAME_RULES = ((0, _mask(Z_CTRL_LUT), _mask(Z_TGT_LUT)),
               (2, _mask(X_CTRL_LUT), _mask(X_TGT_LUT)))


@dataclasses.dataclass(frozen=True)
class TrialMaps:
    """Device-resident static data of the linear-map trial path (a basis).

    ``sel`` and ``gate_loc`` are the plain version's, ``loc_ptr`` /
    ``loc_entry`` the same map as S1 reads it: the elementary locations of
    each gate location (CSR over the gate locations up to the last that has
    one, each entry ``location << 2 | selector``). Both read ``sig_ptr`` /
    ``sig_row``: the set rows of each location's signature (CSR)."""

    sel: torch.Tensor       # (L,) int32 selector per elementary location
    gate_loc: torch.Tensor  # (L,) int64 gate-location index
    num_syn: int            # syndrome rows (first num_syn rows of R axis)
    k: int                  # logical rows (last k rows)
    loc_ptr: torch.Tensor    # (G + 1,) int32, G = max(gate_loc) + 1
    loc_entry: torch.Tensor  # (L,) int32 location << 2 | selector
    sig_ptr: torch.Tensor    # (L + 1,) int32
    sig_row: torch.Tensor    # (nnz,) int32 rows, ascending a location

    @property
    def num_locations(self) -> int:
        return self.sel.shape[0]


def signature_rows(columns, loc_col) -> tuple:
    """(sig_ptr, sig_row) int32: the set rows, ascending, of column
    ``loc_col[l]`` of the 0/1 matrix ``columns`` (R, C) for each location l."""
    col, row = np.nonzero(np.asarray(columns).T)  # by column, then row
    col_ptr = np.searchsorted(col, np.arange(columns.shape[1] + 1))
    loc_col = np.asarray(loc_col, np.int64)
    counts = col_ptr[loc_col + 1] - col_ptr[loc_col]
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    start = np.repeat(col_ptr[loc_col] - ptr[:-1], counts)
    return ptr, row[start + np.arange(ptr[-1])].astype(np.int32)


def _trial_maps(sel, gate_loc, signature, num_syn, k, device) -> TrialMaps:
    """TrialMaps on ``device``, ``loc_ptr`` / ``loc_entry`` built here."""
    sel, gate_loc = np.array(sel, np.int32), np.array(gate_loc, np.int64)
    if gate_loc.size >= 2 ** 29:
        raise ValueError(f"{gate_loc.size} elementary locations: an entry "
                         f"packs its location in 29 bits")
    order = np.argsort(gate_loc, kind="stable")
    gates = int(gate_loc.max()) + 1 if gate_loc.size else 0
    loc_ptr = np.searchsorted(gate_loc[order], np.arange(gates + 1))
    loc_entry = (order << 2) | sel[order]
    t = functools.partial(torch.as_tensor, device=resolve_device(device))
    return TrialMaps(t(sel), t(gate_loc), int(num_syn), int(k),
                     t(loc_ptr.astype(np.int32)),
                     t(loc_entry.astype(np.int32)), *map(t, signature))


def trial_maps_from_arrays(sel, gate_loc, A_loc, num_syn: int, k: int,
                           device) -> TrialMaps:
    """TrialMaps from host arrays; ``A_loc`` is (L, R) 0/1."""
    A_loc = np.asarray(A_loc)
    return _trial_maps(sel, gate_loc,
                       signature_rows(A_loc.T, np.arange(A_loc.shape[0])),
                       num_syn, k, device)


def make_trial_maps(circ: SyndromeCircuit, matrices: dict, basis: str,
                    device=None) -> TrialMaps:
    """Assemble TrialMaps from builder output for basis 'Z' or 'X'."""
    b = basis.lower()
    role = matrices[f"{b}_loc_role"]
    gate_loc = matrices[f"{b}_loc_gate_loc"]
    full = matrices["HZ_full"] if b == "z" else matrices["HX_full"]
    num_syn = matrices[f"first_logical_row{basis.upper()}"]
    kind = circ.loc_kind[gate_loc]
    sel = np.where(role == ROLE_CTRL, SEL_CTRL,
                   np.where(role == ROLE_TGT, SEL_TGT,
                            np.where(kind == LOC_IDLE, SEL_IDLE, SEL_CONST)))
    assert (role[sel == SEL_CONST] == ROLE_SINGLE).all()
    return _trial_maps(sel, gate_loc,
                       signature_rows(full, matrices[f"{b}_loc_class"]),
                       num_syn, matrices["k"], device)


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


def signature_matrix(maps: TrialMaps) -> torch.Tensor:
    """(R, L) float32 A_loc^T, scattered from ``sig_ptr`` / ``sig_row`` on
    their device."""
    A = torch.zeros((maps.num_syn + maps.k, maps.num_locations),
                    device=maps.sig_row.device)
    A[maps.sig_row.long(), torch.repeat_interleave(
        maps.sig_ptr.diff(), output_size=maps.sig_row.shape[0])] = 1
    return A


def augmented_bits(bits_T: torch.Tensor, maps: TrialMaps) -> torch.Tensor:
    """(B, R) int8 augmented signature = (A_loc^T @ bits) mod 2, exact in
    float32 (see module docstring)."""
    counts = signature_matrix(maps) @ bits_T.to(torch.float32)  # (R, B)
    return (counts.to(torch.int32) & 1).to(torch.int8).T.contiguous()


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _s1_launch():
    fn = _kernels.load("trial_syndromes").trial_syndromes_launch
    frame = [_P] * 6 + [_I] * 6
    fn.argtypes = [_P] * 3 + [_I] * 2 + frame + frame + [_P] * 2
    fn.restype = ctypes.c_int
    return fn


def trial_syndromes_plain(err, pauli, cat2, maps_z: TrialMaps,
                          maps_x: TrialMaps) -> dict:
    """Plain version of S1: :func:`fault_bits` and :func:`augmented_bits`
    a frame; counts the flipped locations as ``sampling.flips`` when
    telemetry is on."""
    out = {}
    for basis, maps in (("z", maps_z), ("x", maps_x)):
        bits = fault_bits(err, pauli, cat2, maps, basis)
        if telemetry.enabled():
            telemetry.count("sampling.flips", bits.sum())
        aug = augmented_bits(bits, maps)
        out[f"syndrome_{basis}"] = aug[:, :maps.num_syn].contiguous()
        out[f"true_{basis}"] = aug[:, maps.num_syn:].contiguous()
    return out


def _frame_args(maps: TrialMaps, syn, tru, rules) -> list:
    return [maps.loc_ptr.data_ptr(), maps.loc_entry.data_ptr(),
            maps.sig_ptr.data_ptr(), maps.sig_row.data_ptr(), syn.data_ptr(),
            tru.data_ptr(), maps.loc_ptr.shape[0] - 1, maps.num_syn + maps.k,
            maps.num_syn, *rules]


def trial_syndromes(err, pauli, cat2, maps_z: TrialMaps,
                    maps_x: TrialMaps) -> dict:
    """Kernel S1 (``csrc/trial_syndromes.cu``): both frames' syndromes and
    logical effects of the draws ``err`` (B, n) bool, ``pauli`` and
    ``cat2`` (B, n) int32, as :func:`trial_syndromes_plain` returns them,
    bit for bit. CUDA tensors launch the kernel (the draws are used as
    they are when contiguous and of those types); CPU tensors run the plain
    version. With telemetry on, the kernel also counts the flipped
    elementary locations into a device int64, ``sampling.flips``.
    ``trial_syndromes.launches`` counts the launches."""
    if err.device.type == "cpu":
        return trial_syndromes_plain(err, pauli, cat2, maps_z, maps_x)
    if err.device.type != "cuda":
        raise ValueError(f"unsupported device {err.device}")
    B, n = err.shape
    err = err.to(torch.bool).contiguous()
    pauli = pauli.to(torch.int32).contiguous()
    cat2 = cat2.to(torch.int32).contiguous()
    if pauli.shape != err.shape or cat2.shape != err.shape:
        raise ValueError(f"draws of shapes {tuple(err.shape)}, "
                         f"{tuple(pauli.shape)}, {tuple(cat2.shape)}")
    frames, out = [], {}
    for basis, maps, rules in (("z", maps_z, FRAME_RULES[0]),
                               ("x", maps_x, FRAME_RULES[1])):
        if maps.loc_ptr.device != err.device:
            raise ValueError(f"maps on {maps.loc_ptr.device}, draws on "
                             f"{err.device}")
        if maps.loc_ptr.shape[0] - 1 > n:
            raise ValueError(f"maps reach gate location "
                             f"{maps.loc_ptr.shape[0] - 2}, draws have {n}")
        syn = torch.empty((B, maps.num_syn), dtype=torch.int8,
                          device=err.device)
        tru = torch.empty((B, maps.k), dtype=torch.int8, device=err.device)
        out[f"syndrome_{basis}"], out[f"true_{basis}"] = syn, tru
        frames += _frame_args(maps, syn, tru, rules)
    flips = None
    if telemetry.enabled():
        flips = torch.zeros(1, dtype=torch.int64, device=err.device)
    code = _s1_launch()(err.data_ptr(), pauli.data_ptr(), cat2.data_ptr(),
                        B, n, *frames,
                        None if flips is None else flips.data_ptr(),
                        _kernels.stream_ptr(err.device))
    _kernels.check(code, "trial_syndromes_launch")
    trial_syndromes.launches += 1
    if flips is not None:
        telemetry.count("sampling.flips", flips)
    return out


trial_syndromes.launches = 0


def trial_batch(gen: torch.Generator, error_rate, maps_z: TrialMaps,
                maps_x: TrialMaps, n_locs: int, batch: int,
                randoms: tuple = None) -> dict:
    """One batch of Monte-Carlo trials up to (but excluding) decoding.

    Returns syndrome_z (B, num_syn) and true_z (B, k) int8 from the Z-frame
    (decoded against HdecZ), and their X counterparts. Both frames derive
    from the same gate randoms, so Y errors and two-qubit Paulis stay
    correlated exactly. ``randoms=(err, pauli, cat2)`` replaces the draws
    from ``gen`` (which may then be None). S1 on a CUDA tensor, its plain
    version on a CPU one (:func:`trial_syndromes`)."""
    if randoms is None:
        randoms = sample_gate_randoms(gen, batch, n_locs, error_rate)
    return trial_syndromes(*randoms, maps_z, maps_x)
