"""Decoding-matrix builder: fault enumeration -> spatio-temporal Tanner graph.

For every elementary single-fault location in the noisy circuit, compute its
*augmented signature* (sparsified syndrome ++ logical effect), group identical
signatures into fault equivalence classes, and emit one decoding-matrix
column per class with the summed class probability.

Semantics parity with reference src/noise/builder.py:69-176 (same fault
enumeration order, probability factors p / 2p/3 / 4p/15, first-occurrence
class ordering) — but executed as ONE vectorized bit-packed propagation sweep
(see pauli_frame.py) instead of a multiprocessing pool, and extended with the
sampler metadata needed by the TPU linear-map trial path:
each *sampled* elementary location (excluding the ZZ/XX composites, whose
signature is the XOR of the two single-leg columns) is annotated with its
gate-location index, role, and fault-class index.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .circuit import (LOC_CNOT, LOC_IDLE, LOC_MEAS_X, LOC_MEAS_Z, LOC_PREP_X,
                      LOC_PREP_Z, OP_CNOT, OP_IDLE, OP_MEAS_X, OP_MEAS_Z,
                      OP_PREP_X, OP_PREP_Z, SyndromeCircuit)
from .pauli_frame import augmented_signatures

ROLE_SINGLE = 0   # Z/X on a single qubit (meas/prep/idle locations)
ROLE_CTRL = 1     # Z/X on the CNOT control leg
ROLE_TGT = 2      # Z/X on the CNOT target leg
ROLE_BOTH = 3     # ZZ/XX composite (not sampled directly)


def _enumerate_specs(circ: SyndromeCircuit, basis: str):
    """Fault specs for one basis, in reference enumeration order.

    Returns dict of aligned arrays: insertion position, qubit(s), probability
    factor (relative to the physical error rate), role, gate-location index.
    """
    if basis == "Z":
        op_meas, op_prep = OP_MEAS_X, OP_PREP_X
    else:
        op_meas, op_prep = OP_MEAS_Z, OP_PREP_Z

    # map gate position -> error-location index
    pos_to_loc = np.full(len(circ.base_ops), -1, dtype=np.int64)
    pos_to_loc[circ.loc_gate_pos] = np.arange(circ.num_error_locs)

    pos, qa, qb, factor, role, loc = [], [], [], [], [], []
    ops, g1, g2 = circ.base_ops, circ.base_q1, circ.base_q2
    for p_i in range(len(ops)):
        op = ops[p_i]
        if op == op_meas:      # error inserted BEFORE the measurement
            pos.append(p_i); qa.append(g1[p_i]); qb.append(-1)
            factor.append(1.0); role.append(ROLE_SINGLE); loc.append(pos_to_loc[p_i])
        elif op == op_prep:    # error AFTER the preparation
            pos.append(p_i + 1); qa.append(g1[p_i]); qb.append(-1)
            factor.append(1.0); role.append(ROLE_SINGLE); loc.append(pos_to_loc[p_i])
        elif op == OP_IDLE:
            pos.append(p_i + 1); qa.append(g1[p_i]); qb.append(-1)
            factor.append(2.0 / 3.0); role.append(ROLE_SINGLE); loc.append(pos_to_loc[p_i])
        elif op == OP_CNOT:
            for r, (a, b) in ((ROLE_CTRL, (g1[p_i], -1)),
                              (ROLE_TGT, (g2[p_i], -1)),
                              (ROLE_BOTH, (g1[p_i], g2[p_i]))):
                pos.append(p_i + 1); qa.append(a); qb.append(b)
                factor.append(4.0 / 15.0); role.append(r); loc.append(pos_to_loc[p_i])
    return dict(
        pos=np.array(pos, dtype=np.int64), qa=np.array(qa, dtype=np.int64),
        qb=np.array(qb, dtype=np.int64), factor=np.array(factor),
        role=np.array(role, dtype=np.int32), loc=np.array(loc, dtype=np.int64),
    )


def _signatures_for_specs(circ: SyndromeCircuit, basis: str, L: np.ndarray,
                          specs) -> np.ndarray:
    """(num_specs, num_syn + k) uint8 signature rows, one per spec."""
    nspec = len(specs["pos"])
    # injections: one per spec leg; ROLE_BOTH contributes two legs
    two = specs["qb"] >= 0
    inj_pos = np.concatenate([specs["pos"], specs["pos"][two]])
    inj_q = np.concatenate([specs["qa"], specs["qb"][two]])
    inj_bit = np.concatenate([np.arange(nspec), np.nonzero(two)[0]])
    order = np.argsort(inj_pos, kind="stable")
    return augmented_signatures(circ, basis, L, inj_pos[order], inj_q[order],
                                inj_bit[order], nspec)


def _group_classes(signatures: np.ndarray):
    """Group identical signature rows; classes ordered by first occurrence
    (matching reference dict-insertion order, builder.py:115-124)."""
    packed = np.packbits(signatures, axis=1)
    view = np.ascontiguousarray(packed).view(
        np.dtype((np.void, packed.shape[1])))[:, 0]
    _, first_idx, inverse = np.unique(view, return_index=True,
                                      return_inverse=True)
    order = np.argsort(first_idx, kind="stable")  # first-occurrence order
    remap = np.empty_like(order)
    remap[order] = np.arange(len(order))
    class_of_spec = remap[inverse]
    class_rep = first_idx[order]  # spec index whose signature represents class
    return class_of_spec, class_rep


def build_decoding_matrices(
    circ: SyndromeCircuit,
    Lx: np.ndarray,
    Lz: np.ndarray,
    error_rate: float,
    verbose: bool = False,
) -> Dict:
    """Build Z- and X-decoding matrices + sampler metadata.

    Returns a dict with the reference's keys (HdecZ, HdecX, channel_probsZ/X,
    HZ_full, HX_full, first_logical_rowZ/X, num_cycles, k — reference
    builder.py:165-176) plus, per basis, the elementary-location sampler
    tables ``{z,x}_loc_gate_loc / _loc_role / _loc_class``.
    """
    k = Lx.shape[0]
    num_syn = circ.n2 * (circ.num_cycles + 2)
    out: Dict = {
        "first_logical_rowZ": num_syn, "first_logical_rowX": num_syn,
        "num_cycles": circ.num_cycles, "k": k,
    }
    for basis, L, Hkey, Fkey, Pkey, meta in (
            ("Z", Lx, "HdecZ", "HZ_full", "channel_probsZ", "z"),
            ("X", Lz, "HdecX", "HX_full", "channel_probsX", "x")):
        if verbose:
            print(f"Building {basis}-error decoding matrix...")
        specs = _enumerate_specs(circ, basis)
        sigs = _signatures_for_specs(circ, basis, np.asarray(L) % 2, specs)
        class_of_spec, class_rep = _group_classes(sigs)
        n_classes = len(class_rep)
        full = sigs[class_rep].T.astype(np.int64)  # (num_syn + k, n_classes)
        probs = np.zeros(n_classes)
        np.add.at(probs, class_of_spec, error_rate * specs["factor"])
        out[Fkey] = full
        out[Hkey] = full[:num_syn].copy()
        out[Pkey] = probs
        # sampler metadata: elementary (sampled) locations only
        sampled = specs["role"] != ROLE_BOTH
        out[f"{meta}_loc_gate_loc"] = specs["loc"][sampled].astype(np.int32)
        out[f"{meta}_loc_role"] = specs["role"][sampled].astype(np.int32)
        out[f"{meta}_loc_class"] = class_of_spec[sampled].astype(np.int32)
    return out


def channel_llrs(channel_probs: np.ndarray, clip: float = 50.0) -> np.ndarray:
    """LLRs log((1-p)/p), NaN-sanitized and clipped to +-clip.

    Class probabilities can exceed 1/2 (many merged locations), producing
    negative or even NaN raw values — handled exactly as the reference does
    (engine.py:210-212: nan_to_num then clip).
    """
    with np.errstate(divide="ignore", invalid="ignore"):
        llr = np.log((1.0 - channel_probs) / channel_probs)
    return np.clip(np.nan_to_num(llr), -clip, clip)
