"""Bit-packed batched Pauli-frame propagation (host-side NumPy).

Propagates B independent error frames through the syndrome-extraction
circuit simultaneously, with frames packed 64-per-uint64-word along the
batch axis so every gate is a word-wise vector op over ~B/64 words. This
replaces the reference's one-process-per-fault enumeration
(reference src/noise/builder.py:37-67 + src/noise/simulation.py:114-210)
with a single vectorized sweep, and doubles as the oracle tier for testing
the on-device linear-map trial path.

Propagation rules (reference src/noise/kernels.py:50-89 and 131-170):
  Z-frame: CNOT XORs target into control; PrepX resets; MeasX records.
  X-frame: CNOT XORs control into target; PrepZ resets; MeasZ records.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .circuit import (OP_CNOT, OP_MEAS_X, OP_MEAS_Z, OP_PREP_X, OP_PREP_Z,
                      SyndromeCircuit)


def pack_batch(bits: np.ndarray) -> np.ndarray:
    """(rows, B) 0/1 -> (rows, ceil(B/64)) uint64, little-endian bit order."""
    b = np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little")
    pad = (-b.shape[-1]) % 8
    if pad:
        b = np.pad(b, [(0, 0)] * (b.ndim - 1) + [(0, pad)])
    return b.view(np.uint64)


def unpack_batch(words: np.ndarray, nbits: int) -> np.ndarray:
    """(rows, W) uint64 -> (rows, nbits) uint8."""
    by = words.view(np.uint8)
    bits = np.unpackbits(by, axis=-1, bitorder="little")
    return bits[..., :nbits]


def propagate_batch(
    ops: np.ndarray, q1: np.ndarray, q2: np.ndarray,
    basis: str, total_qubits: int, num_meas: int,
    inj_pos: np.ndarray, inj_q: np.ndarray, inj_bit: np.ndarray,
    nbatch: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Propagate ``nbatch`` frames; frame b receives single-qubit flips
    listed in (inj_pos, inj_q, inj_bit) — a flip of qubit ``inj_q[i]`` is
    applied to frame ``inj_bit[i]`` just *before* executing the gate at
    circuit index ``inj_pos[i]`` (i.e. the fault op is inserted at that
    position, matching reference builder.py:42). inj_pos must be sorted
    ascending. Two-qubit faults are two entries with the same (pos, bit).

    Returns (syn_words (num_meas, W), state_words (total_qubits, W)).
    """
    if basis == "Z":
        op_prep, op_meas, cnot_dst_is_q1 = OP_PREP_X, OP_MEAS_X, True
    elif basis == "X":
        op_prep, op_meas, cnot_dst_is_q1 = OP_PREP_Z, OP_MEAS_Z, False
    else:
        raise ValueError(basis)
    W = (nbatch + 63) // 64
    state = np.zeros((total_qubits, W), dtype=np.uint64)
    syn = np.zeros((num_meas, W), dtype=np.uint64)
    syn_count = 0

    inj_word = (inj_bit >> 6).astype(np.int64)
    inj_mask = (np.uint64(1) << (inj_bit.astype(np.uint64) & np.uint64(63)))
    n_inj = len(inj_pos)
    ptr = 0
    num_gates = len(ops)
    for i in range(num_gates):
        while ptr < n_inj and inj_pos[ptr] == i:
            state[inj_q[ptr], inj_word[ptr]] ^= inj_mask[ptr]
            ptr += 1
        op = ops[i]
        if op == OP_CNOT:
            if cnot_dst_is_q1:
                state[q1[i]] ^= state[q2[i]]
            else:
                state[q2[i]] ^= state[q1[i]]
        elif op == op_prep:
            state[q1[i]] = 0
        elif op == op_meas:
            syn[syn_count] = state[q1[i]]
            syn_count += 1
    # trailing injections at position == num_gates (inserted after last gate)
    while ptr < n_inj:
        state[inj_q[ptr], inj_word[ptr]] ^= inj_mask[ptr]
        ptr += 1
    assert syn_count == num_meas
    return syn, state


def sparsify_packed(syn_words: np.ndarray, positions: np.ndarray) -> np.ndarray:
    """Differential (change-detection) syndrome on packed rows.

    positions: (n_checks, meas_per_check) syndrome indices per check in time
    order. result[pos_t] = raw[pos_t] XOR raw[pos_{t-1}] (reference
    src/noise/kernels.py:356-380).
    """
    out = syn_words.copy()
    if positions.shape[1] > 1:
        out[positions[:, 1:].ravel()] ^= syn_words[positions[:, :-1].ravel()]
    return out


def logical_from_state(state_words: np.ndarray, L: np.ndarray,
                       data_qubit_indices: np.ndarray) -> np.ndarray:
    """(k, W) packed logical bits = L @ data_state mod 2, per frame."""
    data = state_words[data_qubit_indices]  # (n, W)
    k = L.shape[0]
    out = np.zeros((k, state_words.shape[1]), dtype=np.uint64)
    for i in range(k):
        sup = np.nonzero(L[i])[0]
        if sup.size:
            out[i] = np.bitwise_xor.reduce(data[sup], axis=0)
    return out


def augmented_signatures(circ: SyndromeCircuit, basis: str, L: np.ndarray,
                         inj_pos, inj_q, inj_bit, nbatch: int) -> np.ndarray:
    """Per-frame augmented signature rows: (nbatch, num_syn + k) uint8.

    Runs the full circuit (noisy base + noiseless suffix; injections index
    into the concatenated program), sparsifies the syndrome and appends the
    logical effect.
    """
    if basis == "Z":
        num_meas, positions = circ.num_syndrome_x, circ.x_syn_positions
    else:
        num_meas, positions = circ.num_syndrome_z, circ.z_syn_positions
    syn, state = propagate_batch(
        circ.full_ops, circ.full_q1, circ.full_q2, basis,
        circ.total_qubits, num_meas, inj_pos, inj_q, inj_bit, nbatch)
    sparse = sparsify_packed(syn, positions)
    logical = logical_from_state(state, L, circ.data_qubit_indices)
    words = np.concatenate([sparse, logical], axis=0)  # (R, W)
    return unpack_batch(words, nbatch).T.copy()  # (nbatch, R)
