"""Oracle tier: slow, explicit single-trial noisy-circuit simulation.

Dual implementation used only in tests (SURVEY.md §4: pure-python twins as
mutual oracles). Given explicit per-gate-location error choices, it inserts
actual Pauli error ops into the op stream and walks the circuit gate by
gate — structurally independent of the production linear-map path
(ops/sampler.py), so agreement validates both the fault-bit decomposition
tables and the precomputed signature matrices.

Error insertion semantics (reference src/noise/kernels.py:176-353):
error BEFORE measurements, AFTER preparations/IDLE/CNOT; IDLE draws X/Y/Z;
CNOT draws one of the 15 two-qubit Paulis. Propagation rules
(reference src/noise/kernels.py:50-89, 131-170): in the Z frame, Y counts
as Z, ZX/YX flip the control, XZ/XY flip the target, ZZ/YY/YZ/ZY flip both;
mirror for the X frame.
"""
from __future__ import annotations

import numpy as np

from .circuit import (LOC_CNOT, LOC_IDLE, LOC_MEAS_X, LOC_MEAS_Z, LOC_PREP_X,
                      LOC_PREP_Z, OP_CNOT, OP_MEAS_X, OP_MEAS_Z, OP_PREP_X,
                      OP_PREP_Z, SyndromeCircuit)

# error "ops" appended to the gate stream: (name, q1, q2)
_SINGLE = ["X", "Y", "Z"]
_TWOQ = [("X", "c"), ("Y", "c"), ("Z", "c"),
         ("X", "t"), ("Y", "t"), ("Z", "t"),
         ("XX", "b"), ("YY", "b"), ("ZZ", "b"),
         ("XY", "b"), ("YX", "b"), ("YZ", "b"), ("ZY", "b"),
         ("XZ", "b"), ("ZX", "b")]


def build_noisy_stream(circ: SyndromeCircuit, err, pauli, cat2):
    """Interleave error ops into the base circuit per explicit choices.

    err/pauli/cat2: (n_locs,) arrays — error indicator, IDLE Pauli choice,
    CNOT two-qubit Pauli category. Returns list of ('gate'|'err', ...) items
    covering base + noiseless suffix.
    """
    stream = []
    loc_at_pos = {int(p): i for i, p in enumerate(circ.loc_gate_pos)}
    for pos in range(len(circ.base_ops)):
        op, a, b = (int(circ.base_ops[pos]), int(circ.base_q1[pos]),
                    int(circ.base_q2[pos]))
        li = loc_at_pos.get(pos)
        has_err = li is not None and bool(err[li])
        kind = int(circ.loc_kind[li]) if li is not None else -1
        if has_err and kind in (LOC_MEAS_X, LOC_MEAS_Z):
            name = "Z" if kind == LOC_MEAS_X else "X"
            stream.append(("err", name, a, -1))
        stream.append(("gate", op, a, b))
        if has_err and kind in (LOC_PREP_X, LOC_PREP_Z):
            name = "Z" if kind == LOC_PREP_X else "X"
            stream.append(("err", name, a, -1))
        elif has_err and kind == LOC_IDLE:
            stream.append(("err", _SINGLE[int(pauli[li])], a, -1))
        elif has_err and kind == LOC_CNOT:
            name, where = _TWOQ[int(cat2[li])]
            if where == "c":
                stream.append(("err", name, a, -1))
            elif where == "t":
                stream.append(("err", name, b, -1))
            else:
                stream.append(("err", name, a, b))
    for pos in range(len(circ.suffix_ops)):
        stream.append(("gate", int(circ.suffix_ops[pos]),
                       int(circ.suffix_q1[pos]), int(circ.suffix_q2[pos])))
    return stream


def _propagate(stream, basis: str, total_qubits: int):
    if basis == "Z":
        op_prep, op_meas = OP_PREP_X, OP_MEAS_X
        flips_one = {"Z", "Y"}
        flips_q1 = {"ZX", "YX"}     # component on control
        flips_q2 = {"XZ", "XY"}     # component on target
        flips_both = {"ZZ", "YY", "YZ", "ZY"}
    else:
        op_prep, op_meas = OP_PREP_Z, OP_MEAS_Z
        flips_one = {"X", "Y"}
        flips_q1 = {"XZ", "YZ"}
        flips_q2 = {"ZX", "ZY"}
        flips_both = {"XX", "YY", "XY", "YX"}
    state = np.zeros(total_qubits, dtype=np.uint8)
    syn = []
    for item in stream:
        if item[0] == "gate":
            _, op, a, b = item
            if op == OP_CNOT:
                if basis == "Z":
                    state[a] ^= state[b]
                else:
                    state[b] ^= state[a]
            elif op == op_prep:
                state[a] = 0
            elif op == op_meas:
                syn.append(state[a])
        else:
            _, name, a, b = item
            if name in flips_one:
                state[a] ^= 1
            elif name in flips_q1:
                state[a] ^= 1
            elif name in flips_q2:
                state[b] ^= 1
            elif name in flips_both:
                state[a] ^= 1
                state[b] ^= 1
    return np.array(syn, dtype=np.uint8), state


def run_trial_oracle(circ: SyndromeCircuit, Lx, Lz, err, pauli, cat2):
    """Full single-trial oracle. Returns (sparse_z, true_z, sparse_x, true_x)
    matching the production path's outputs for identical random choices."""
    stream = build_noisy_stream(circ, err, pauli, cat2)
    out = []
    for basis, L, positions in (("Z", Lx, circ.x_syn_positions),
                                ("X", Lz, circ.z_syn_positions)):
        syn, state = _propagate(stream, basis, circ.total_qubits)
        sparse = syn.copy()
        for c in range(positions.shape[0]):
            for i in range(1, positions.shape[1]):
                sparse[positions[c, i]] ^= syn[positions[c, i - 1]]
        data = state[circ.data_qubit_indices]
        true = (np.asarray(L) @ data) % 2
        out += [sparse, true.astype(np.uint8)]
    return tuple(out)
