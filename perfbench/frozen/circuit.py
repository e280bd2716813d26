"""Depth-8 syndrome-extraction circuit for BB codes as static gate tensors.

TPU-first representation: the circuit is built once, host-side, as fixed-shape
int32 arrays ``(ops, q1, q2)`` — there is no tuple-IR hot path. One
measurement cycle is constructed and tiled ``num_cycles`` times (noisy
portion) plus 2 noiseless suffix cycles.

Semantics parity with the reference circuit builder
(reference src/codes/bb_code.py:73-189): same qubit linear ordering
(Xchecks, data_left, data_right, Zchecks), same depth-optimal CNOT schedules
(schedule_X = [idle,1,4,3,5,0,2,idle], schedule_Z = [3,5,0,1,2,4,idle,idle]),
same per-round op emission order (PrepX @ t=0; X-CNOTs; Z-CNOTs; IDLEs for
un-CNOTed data qubits; MeasZ @ t=6; MeasX + PrepZ @ t=7).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .bb import BBCode

# Gate opcodes (structural gates only — errors are never materialized as ops
# in this framework; noise is sampled directly into fault-bit vectors).
OP_CNOT = 1
OP_PREP_X = 2
OP_PREP_Z = 3
OP_MEAS_X = 4
OP_MEAS_Z = 5
OP_IDLE = 6

SCHEDULE_X = ["idle", 1, 4, 3, 5, 0, 2, "idle"]
SCHEDULE_Z = [3, 5, 0, 1, 2, 4, "idle", "idle"]

# Error-location kinds (one sampled random tuple per location).
LOC_MEAS_X = 0
LOC_MEAS_Z = 1
LOC_PREP_X = 2
LOC_PREP_Z = 3
LOC_IDLE = 4
LOC_CNOT = 5


def _first_nonzero_or_zero(row: np.ndarray) -> int:
    nz = np.nonzero(row)[0]
    return int(nz[0]) if nz.size else 0


@dataclasses.dataclass
class SyndromeCircuit:
    """Static-tensor syndrome-extraction circuit for one BB code."""

    code: BBCode
    num_cycles: int

    def __post_init__(self):
        if self.num_cycles < 1:
            raise ValueError(f"num_cycles must be >= 1, got {self.num_cycles}")
        c = self.code
        self.n2 = c.n2
        self.n = c.n
        self.total_qubits = 4 * self.n2
        # Linear qubit ordering: Xcheck | data_left | data_right | Zcheck.
        self.xcheck_off = 0
        self.dl_off = self.n2
        self.dr_off = 2 * self.n2
        self.zcheck_off = 3 * self.n2
        self.data_qubit_indices = np.arange(self.dl_off, self.dl_off + self.n,
                                            dtype=np.int32)
        self._compute_neighbors()
        self._build_cycle()
        self._tile_circuit()
        self._enumerate_error_locations()

    # ------------------------------------------------------------------
    def _compute_neighbors(self):
        """nbs_x[i, d] / nbs_z[i, d]: global data-qubit index of the d-th
        neighbor of X/Z check i (directions 0-2: left block, 3-5: right).

        With polynomial components, directions come from A1-A3/B1-B3 rows;
        without, they fall back to the first three nonzeros of each Hx/Hz
        row half (reference bb_code.py:106-151 implements both paths)."""
        c = self.code
        n2 = self.n2
        self.nbs_x = np.zeros((n2, 6), dtype=np.int32)
        self.nbs_z = np.zeros((n2, 6), dtype=np.int32)
        if getattr(c, "has_component_params", True):
            A = c.A_components()
            B = c.B_components()
            for i in range(n2):
                for d in range(3):
                    self.nbs_x[i, d] = self.dl_off + _first_nonzero_or_zero(A[d][i])
                    self.nbs_x[i, 3 + d] = self.dr_off + _first_nonzero_or_zero(B[d][i])
                    self.nbs_z[i, d] = self.dl_off + _first_nonzero_or_zero(B[d].T[i])
                    self.nbs_z[i, 3 + d] = self.dr_off + _first_nonzero_or_zero(A[d].T[i])
        else:
            for i in range(n2):
                for half, off, nbs in ((c.Hx, None, self.nbs_x),
                                       (c.Hz, None, self.nbs_z)):
                    row = half[i]
                    left = np.nonzero(row[:n2])[0][:3]
                    right = np.nonzero(row[n2:])[0][:3]
                    for d, idx in enumerate(left):
                        nbs[i, d] = self.dl_off + idx
                    for d, idx in enumerate(right):
                        nbs[i, 3 + d] = self.dr_off + idx

    # ------------------------------------------------------------------
    def _build_cycle(self):
        """Emit one measurement cycle in the canonical op order."""
        n2 = self.n2
        ops: List[Tuple[int, int, int]] = []
        for t in range(8):
            cnoted = np.zeros(self.total_qubits, dtype=bool)
            if t == 0:
                for i in range(n2):
                    ops.append((OP_PREP_X, self.xcheck_off + i, -1))
            if SCHEDULE_X[t] != "idle":
                d = SCHEDULE_X[t]
                for i in range(n2):
                    tgt = int(self.nbs_x[i, d])
                    ops.append((OP_CNOT, self.xcheck_off + i, tgt))
                    cnoted[tgt] = True
            if SCHEDULE_Z[t] != "idle":
                d = SCHEDULE_Z[t]
                for i in range(n2):
                    ctl = int(self.nbs_z[i, d])
                    ops.append((OP_CNOT, ctl, self.zcheck_off + i))
                    cnoted[ctl] = True
            for q in self.data_qubit_indices:
                if not cnoted[q]:
                    ops.append((OP_IDLE, int(q), -1))
            if t == 6:
                for i in range(n2):
                    ops.append((OP_MEAS_Z, self.zcheck_off + i, -1))
            if t == 7:
                for i in range(n2):
                    ops.append((OP_MEAS_X, self.xcheck_off + i, -1))
                for i in range(n2):
                    ops.append((OP_PREP_Z, self.zcheck_off + i, -1))
        arr = np.array(ops, dtype=np.int32)
        self.cycle_ops = arr[:, 0].copy()
        self.cycle_q1 = arr[:, 1].copy()
        self.cycle_q2 = arr[:, 2].copy()
        self.cycle_len = len(ops)

    # ------------------------------------------------------------------
    def _tile_circuit(self):
        reps = self.num_cycles
        self.base_ops = np.tile(self.cycle_ops, reps)
        self.base_q1 = np.tile(self.cycle_q1, reps)
        self.base_q2 = np.tile(self.cycle_q2, reps)
        self.suffix_ops = np.tile(self.cycle_ops, 2)
        self.suffix_q1 = np.tile(self.cycle_q1, 2)
        self.suffix_q2 = np.tile(self.cycle_q2, 2)
        self.full_ops = np.concatenate([self.base_ops, self.suffix_ops])
        self.full_q1 = np.concatenate([self.base_q1, self.suffix_q1])
        self.full_q2 = np.concatenate([self.base_q2, self.suffix_q2])
        # Syndrome bookkeeping over the full circuit (base + suffix):
        # measurement index in program order, per basis.
        self.num_syndrome_x = int((self.full_ops == OP_MEAS_X).sum())
        self.num_syndrome_z = int((self.full_ops == OP_MEAS_Z).sum())
        # positions (syndrome indices) per check, CSR-like, for sparsification
        self.x_syn_positions = self._syn_positions(OP_MEAS_X, self.xcheck_off)
        self.z_syn_positions = self._syn_positions(OP_MEAS_Z, self.zcheck_off)

    def _syn_positions(self, meas_op: int, off: int) -> np.ndarray:
        """(n2, num_meas_per_check) syndrome indices for each check, in
        measurement order. For this circuit every check is measured exactly
        once per cycle, so the result is rectangular."""
        idx = [[] for _ in range(self.n2)]
        syn = 0
        for op, q in zip(self.full_ops, self.full_q1):
            if op == meas_op:
                idx[q - off].append(syn)
                syn += 1
        width = max(len(v) for v in idx)
        assert all(len(v) == width for v in idx)
        return np.array(idx, dtype=np.int32)

    # ------------------------------------------------------------------
    def _enumerate_error_locations(self):
        """Error locations of the noisy (base) circuit, in program order.

        One location per MeasX/MeasZ/PrepX/PrepZ/IDLE/CNOT gate (matching
        reference compiled.py:106-113 count semantics). Each location draws
        one uniform + one categorical random per trial.
        """
        mask = np.isin(self.base_ops, [OP_MEAS_X, OP_MEAS_Z, OP_PREP_X,
                                       OP_PREP_Z, OP_IDLE, OP_CNOT])
        self.loc_gate_pos = np.nonzero(mask)[0].astype(np.int32)
        gate_ops = self.base_ops[self.loc_gate_pos]
        kind_lut = np.full(8, -1, dtype=np.int32)
        for op, kind in ((OP_MEAS_X, LOC_MEAS_X), (OP_MEAS_Z, LOC_MEAS_Z),
                         (OP_PREP_X, LOC_PREP_X), (OP_PREP_Z, LOC_PREP_Z),
                         (OP_IDLE, LOC_IDLE), (OP_CNOT, LOC_CNOT)):
            kind_lut[op] = kind
        self.loc_kind = kind_lut[gate_ops]
        self.loc_q1 = self.base_q1[self.loc_gate_pos].copy()
        self.loc_q2 = self.base_q2[self.loc_gate_pos].copy()
        self.num_error_locs = len(self.loc_gate_pos)
