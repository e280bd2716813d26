"""Hand-checkable [[4,2,2]] circuit-level worked example.

The port's counterpart of the JAX package's ``examples/toy_422.py``. The
reference's pedagogical notebook (toy_example.ipynb) builds a [[4,2,2]]
syndrome-extraction circuit and demonstrates syndrome sparsification with a
hand-placed error (cells 10-15). This script reproduces that material with
the port's gate-tensor representation and derives every number by hand
first, then verifies that the batched OSD (kernel K2 on the card) recovers
the injected logical error. (The notebook's own cell 15 inserts its demo
error at position 2*cycle+3 = 27 of a 24-op circuit — past the end, so its
stored output shows all-zero syndromes; the examples below place the errors
where the cell-14 narrative says they should go.)

Code (notebook cell 2):  Hx = Hz = [1 1 1 1],
  Lx = [[1,1,0,0],[1,0,1,0]],  Lz = [[0,1,0,1],[0,0,1,1]].
Circuit per cycle (cell 10, 12 ops): PrepX(X0), PrepZ(Z0),
  CNOT(X0 -> d0..d3), CNOT(d0..d3 -> Z0), MeasX(X0), MeasZ(Z0);
2 noisy cycles + 2 noiseless suffix cycles -> 4 X-measurements.

Hand-derived goldens (asserted in tests/test_torch_examples.py):
  (a) Z on data 0 between cycles 1 and 2: the X-check picks it up in every
      later cycle -> raw X-syndrome [0,1,1,1], sparsified [0,1,0,0];
      final data frame [1,0,0,0] -> true logical Lx @ e = [1,1].
  (b) Z on the X-check ancilla right before cycle 2's MeasX (a measurement
      error): flips that one readout only -> raw [0,1,0,0], sparsified
      [0,1,1,0] — distinguishable from (a) exactly as cell 14 explains.

Run: python -m qldpc_tpu_torch.examples.toy_422 [--device cpu]
(``cuda`` by default, which raises without a GPU.)
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..models.builder import channel_llrs
from ..models.circuit import (OP_CNOT, OP_MEAS_X, OP_MEAS_Z, OP_PREP_X,
                              OP_PREP_Z)
from ..models.pauli_frame import propagate_batch, unpack_batch
from ..ops.osd import osd_batch

# qubit linear order (notebook cell 11): Xcheck, Zcheck, data 0-3
X0, Z0 = 0, 1
DATA = [2, 3, 4, 5]
Hx = np.array([[1, 1, 1, 1]])
Hz = np.array([[1, 1, 1, 1]])
Lx = np.array([[1, 1, 0, 0], [1, 0, 1, 0]])
Lz = np.array([[0, 1, 0, 1], [0, 0, 1, 1]])


def build_cycle():
    """One measurement cycle as (op, q1, q2) rows — notebook cell 10."""
    ops = [(OP_PREP_X, X0, -1), (OP_PREP_Z, Z0, -1)]
    ops += [(OP_CNOT, X0, d) for d in DATA]       # control=Xcheck
    ops += [(OP_CNOT, d, Z0) for d in DATA]       # target=Zcheck
    ops += [(OP_MEAS_X, X0, -1), (OP_MEAS_Z, Z0, -1)]
    return np.array(ops, dtype=np.int32)


def full_circuit(num_cycles=2, suffix_cycles=2):
    cyc = build_cycle()
    full = np.tile(cyc, (num_cycles + suffix_cycles, 1))
    return full[:, 0], full[:, 1], full[:, 2]


def z_syndromes(inj_pos, inj_q, num_cycles=2):
    """Raw + sparsified X-check syndrome and final-frame logical for one
    frame with Z flips at (inj_pos, inj_q)."""
    ops, q1, q2 = full_circuit(num_cycles)
    n_meas = num_cycles + 2
    inj_pos = np.asarray(inj_pos, dtype=np.int64)
    order = np.argsort(inj_pos, kind="stable")
    syn_w, state_w = propagate_batch(
        ops, q1, q2, "Z", 6, n_meas, inj_pos[order],
        np.asarray(inj_q, dtype=np.int64)[order],
        np.zeros(len(inj_pos), dtype=np.int64), 1)
    raw = unpack_batch(syn_w, 1)[:, 0]
    sparse = raw.copy()
    sparse[1:] ^= raw[:-1]                        # one check -> plain diff
    data_state = unpack_batch(state_w, 1)[:, 0][DATA]
    return raw, sparse, (Lx @ data_state) % 2


def enumerate_z_faults(num_cycles=2):
    """All single Z-component fault locations of the noisy portion
    (gate-associated, notebook cell 19 minus its implicit-idle extras):
    error before MeasX, after PrepX, and the 3 Z-legs of every CNOT."""
    ops, q1, q2 = full_circuit(num_cycles)
    cyc_len = 12
    specs = []  # (label, [(pos, qubit), ...], prob_factor)
    for p in range(num_cycles * cyc_len):
        if ops[p] == OP_MEAS_X:
            specs.append((f"Z before MeasX@{p}", [(p, q1[p])], 1.0))
        elif ops[p] == OP_PREP_X:
            specs.append((f"Z after PrepX@{p}", [(p + 1, q1[p])], 1.0))
        elif ops[p] == OP_CNOT:
            c, t = int(q1[p]), int(q2[p])
            specs.append((f"Z ctrl CNOT@{p}", [(p + 1, c)], 4 / 15))
            specs.append((f"Z tgt  CNOT@{p}", [(p + 1, t)], 4 / 15))
            specs.append((f"ZZ     CNOT@{p}", [(p + 1, c), (p + 1, t)], 4 / 15))
    return specs


def decoding_matrix_z(error_rate=0.01, num_cycles=2):
    """Group fault signatures into equivalence classes -> HdecZ columns
    (notebook cells 19-21, first-occurrence class order)."""
    specs = enumerate_z_faults(num_cycles)
    cols, probs, order = {}, {}, []
    for label, flips, factor in specs:
        raw, sparse, logical = z_syndromes([p for p, _ in flips],
                                           [q for _, q in flips], num_cycles)
        sig = tuple(np.concatenate([sparse, logical]))
        if sig not in cols:
            cols[sig] = label
            order.append(sig)
            probs[sig] = 0.0
        probs[sig] += error_rate * factor
    Hfull = np.array(order, dtype=np.uint8).T        # (num_syn + k, classes)
    return Hfull, np.array([probs[s] for s in order])


def osd0_decode(HdecZ, syndrome, probs, device=None) -> dict:
    """OSD-0 of one syndrome against ``HdecZ`` with the channel LLRs of
    ``probs`` as reliabilities (the production ``osd_batch``: kernel K2 on
    a CUDA device). Returns solution (n,) uint8 and valid (bool)."""
    dev = resolve_device(device)
    llr = channel_llrs(probs)
    n = len(llr)
    out = osd_batch(
        torch.as_tensor(HdecZ, dtype=torch.uint8, device=dev),
        torch.as_tensor(HdecZ.T, dtype=torch.float32, device=dev),
        torch.as_tensor(syndrome[None].astype(np.int8), device=dev),
        torch.as_tensor(np.broadcast_to(llr, (1, n)).astype(np.float32),
                        device=dev),
        torch.zeros((1, n), dtype=torch.int8, device=dev), K=n, order=0)
    return dict(solution=out["solution"][0].cpu().numpy().astype(np.uint8),
                valid=bool(out["valid"][0]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print("=" * 70)
    print("[[4,2,2]] circuit-level worked example (reference toy_example"
          ".ipynb cells 10-15)")
    print("=" * 70)

    raw, sparse, logical = z_syndromes([12], [DATA[0]])
    print("\n(a) Z on data qubit 0 between cycles 1 and 2:")
    print(f"    raw X-syndrome        {raw}      (expected [0 1 1 1])")
    print(f"    sparsified            {sparse}      (expected [0 1 0 0])")
    print(f"    true logical Lx @ e = {logical}        (expected [1 1])")

    raw_b, sparse_b, logical_b = z_syndromes([22], [X0])
    print("\n(b) measurement error (Z on ancilla before cycle 2's MeasX):")
    print(f"    raw X-syndrome        {raw_b}      (expected [0 1 0 0])")
    print(f"    sparsified            {sparse_b}      (expected [0 1 1 0])")
    print(f"    true logical          {logical_b}        (unaffected)")

    Hfull, probs = decoding_matrix_z()
    num_syn = 4
    HdecZ = Hfull[:num_syn]
    print(f"\nZ decoding matrix: {len(probs)} fault classes from "
          f"{len(enumerate_z_faults())} single faults")
    print(HdecZ)

    # decode example (a) with the production batched OSD
    sol = osd0_decode(HdecZ, sparse, probs, device)["solution"]
    pred = (Hfull[num_syn:] @ sol) % 2
    print(f"\nOSD-0 decode of (a) on {device.type}: correction classes "
          f"{np.nonzero(sol)[0]}, predicted logical {pred} == true "
          f"{logical}: {np.array_equal(pred, logical)}")
    return np.array_equal(pred, logical)


if __name__ == "__main__":
    main()
