"""Pedagogical walkthrough of the full decoding pipeline.

The port's counterpart of the JAX package's ``examples/toy_example.py``.
The reference ships this material as a notebook (toy_example.ipynb: a
hand-checkable [[4,2,2]] pipeline). This runnable script covers the same
ground with the port's primitives, in two parts:

Part 1 — code capacity on the [[7,1,3]] Steane code: stabilizers, logical
operators, syndromes of hand-placed errors, batched BP decoding.

Part 2 — the circuit-level pipeline on the smallest BB code [[72,12,6]]:
syndrome-extraction circuit structure, fault enumeration and equivalence
classes, channel LLRs, the linearity identity behind the one-matmul trial
path, and an end-to-end decoded batch.

Run:  python -m qldpc_tpu_torch.examples.toy_example [--device cpu]
(``cuda`` by default, which raises without a GPU.)
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import (SyndromeCircuit, build_decoding_matrices, channel_llrs,
                get_code, resolve_device)
from ..models.circuit import OP_CNOT, OP_IDLE
from ..models.reference_sim import run_trial_oracle
from ..ops import sampler
from ..ops.bp import TannerGraph, alpha_schedule, decode_batch
from ..parallel.code_capacity import run_code_capacity, steane_code


def part1_code_capacity(device):
    print("=" * 70)
    print("Part 1 — code capacity: the [[7,1,3]] Steane code")
    print("=" * 70)
    Hx, Hz, Lx, Lz = steane_code()
    print("Z-stabilizer checks Hz (rows):\n", Hz)
    print("X logical operator Lx:", Lx[0])
    print("CSS conditions: Hx Hz^T = 0 ->", not ((Hx @ Hz.T) % 2).any(),
          "; Lx anti-commutes with Lz ->",
          bool(((Lx @ Lz.T) % 2)[0, 0]))

    # a hand-placed X error on qubit 4 flips exactly the Hz rows containing
    # qubit 4 — the syndrome read off by the decoder
    e = np.zeros(7, dtype=np.uint8)
    e[4] = 1
    print("error X_4 -> syndrome", (Hz @ e) % 2, "(binary code of position 5)")

    res = run_code_capacity(Hz, error_rate=0.01, num_shots=2000, L=Lx,
                            maxIter=30, osd_order=1, batch_size=500,
                            device=device)
    print(f"p=1% iid X noise, 2000 shots: logical error rate "
          f"{res['logical_error_rate']:.2e} (single errors all corrected; "
          f"failures are weight-2, ~21 p^2)")


def part2_circuit_level(device):
    print()
    print("=" * 70)
    print("Part 2 — circuit level: the [[72,12,6]] bivariate bicycle code")
    print("=" * 70)
    code = get_code("[[72, 12, 6]]")
    print(f"n={code.n} data qubits (two 36-qubit blocks), k={code.k} "
          f"logical qubits, built from polynomials A = x^3 + y + y^2, "
          f"B = y^3 + x + x^2")

    circ = SyndromeCircuit(code, num_cycles=3)
    print(f"one measurement cycle: depth 8, {circ.cycle_len} ops "
          f"({int((circ.cycle_ops == OP_CNOT).sum())} CNOT, "
          f"{int((circ.cycle_ops == OP_IDLE).sum())} idle, 4x36 prep/meas); "
          f"{circ.num_error_locs} error locations over 3 noisy cycles")

    M = build_decoding_matrices(circ, code.Lx, code.Lz, 0.01)
    print(f"fault enumeration: every single fault's (sparsified syndrome ++ "
          f"logical effect) signature, grouped into equivalence classes -> "
          f"HdecZ {M['HdecZ'].shape} (one column per class)")
    llr = channel_llrs(M["channel_probsZ"])
    print(f"class probabilities sum member fault rates (p, 2p/3, 4p/15); "
          f"channel LLRs range [{llr.min():.2f}, {llr.max():.2f}]")

    # the linearity identity: a multi-fault trial's syndrome is the XOR of
    # its single-fault signatures — verified against a gate-walk simulation
    maps_z = sampler.make_trial_maps(circ, M, "Z", device=device)
    maps_x = sampler.make_trial_maps(circ, M, "X", device=device)
    gen = torch.Generator(device=device).manual_seed(7)
    err, pauli, cat2 = sampler.sample_gate_randoms(
        gen, 1, circ.num_error_locs, 0.02)
    bits = sampler.fault_bits(err, pauli, cat2, maps_z, "Z")
    aug = sampler.augmented_bits(bits, maps_z)[0].cpu().numpy()
    err, pauli, cat2 = (x.cpu().numpy() for x in (err, pauli, cat2))
    sz, tz, *_ = run_trial_oracle(circ, code.Lx, code.Lz, err[0], pauli[0],
                                  cat2[0])
    same = (np.array_equal(aug[:maps_z.num_syn], sz)
            and np.array_equal(aug[maps_z.num_syn:], tz))
    print(f"one sampled trial: {int(err[0].sum())} gate faults -> "
          f"syndrome weight {int(sz.sum())}; matmul path == gate-walk "
          f"oracle: {same}")

    # end-to-end decoded batch
    out = sampler.trial_batch(gen, 0.01, maps_z, maps_x,
                              circ.num_error_locs, batch=128)
    graph = TannerGraph.from_dense(M["HdecZ"], device=device)
    dec = decode_batch(graph, out["syndrome_z"],
                       torch.as_tensor(llr, dtype=torch.float32,
                                       device=device),
                       torch.as_tensor(alpha_schedule("dynamical", 20),
                                       device=device), 20)
    conv = dec["converged"].cpu().numpy()
    Hlog = M["HZ_full"][M["first_logical_rowZ"]:]
    err_flags = ((dec["hard"].cpu().numpy().astype(np.int64) @ Hlog.T) % 2
                 != out["true_z"].cpu().numpy()).any(1)
    print(f"batch of 128 trials at p=1%: BP converged {conv.mean():.0%}, "
          f"Z-logical errors among converged "
          f"{err_flags[conv].mean():.2%} (OSD handles the rest — see "
          f"qldpc_tpu_torch.parallel.engine for the full pipeline)")
    return same


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    part1_code_capacity(device)
    return part2_circuit_level(device)


if __name__ == "__main__":
    main()
