"""The port's ``ler_oracle`` decode at maxIter 50 against JAX's Pallas
path, on the first 32 committed [[90,8,10]] Z trials.

JAX recorded its ``ourdecode`` flags through its XLA lift, which drifts
from its Pallas path on a few trials over 50 iterations; the port keeps
the Pallas kernel's arithmetic (K1 and its plain version). So the port
equals JAX's ``_decode_one_basis`` through its Pallas kernels (interpret
mode, the shared fixture of test_torch_engine.py) per trial, errors and
converged flags, while the committed flags differ from both on some
trials. The logical basis and the XLA comparison at maxIter 20:
test_torch_ler_oracle.py.
"""
import numpy as np
import torch

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.scripts import ler_oracle

from test_torch_engine import jax_kernels_interpreted  # noqa: F401
from test_torch_ler_oracle import CODE, CYCLES, P, jax_decode, jax_matrices

torch.set_num_threads(1)


def test_mi50_port_follows_jax_pallas_path(jax_kernels_interpreted):
    trials = np.load(ler_oracle.data_path(CODE, CYCLES, P))
    n = 32
    circ, jM = jax_matrices("standard")
    jerr, jconv, _ = jax_decode(circ, jM, trials, "Z", 50, n=n,
                                use_pallas=True)
    tcode = ler_oracle.load_code(CODE)
    tcirc = qt.SyndromeCircuit(tcode, num_cycles=CYCLES)
    M = qt.build_decoding_matrices(tcirc, tcode.Lx, tcode.Lz, P)
    res = ler_oracle.decode_file(tcirc, M, trials, 50, 2, "cpu", first=n)
    assert np.array_equal(res["Z"]["err"], jerr)
    assert np.array_equal(res["Z"]["conv"], jconv)
    record = np.load(ler_oracle.record_path(CODE, CYCLES, P, 50))
    assert (record["z_err"][:n] != jerr).any()
