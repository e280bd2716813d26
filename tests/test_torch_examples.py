"""The port's worked examples (qldpc_tpu_torch/examples).

toy_422 meets the hand-derived [[4,2,2]] goldens of tests/test_toy_422.py
(derived in its docstring, independent of any implementation), with the
port's OSD decoding the hand-placed error; toy_example runs to its end on
the CPU and its deterministic prints equal those of the JAX package's
examples/toy_example.py.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from qldpc_tpu_torch.examples import toy_422, toy_example
from qldpc_tpu_torch.examples.toy_422 import (DATA, X0, Lx,
                                              decoding_matrix_z,
                                              enumerate_z_faults, osd0_decode,
                                              z_syndromes)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
# lines of toy_example whose numbers come from sampled randoms
SAMPLED = ("p=1% iid", "one sampled trial", "batch of 128")


def test_data_error_syndrome_golden():
    """Z on data 0 between cycles: the X check re-detects it every cycle."""
    raw, sparse, logical = z_syndromes([12], [DATA[0]])
    assert np.array_equal(raw, [0, 1, 1, 1])
    assert np.array_equal(sparse, [0, 1, 0, 0])
    assert np.array_equal(logical, [1, 1])


def test_measurement_error_syndrome_golden():
    """Z on the ancilla right before a MeasX flips ONE readout."""
    raw, sparse, logical = z_syndromes([22], [X0])
    assert np.array_equal(raw, [0, 1, 0, 0])
    assert np.array_equal(sparse, [0, 1, 1, 0])
    assert np.array_equal(logical, [0, 0])


def test_every_data_qubit_error_logical_golden():
    """Final-cycle data errors: logical effect is Lx @ e_q exactly."""
    for q in range(4):
        _, _, logical = z_syndromes([48], [DATA[q]])
        e = np.zeros(4, dtype=int)
        e[q] = 1
        assert np.array_equal(logical, (Lx @ e) % 2), q


def test_decoding_matrix_shape_and_probs():
    Hfull, probs = decoding_matrix_z(error_rate=0.01)
    assert Hfull.shape[0] == 4 + 2  # 4 syndrome rounds + k=2 logical rows
    assert Hfull.shape[1] == len(probs) == 16
    specs = enumerate_z_faults()
    assert len(specs) == 52
    assert np.isclose(probs.sum(), 0.01 * sum(f for _, _, f in specs))


def test_decode_recovers_hand_placed_error():
    """The port's osd_batch decodes example (a)'s syndrome to a correction
    whose logical action equals the hand-derived [1, 1]."""
    _, sparse, logical = z_syndromes([12], [DATA[0]])
    Hfull, probs = decoding_matrix_z(error_rate=0.01)
    out = osd0_decode(Hfull[:4], sparse, probs, device="cpu")
    assert out["valid"]
    assert np.array_equal((Hfull[:4] @ out["solution"]) % 2, sparse)
    assert np.array_equal((Hfull[4:] @ out["solution"]) % 2, logical)


def test_toy_422_main(capsys):
    assert toy_422.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "16 fault classes from 52 single faults" in out
    assert out.strip().endswith("True")


def test_toy_example_prints_equal_jax(capsys):
    """Every print that does not depend on sampled randoms equals the JAX
    example's; the port's sampled trial equals the gate-walk oracle."""
    assert toy_example.main(["--device", "cpu"])
    port = capsys.readouterr().out.splitlines()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    jax_out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "toy_example.py")],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert jax_out.returncode == 0, jax_out.stderr
    ref = jax_out.stdout.splitlines()
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        if a.startswith(SAMPLED):
            assert a.split(":")[0] == b.split(":")[0]
        else:
            assert a == b
    assert "X_4 -> syndrome [1 0 1]" in "\n".join(port)
    trial = next(line for line in port if line.startswith(SAMPLED[1]))
    assert trial.endswith("oracle: True")
