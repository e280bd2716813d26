"""Port sampler vs the JAX package and the gate-walk oracle.

torch's generator cannot replay JAX's streams, so the sampler is held three
ways: fault bits and augmented signatures bit-exact given the same
(err, pauli, cat2); the port's own draws checked distributionally; and one
trial of the port's draws equal to the explicit gate-walk oracle (the
port's copy, held against the JAX package's in test_torch_utils.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import qldpc_tpu
from qldpc_tpu.ops import sampler as jsampler

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.models.reference_sim import run_trial_oracle
from qldpc_tpu_torch.ops import sampler

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup72():
    code = qt.get_code("[[72, 12, 6]]")
    circ = qt.SyndromeCircuit(code, num_cycles=3)
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, 0.01)
    jcode = qldpc_tpu.get_code("[[72, 12, 6]]")
    jcirc = qldpc_tpu.SyndromeCircuit(jcode, num_cycles=3)
    jM = qldpc_tpu.build_decoding_matrices(jcirc, jcode.Lx, jcode.Lz, 0.01)
    return code, circ, M, jcirc, jM


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_fault_and_augmented_bits_bit_exact(setup72, basis):
    code, circ, M, jcirc, jM = setup72
    B = 48
    err, pauli, cat2 = (np.array(x) for x in jsampler.sample_gate_randoms(
        jax.random.key(5), B, circ.num_error_locs, 0.03))
    jmaps = jsampler.make_trial_maps(jcirc, jM, basis)
    jbits = np.asarray(jsampler.fault_bits(
        jnp.asarray(err), jnp.asarray(pauli), jnp.asarray(cat2), jmaps,
        basis))
    jaug = np.asarray(jsampler.augmented_bits(jnp.asarray(jbits), jmaps))
    maps = sampler.make_trial_maps(circ, M, basis, device="cpu")
    bits = sampler.fault_bits(torch.as_tensor(err), torch.as_tensor(pauli),
                              torch.as_tensor(cat2), maps, basis)
    aug = sampler.augmented_bits(bits, maps)
    assert bits.dtype == torch.bool and bits.shape == jbits.shape
    assert np.array_equal(bits.numpy(), jbits)
    assert aug.dtype == torch.int8
    assert np.array_equal(aug.numpy(), jaug)
    assert jbits.any() and jaug.any()


def test_signature_counts_exact_above_256(setup72):
    """Every location faulted at once: per-row counts exceed what bf16 can
    hold, and the float32 product must still give the exact parity."""
    code, circ, M, _, _ = setup72
    maps = sampler.make_trial_maps(circ, M, "Z", device="cpu")
    A = maps.A_loc_T.numpy().astype(np.int64)                  # (R, L)
    assert A.sum(1).max() > 256
    ones = torch.ones((A.shape[1], 2), dtype=torch.bool)
    aug = sampler.augmented_bits(ones, maps)
    assert np.array_equal(aug[0].numpy(), (A.sum(1) % 2).astype(np.int8))


def test_sample_gate_randoms_distribution():
    gen = torch.Generator().manual_seed(11)
    B, n, p = 4000, 500, 0.05
    err, pauli, cat2 = sampler.sample_gate_randoms(gen, B, n, p)
    assert err.dtype == torch.bool and err.shape == (B, n)
    assert pauli.dtype == torch.int32 and cat2.dtype == torch.int32
    N = B * n
    rate = err.float().mean().item()
    assert abs(rate - p) < 5 * np.sqrt(p * (1 - p) / N)
    for x, k in ((pauli, 3), (cat2, 15)):
        assert int(x.min()) == 0 and int(x.max()) == k - 1
        counts = torch.bincount(x.reshape(-1).long(), minlength=k).numpy()
        chi2 = ((counts - N / k) ** 2 / (N / k)).sum()
        # chi-square with k-1 dof: mean k-1, sd sqrt(2(k-1)); 6 sd margin
        assert chi2 < (k - 1) + 6 * np.sqrt(2 * (k - 1)), (k, chi2)
    # the same seed replays the same draws
    again = sampler.sample_gate_randoms(torch.Generator().manual_seed(11),
                                        B, n, p)
    assert all(torch.equal(a, b) for a, b in zip((err, pauli, cat2), again))


def test_port_trial_matches_oracle(setup72):
    code, circ, M, _, _ = setup72
    B = 24
    gen = torch.Generator().manual_seed(1234)
    err, pauli, cat2 = sampler.sample_gate_randoms(
        gen, B, circ.num_error_locs, 0.02)
    out = {}
    for basis in ("Z", "X"):
        maps = sampler.make_trial_maps(circ, M, basis, device="cpu")
        aug = sampler.augmented_bits(
            sampler.fault_bits(err, pauli, cat2, maps, basis), maps).numpy()
        out[basis] = (aug[:, :maps.num_syn], aug[:, maps.num_syn:])
    err, pauli, cat2 = err.numpy(), pauli.numpy(), cat2.numpy()
    for b in range(B):
        sz, tz, sx, tx = run_trial_oracle(circ, code.Lx, code.Lz,
                                          err[b], pauli[b], cat2[b])
        assert np.array_equal(out["Z"][0][b], sz), b
        assert np.array_equal(out["Z"][1][b], tz), b
        assert np.array_equal(out["X"][0][b], sx), b
        assert np.array_equal(out["X"][1][b], tx), b
    assert err.any(1).sum() > B // 2  # the test exercised errors
