"""Port sampler vs the JAX package and the gate-walk oracle.

torch's generator cannot replay JAX's streams, so the sampler is held three
ways: fault bits and augmented signatures bit-exact given the same
(err, pauli, cat2); the port's own draws checked distributionally; and one
trial of the port's draws equal to the explicit gate-walk oracle (the
port's copy, held against the JAX package's in test_torch_utils.py).
"""
import dataclasses

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


def _expanded(M, basis):
    """The builder's (R, L) signature matrix, one class column a location."""
    full = M["HZ_full"] if basis == "Z" else M["HX_full"]
    return full[:, M[f"{basis.lower()}_loc_class"]]


def test_signature_counts_exact_above_256(setup72):
    """Every location faulted at once: per-row counts exceed what bf16 can
    hold, and the float32 product must still give the exact parity."""
    code, circ, M, _, _ = setup72
    maps = sampler.make_trial_maps(circ, M, "Z", device="cpu")
    A = _expanded(M, "Z").astype(np.int64)                     # (R, L)
    assert A.sum(1).max() > 256
    ones = torch.ones((A.shape[1], 2), dtype=torch.bool)
    aug = sampler.augmented_bits(ones, maps)
    assert np.array_equal(aug[0].numpy(), (A.sum(1) % 2).astype(np.int8))


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_signature_held_once_as_csr(setup72, basis):
    """The tables make_trial_maps builds from the class matrix equal the
    CSR of the expanded (R, L) matrix, found by np.nonzero and by
    trial_maps_from_arrays; and the maps hold no dense copy of it."""
    code, circ, M, _, _ = setup72
    maps = sampler.make_trial_maps(circ, M, basis, device="cpu")
    A = _expanded(M, basis)
    R, L = A.shape
    assert (R, L) == (maps.num_syn + maps.k, maps.num_locations)
    loc, row = np.nonzero(A.T)
    ptr = np.searchsorted(loc, np.arange(L + 1))
    assert np.array_equal(maps.sig_ptr.numpy(), ptr)
    assert np.array_equal(maps.sig_row.numpy(), row)
    dense = sampler.trial_maps_from_arrays(maps.sel.numpy(),
                                           maps.gate_loc.numpy(), A.T,
                                           maps.num_syn, maps.k, "cpu")
    for f in dataclasses.fields(sampler.TrialMaps):
        a, b = getattr(maps, f.name), getattr(dense, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    held = sum(t.numel() * t.element_size() for t in vars(maps).values()
               if isinstance(t, torch.Tensor))
    assert held < R * L * 4 / 10, (held, R * L * 4)


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


# S1's tables and algorithm (csrc/trial_syndromes.cu runs only on a card)
def _decode_tables(maps):
    """(sel, gate_loc, A) rebuilt with NumPy from S1's tables, A the (R, L)
    signature matrix, and each elementary location's count of entries."""
    ptr, entry = maps.loc_ptr.numpy(), maps.loc_entry.numpy()
    L = maps.num_locations
    sel = np.full(L, -1, np.int64)
    gate_loc = np.full(L, -1, np.int64)
    seen = np.zeros(L, np.int64)
    for g in range(len(ptr) - 1):
        for e in entry[ptr[g]:ptr[g + 1]]:
            loc = e >> 2
            sel[loc], gate_loc[loc] = e & 3, g
            seen[loc] += 1
    sptr, rows = maps.sig_ptr.numpy(), maps.sig_row.numpy()
    A = np.zeros((maps.num_syn + maps.k, L), np.int64)
    for loc in range(L):
        A[rows[sptr[loc]:sptr[loc + 1]], loc] = 1
    return sel, gate_loc, A, seen


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_s1_tables_decode_to_the_plain_maps(setup72, basis):
    code, circ, M, _, _ = setup72
    maps = sampler.make_trial_maps(circ, M, basis, device="cpu")
    sel, gate_loc, A, seen = _decode_tables(maps)
    assert (seen == 1).all()                   # every location once
    assert np.array_equal(sel, maps.sel.numpy())
    assert np.array_equal(gate_loc, maps.gate_loc.numpy())
    assert np.array_equal(A, _expanded(M, basis))
    assert len(maps.loc_ptr) - 1 == gate_loc.max() + 1 \
        <= circ.num_error_locs
    for t in (maps.loc_ptr, maps.loc_entry, maps.sig_ptr, maps.sig_row):
        assert t.dtype == torch.int32 and t.is_contiguous()


def _s1_emulated(err, pauli, cat2, maps_z, maps_x):
    """S1's algorithm in NumPy: each erring gate location's entries in a
    frame, the frame's rule from FRAME_RULES, and the parity of the flipped
    locations' signature rows from the CSR tables. Returns the four
    outputs and the flipped locations."""
    out, flips = {}, 0
    for basis, maps, (idle_keep, ctrl, tgt) in zip(
            "zx", (maps_z, maps_x), sampler.FRAME_RULES):
        ptr, entry = maps.loc_ptr.numpy(), maps.loc_entry.numpy()
        gate = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
        sel, loc = entry & 3, entry >> 2
        p, c = pauli[:, gate], cat2[:, gate]
        hit = np.where(sel == sampler.SEL_CONST, True, np.where(
            sel == sampler.SEL_IDLE, p != idle_keep, (np.where(
                sel == sampler.SEL_CTRL, ctrl, tgt) >> c) & 1 == 1))
        flipped = np.zeros((err.shape[0], maps.num_locations), bool)
        flipped[:, loc] = err[:, gate] & hit
        flips += int(flipped.sum())
        sptr, rows = maps.sig_ptr.numpy(), maps.sig_row.numpy()
        owner = np.repeat(np.arange(maps.num_locations), np.diff(sptr))
        R = maps.num_syn + maps.k
        aug = np.stack([np.bincount(rows[f[owner]], minlength=R) & 1
                        for f in flipped]).astype(np.int8)
        out[f"syndrome_{basis}"] = aug[:, :maps.num_syn]
        out[f"true_{basis}"] = aug[:, maps.num_syn:]
    return out, flips


@pytest.mark.parametrize("p", [0.0, 0.004, 0.05, 1.0])
def test_s1_algorithm_matches_plain(setup72, p):
    """At p = 1 every gate location errs: every row's count is far above
    1, so the XOR is held against the count's parity."""
    code, circ, M, _, _ = setup72
    maps = [sampler.make_trial_maps(circ, M, b, device="cpu") for b in "ZX"]
    gen = torch.Generator().manual_seed(77)
    err, pauli, cat2 = sampler.sample_gate_randoms(
        gen, 37, circ.num_error_locs, p)
    if p == 1.0:
        err = torch.ones_like(err)
    want = sampler.trial_syndromes_plain(err, pauli, cat2, *maps)
    got, flips = _s1_emulated(err.numpy(), pauli.numpy(), cat2.numpy(),
                              *maps)
    for k, v in want.items():
        assert np.array_equal(got[k], v.numpy()), k
    assert flips == sum(int(sampler.fault_bits(err, pauli, cat2, m, b).sum())
                        for m, b in zip(maps, "ZX"))
    assert (flips > 0) == (p > 0)


def test_sampling_flips_counted_on_the_cpu(setup72):
    """``sampling.flips``: the flipped elementary locations of both frames,
    on the innermost span, only while telemetry is on."""
    from qldpc_tpu_torch.utils import telemetry
    code, circ, M, _, _ = setup72
    maps = [sampler.make_trial_maps(circ, M, b, device="cpu") for b in "ZX"]
    randoms = sampler.sample_gate_randoms(torch.Generator().manual_seed(3),
                                          40, circ.num_error_locs, 0.02)
    want = sum(int(sampler.fault_bits(*randoms, m, b).sum())
               for m, b in zip(maps, "ZX"))
    telemetry.reset()
    telemetry.enable()
    try:
        with telemetry.span("sampling"):
            on = sampler.trial_batch(None, 0.02, *maps,
                                     circ.num_error_locs, 40, randoms)
    finally:
        telemetry.disable()
    spans = telemetry.export()["spans"]
    telemetry.reset()
    assert [s["counters"] for s in spans] == [{"sampling.flips": want}]
    off = sampler.trial_batch(None, 0.02, *maps, circ.num_error_locs, 40,
                              randoms)
    assert telemetry.export()["spans"] == []
    for k, v in off.items():
        assert torch.equal(on[k], v), k
    assert want > 0
