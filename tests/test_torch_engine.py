"""The port's whole slice vs the JAX engine.

One pooled dispatch of the port (sample -> BP -> pooled OSD -> readout),
fed the gate randoms JAX draws, must give the per-shot flags of the JAX
pooled round with both Pallas kernels in interpret mode (the layered
schedule and the other eliminator generations: test_torch_engine_variants.py).
The port's run_simulation on the CPU must agree statistically with the
recorded [[72,12,6]] p=0.006 logical error rate, and stop exactly at its
target.
"""
import numpy as np
import pytest
import torch

import jax

import qldpc_tpu
from qldpc_tpu.ops import osd_pallas as jax_osd_pallas
from qldpc_tpu.ops.bp import alpha_schedule
from qldpc_tpu.ops.sampler import sample_gate_randoms as jax_randoms
from qldpc_tpu.parallel import engine as jengine

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.parallel import engine as tengine

torch.set_num_threads(1)

FLAG_KEYS = ("z_conv", "x_conv", "z_err", "x_err", "z_rankdef", "x_rankdef",
             "any_err")


def _bb_kwargs(code):
    return dict(ell=code.ell, m=code.m, a_x_powers=code.a_x_powers,
                a_y_powers=code.a_y_powers, b_y_powers=code.b_y_powers,
                b_x_powers=code.b_x_powers)


@pytest.fixture
def jax_kernels_interpreted(monkeypatch):
    """Both JAX Pallas kernels in interpret mode, as the JAX package's own
    tests run them on the CPU."""
    bp = jengine.decode_batch_lift_pallas
    elim = jax_osd_pallas.eliminate_blocks
    monkeypatch.setattr(jengine, "decode_batch_lift_pallas",
                        lambda *a, **k: bp(*a, **k, interpret=True))
    monkeypatch.setattr(jax_osd_pallas, "eliminate_blocks",
                        lambda *a, **k: elim(*a, **k, interpret=True))
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_pooled_dispatch_matches_jax(jax_kernels_interpreted):
    p, cycles, batch, rounds, maxIter, osd_order = 0.01, 3, 32, 2, 12, 2
    jcode = qldpc_tpu.get_code("[[72, 12, 6]]")
    jcirc = qldpc_tpu.SyndromeCircuit(jcode, num_cycles=cycles)
    jM = qldpc_tpu.build_decoding_matrices(jcirc, jcode.Lx, jcode.Lz, p)
    seq = alpha_schedule("dynamical", maxIter)
    jdz = jengine._make_basis(jcirc, jM, "Z", seq, osd_order=osd_order)
    jdx = jengine._make_basis(jcirc, jM, "X", seq, osd_order=osd_order)
    n_locs = jcirc.num_error_locs
    jfn = jengine.make_pooled_round_fn(jdz, jdx, n_locs, p, batch, maxIter,
                                       osd_order, rounds, use_pallas=True)
    key = jengine.make_key(3)
    want = {k: np.asarray(v) for k, v in
            jax.jit(jfn)(key, jdz, jdx).items()}
    randoms = [tuple(torch.as_tensor(np.array(x)) for x in jax_randoms(
        jax.random.fold_in(key, i), batch, n_locs, p)) for i in range(rounds)]

    code = qt.get_code("[[72, 12, 6]]")
    circ = qt.SyndromeCircuit(code, num_cycles=cycles)
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, p)
    dz = tengine._make_basis(circ, M, "Z", seq, osd_order=osd_order,
                             device="cpu")
    dx = tengine._make_basis(circ, M, "X", seq, osd_order=osd_order,
                             device="cpu")
    fn = tengine.make_pooled_round_fn(dz, dx, n_locs, p, batch, maxIter,
                                      osd_order, rounds)
    got = fn(None, randoms=randoms)
    # the port's round adds its OSD overflow flag (no reprocess slice
    # overflowed: the flags are final)
    assert set(got) == set(FLAG_KEYS) | {"osd_overflow"}
    assert not got["osd_overflow"].any()
    for k in FLAG_KEYS:
        assert got[k].shape == (rounds * batch,), k
        assert np.array_equal(got[k].numpy(), want[k]), k
    # the comparison bites: some shots fail BP, some decode wrongly
    assert not want["z_conv"].all() and want["any_err"].any()


def test_run_simulation_ler_matches_record():
    """[[72,12,6]], 6 cycles, p=0.006, dynamical, maxIter 50, OSD order 2:
    the JAX package recorded LER 100/172 = 0.581
    (validation_dynamical_mi50.json). Agree within 3 combined sigma."""
    code = qt.get_code("[[72, 12, 6]]")
    res = qt.run_simulation(code.Hx, code.Hz, code.Lx, code.Lz, 0.006,
                            num_cycles=6, maxIter=50, osd_order=2,
                            max_trials=256, batch_size=128, base_seed=7,
                            verbose=False, device="cpu", **_bb_kwargs(code))
    n = res["num_trials"]
    assert n == 256 and res["num_devices"] == 1
    p_ref, n_ref = 100 / 172, 172
    sigma = np.sqrt(p_ref * (1 - p_ref) * (1 / n_ref + 1 / n))
    assert abs(res["logical_error_rate"] - p_ref) <= 3 * sigma, (res, sigma)
    assert res["osd_rank_deficient_shots"] == 0
    assert set(res) == {
        "logical_error_rate", "z_logical_error_rate", "x_logical_error_rate",
        "num_trials", "logical_errors", "shots_per_sec", "elapsed_sec",
        "num_devices", "osd_rank_deficient_shots"}


def test_sequential_stopping_rule():
    """Stopping truncates at the exact trial where the target is reached,
    and a seed replays the run."""
    code = qt.get_code("[[72, 12, 6]]")
    kw = dict(num_cycles=3, maxIter=8, osd_order=0, target_logical_errors=5,
              max_trials=2000, batch_size=64, rounds_per_dispatch=2,
              base_seed=3, verbose=False, device="cpu", **_bb_kwargs(code))
    r1 = qt.run_simulation(code.Hx, code.Hz, code.Lx, code.Lz, 0.008, **kw)
    r2 = qt.run_simulation(code.Hx, code.Hz, code.Lx, code.Lz, 0.008, **kw)
    assert r1["logical_errors"] == 5
    assert r1["num_trials"] < 2000
    assert (r1["num_trials"], r1["logical_errors"]) == \
        (r2["num_trials"], r2["logical_errors"])


def test_crossing_take():
    a = np.array([0, 1, 0, 1, 1, 0])
    assert tengine._crossing_take(a, 2) == 4
    assert tengine._crossing_take(a, 1) == 2


def test_reference_format_precomputed_matrices():
    """A reference-style matrix dict (no sampler tables) is back-filled; a
    mismatched one is rejected."""
    code = qt.get_code("[[72, 12, 6]]")
    circ = qt.SyndromeCircuit(code, num_cycles=3)
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, 0.008)
    ref_style = {k: M[k] for k in
                 ["HdecZ", "HdecX", "channel_probsZ", "channel_probsX",
                  "HZ_full", "HX_full", "first_logical_rowZ",
                  "first_logical_rowX", "num_cycles", "k"]}
    kw = dict(num_cycles=3, maxIter=8, osd_order=0, max_trials=16,
              batch_size=8, base_seed=0, verbose=False, device="cpu",
              **_bb_kwargs(code))
    res = qt.run_simulation(code.Hx, code.Hz, code.Lx, code.Lz, 0.008,
                            precomputed_matrices=ref_style, **kw)
    assert res["num_trials"] == 16
    bad = dict(ref_style, HdecZ=np.zeros_like(M["HdecZ"]))
    with pytest.raises(ValueError, match="disagrees"):
        qt.run_simulation(code.Hx, code.Hz, code.Lx, code.Lz, 0.008,
                          precomputed_matrices=bad, **kw)
