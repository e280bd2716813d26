"""The port's pooled dispatch vs the JAX engine off the dynamical main path.

One pooled dispatch of the port, fed the gate randoms JAX draws, must give
the per-shot flags of the JAX pooled round (the harness of
tests/test_torch_engine.py) with damping 0.9 (both packages' damped lifted
decoders), with ``bp_variant="tanh"`` and for a raw CSS code with no lift
(both packages' padded-CSR decoders); with a calibrated alpha sequence in
tests/test_torch_engine_calibrated.py. These JAX rounds run its XLA
eliminator (``use_pallas=False``), which the JAX package's own tests hold
equal to the Pallas one. The layered schedule with damping, or on a graph
with no lift, warns and runs flooding, as in the JAX package.
"""
import logging

import numpy as np
import pytest
import torch

import jax

import qldpc_tpu
from qldpc_tpu.models.bb import make_code as jax_make_code
from qldpc_tpu.ops.sampler import sample_gate_randoms as jax_randoms
from qldpc_tpu.parallel import engine as jengine

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.models.bb import make_code
from qldpc_tpu_torch.ops.bp import alpha_schedule
from qldpc_tpu_torch.ops.sampler import sample_gate_randoms
from qldpc_tpu_torch.parallel import engine as tengine

torch.set_num_threads(1)

FLAG_KEYS = ("z_conv", "x_conv", "z_err", "x_err", "z_rankdef", "x_rankdef",
             "any_err")
P, CYCLES, BATCH, ROUNDS, MAXITER, OSD_ORDER = 0.01, 3, 32, 2, 12, 2


def _bb_kwargs(code):
    return dict(ell=code.ell, m=code.m, a_x_powers=code.a_x_powers,
                a_y_powers=code.a_y_powers, b_y_powers=code.b_y_powers,
                b_x_powers=code.b_x_powers)


def _setup(lifted: bool):
    """Both packages' circuits and matrices for [[72,12,6]], as a BB code
    (lifted) or as the raw CSS code of its matrices (no lift)."""
    jc, tc = qldpc_tpu.get_code("[[72, 12, 6]]"), qt.get_code("[[72, 12, 6]]")
    if not lifted:
        jc = jax_make_code(jc.Hx, jc.Hz, jc.Lx, jc.Lz)
        tc = make_code(tc.Hx, tc.Hz, tc.Lx, tc.Lz)
    jcirc = qldpc_tpu.SyndromeCircuit(jc, num_cycles=CYCLES)
    tcirc = qt.SyndromeCircuit(tc, num_cycles=CYCLES)
    jM = qldpc_tpu.build_decoding_matrices(jcirc, jc.Lx, jc.Lz, P)
    tM = qt.build_decoding_matrices(tcirc, tc.Lx, tc.Lz, P)
    return jcirc, jM, tcirc, tM


@pytest.fixture(scope="module")
def setups():
    return {True: _setup(True), False: _setup(False)}


def _flags(setups, lifted, seqs, *, damping=1.0, bp_variant="minsum",
           use_pallas=False):
    """(JAX flags, port flags, port bundles) of one pooled dispatch on the
    randoms JAX key 3 draws. ``seqs``: the (z, x) alpha sequences."""
    jcirc, jM, tcirc, tM = setups[lifted]
    jdecs = [jengine._make_basis(jcirc, jM, b, s, osd_order=OSD_ORDER)
             for b, s in zip("ZX", seqs)]
    tdecs = [tengine._make_basis(tcirc, tM, b, s, osd_order=OSD_ORDER,
                                 device="cpu") for b, s in zip("ZX", seqs)]
    assert (jdecs[0].lifted is None) == (tdecs[0].lifted is None) == \
        (not lifted)
    n_locs = jcirc.num_error_locs
    key = jengine.make_key(3)
    jfn = jengine.make_pooled_round_fn(
        *jdecs, n_locs, P, BATCH, MAXITER, OSD_ORDER, ROUNDS, damping,
        use_pallas=use_pallas, bp_variant=bp_variant)
    want = {k: np.asarray(v)
            for k, v in jax.jit(jfn)(key, *jdecs).items()}
    randoms = [tuple(torch.as_tensor(np.array(x)) for x in jax_randoms(
        jax.random.fold_in(key, i), BATCH, n_locs, P))
        for i in range(ROUNDS)]
    fn = tengine.make_pooled_round_fn(*tdecs, n_locs, P, BATCH, MAXITER,
                                      OSD_ORDER, ROUNDS, damping,
                                      bp_variant=bp_variant)
    got = fn(None, randoms=randoms)
    return want, got, tdecs


def _assert_flags_equal(want, got):
    # the port's round adds its OSD overflow flag; no slice overflowed
    assert set(got) == set(FLAG_KEYS) | {"osd_overflow"}
    assert not got["osd_overflow"].any()
    for k in FLAG_KEYS:
        assert got[k].shape == (ROUNDS * BATCH,), k
        assert np.array_equal(got[k].numpy(), want[k]), k
    # the comparison bites: some shots fail BP, some decode wrongly
    assert not want["z_conv"].all() and want["any_err"].any()


def test_damping(setups):
    seq = alpha_schedule("dynamical", MAXITER)
    want, got, _ = _flags(setups, True, (seq, seq), damping=0.9)
    _assert_flags_equal(want, got)


def test_tanh(setups):
    seq = alpha_schedule("dynamical", MAXITER)
    want, got, _ = _flags(setups, True, (seq, seq), bp_variant="tanh")
    _assert_flags_equal(want, got)


def test_raw_css_code(setups):
    """make_code without the BB polynomial dims: no lift, padded-CSR
    min-sum in both packages."""
    seq = alpha_schedule("dynamical", MAXITER)
    want, got, tdecs = _flags(setups, False, (seq, seq))
    _assert_flags_equal(want, got)
    assert tdecs[0].graph.m == tdecs[0].H.shape[0]


def test_layered_falls_back_to_flooding(setups, caplog):
    """Layered with damping != 1, or on a graph with no lift, warns and
    runs the flooding schedule."""
    seq = alpha_schedule("dynamical", MAXITER)
    for lifted, damping in ((True, 0.9), (False, 1.0)):
        _, _, tcirc, tM = setups[lifted]
        decs = [tengine._make_basis(tcirc, tM, b, seq, osd_order=OSD_ORDER,
                                    device="cpu") for b in "ZX"]
        n_locs = tcirc.num_error_locs
        gen = torch.Generator().manual_seed(0)
        randoms = [sample_gate_randoms(gen, BATCH, n_locs, P)
                   for _ in range(ROUNDS)]
        outs = {}
        for variant in ("layered", "minsum"):
            caplog.clear()
            with caplog.at_level(logging.WARNING, logger=tengine.__name__):
                fn = tengine.make_pooled_round_fn(
                    *decs, n_locs, P, BATCH, MAXITER, OSD_ORDER, ROUNDS,
                    damping, bp_variant=variant)
            assert ("falling back to the flooding" in caplog.text) == \
                (variant == "layered")
            outs[variant] = fn(None, randoms=randoms)
        for k in FLAG_KEYS:
            assert torch.equal(outs["layered"][k], outs["minsum"][k]), k


def test_run_simulation_generic_paths():
    """run_simulation no longer refuses damping, tanh or a raw CSS code."""
    code = qt.get_code("[[72, 12, 6]]")
    kw = dict(num_cycles=2, maxIter=6, osd_order=0, max_trials=16,
              batch_size=16, base_seed=1, verbose=False, device="cpu")
    for extra in (dict(damping=0.8, **_bb_kwargs(code)),
                  dict(bp_variant="tanh", **_bb_kwargs(code)), dict()):
        res = qt.run_simulation(code.Hx, code.Hz, code.Lx, code.Lz, 0.006,
                                **kw, **extra)
        assert res["num_trials"] == 16 and 0 <= res["logical_errors"] <= 16
