"""The port's run_simulation in its calibrated modes vs the JAX engine.

Under ``alpha_mode="alvarado"`` (fitted, one scalar, a (z, x) pair),
``"alvarado-autoregressive"`` and ``scopt=True`` the port must return the
JAX package's result keys, and on the same calibration errors (both
packages' ``_sample_errors_and_syndromes`` replaced by one numpy stream
each, seeded alike) the JAX package's calibration values: Alvarado's alpha
and R^2 identical, the autoregressive sequence within 1e-4 relative with
the same fallbacks, beta within 1e-4 relative. The decode rounds draw from
each package's own generator, so their counts are not compared. Each JAX
run is made once per module (the round program compiles in each).
"""
import numpy as np
import pytest
import torch

import qldpc_tpu
from qldpc_tpu.ops import calibrate as jcal
from qldpc_tpu.parallel import engine as jengine

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.ops import calibrate as tcal

from test_torch_calibrate import numpy_sampler

torch.set_num_threads(1)

P, CYCLES, MAXITER = 0.006, 2, 4
RUNS = {
    "alvarado+scopt": dict(alpha_mode="alvarado", scopt=True,
                           alpha_estimation_trials=300),
    "pair": dict(alpha_mode="alvarado", alvarado_alpha=(0.7, 0.9)),
    "autoregressive": dict(alpha_mode="alvarado-autoregressive",
                           alpha_estimation_trials=200),
}


def _kwargs(code):
    return dict(num_cycles=CYCLES, maxIter=MAXITER, osd_order=0,
                max_trials=8, batch_size=8, base_seed=5, verbose=False,
                ell=code.ell, m=code.m, a_x_powers=code.a_x_powers,
                a_y_powers=code.a_y_powers, b_y_powers=code.b_y_powers,
                b_x_powers=code.b_x_powers)


def _run(package, mode):
    """run_simulation of ``package`` on [[72,12,6]] under RUNS[mode], its
    calibration sampler replaced by the numpy stream of seed 21."""
    mod, eng = ((jcal, jengine) if package == "jax"
                else (tcal, qt))
    saved = mod._sample_errors_and_syndromes
    mod._sample_errors_and_syndromes = numpy_sampler(21, package)
    try:
        code = qldpc_tpu.get_code("[[72, 12, 6]]")
        kw = dict(_kwargs(code), **RUNS[mode])
        if package == "torch":
            kw["device"] = "cpu"
        return eng.run_simulation(code.Hx, code.Hz, code.Lx, code.Lz, P,
                                  **kw)
    finally:
        mod._sample_errors_and_syndromes = saved


@pytest.fixture(scope="module")
def jax_results():
    return {mode: _run("jax", mode) for mode in RUNS}


@pytest.mark.parametrize("mode", list(RUNS))
def test_result_keys_and_calibration_match_jax(jax_results, mode):
    want, got = jax_results[mode], _run("torch", mode)
    assert set(got) == set(want), set(got) ^ set(want)
    assert got["num_trials"] == 8 and got["num_devices"] == 1
    for b in "zx":
        seq_w, seq_g = want[f"alpha_seq_{b}"], got[f"alpha_seq_{b}"]
        assert isinstance(seq_g, list) and len(seq_g) == MAXITER
        if mode == "autoregressive":
            np.testing.assert_allclose(seq_g, seq_w, rtol=1e-4)
            np.testing.assert_allclose(got[f"alpha_values_{b}"],
                                       want[f"alpha_values_{b}"], rtol=1e-4)
            r2w, r2g = (want[f"alpha_r2_values_{b}"],
                        got[f"alpha_r2_values_{b}"])
            assert np.array_equal(np.isnan(r2g), np.isnan(r2w))
            np.testing.assert_allclose(r2g[np.isfinite(r2w)],
                                       r2w[np.isfinite(r2w)], rtol=1e-4)
            assert got[f"n_alpha_fallbacks_{b}"] == \
                want[f"n_alpha_fallbacks_{b}"]
        else:
            assert seq_g == seq_w
            assert got[f"alpha_r2_{b}"] == want[f"alpha_r2_{b}"]
        if mode == "alvarado+scopt":
            assert got[f"alpha_r2_{b}"] is not None
            np.testing.assert_allclose(
                [got[f"beta_{b}"], got[f"beta_r2_{b}"]],
                [want[f"beta_{b}"], want[f"beta_r2_{b}"]], rtol=1e-4)
            assert got[f"beta_{b}"] < 0
    if mode == "pair":
        assert got["alpha_seq_z"] == [np.float32(0.7)] * MAXITER
        assert got["alpha_seq_x"] == [np.float32(0.9)] * MAXITER
        assert got["alpha_r2_z"] is None
    if mode == "autoregressive":
        assert got["n_alpha_fallbacks"] == want["n_alpha_fallbacks"] == \
            got["n_alpha_fallbacks_z"] + got["n_alpha_fallbacks_x"]


def test_scalar_alpha(jax_results):
    """One scalar for both bases: the pair run's keys, both sequences the
    scalar."""
    code = qldpc_tpu.get_code("[[72, 12, 6]]")
    got = qt.run_simulation(code.Hx, code.Hz, code.Lx, code.Lz, P,
                            alpha_mode="alvarado", alvarado_alpha=0.8,
                            device="cpu", **_kwargs(code))
    assert set(got) == set(jax_results["pair"])
    assert got["alpha_seq_z"] == got["alpha_seq_x"] == \
        [np.float32(0.8)] * MAXITER
    # use_dynamic_alpha=False selects the alvarado mode, as in JAX
    got = qt.run_simulation(code.Hx, code.Hz, code.Lx, code.Lz, P,
                            use_dynamic_alpha=False, alvarado_alpha=0.8,
                            device="cpu", **_kwargs(code))
    assert got["alpha_seq_z"] == [np.float32(0.8)] * MAXITER


def test_invalid_modes():
    code = qldpc_tpu.get_code("[[72, 12, 6]]")
    for kw, match in ((dict(alpha_mode="alvarado-autoregressive",
                            alvarado_alpha=0.8), "alvarado_alpha"),
                      (dict(alpha_mode="bogus"), "Unsupported alpha_mode"),
                      (dict(alpha_mode="alvarado", alvarado_alpha=-1.0),
                       "alpha must be > 0")):
        with pytest.raises(ValueError, match=match):
            qt.run_simulation(code.Hx, code.Hz, code.Lx, code.Lz, P,
                              device="cpu", **kw, **_kwargs(code))


def test_plots_written(tmp_path):
    """estimation_plot_dir receives one fit per basis and autoregressive
    step, named as the JAX engine names them."""
    code = qldpc_tpu.get_code("[[72, 12, 6]]")
    kw = dict(_kwargs(code), maxIter=2)
    qt.run_simulation(code.Hx, code.Hz, code.Lx, code.Lz, P,
                      alpha_mode="alvarado-autoregressive",
                      alpha_estimation_trials=100,
                      estimation_plot_dir=str(tmp_path), device="cpu", **kw)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted(
        f"autoregressive_0p006_{b}_iter{k}_alpha_fit.png"
        for b in "zx" for k in (1, 2)), names
