"""The port's run_multi_code_simulation under calibrated alpha vs JAX's.

Under ``alpha_mode="alvarado-autoregressive"`` each code is calibrated
once, with seed ``base_seed + 101*i`` and its own plot tag. With both
packages' calibration samplers replaced by one numpy stream each, seeded
alike (as tests/test_torch_engine_modes.py does for one code), the port
must return JAX's result keys for every code and JAX's calibration values:
the fitted sequences within 1e-4 relative, the same fallbacks. The decode
rounds draw from each package's own generator, so their counts are not
compared.
"""
import numpy as np
import pytest
import torch

from qldpc_tpu.ops import calibrate as jcal
from qldpc_tpu.parallel import engine as jengine

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.ops import calibrate as tcal

from test_torch_calibrate import numpy_sampler

torch.set_num_threads(1)

CODES = ["[[72, 12, 6]]", "[[90, 8, 10]]"]
MAXITER = 4
KW = dict(num_cycles=2, maxIter=MAXITER, osd_order=0, max_trials=8,
          batch_size=8, base_seed=5, verbose=False,
          alpha_mode="alvarado-autoregressive", alpha_estimation_trials=200)


def _run(package, plot_dir):
    mod, run = ((jcal, jengine.run_multi_code_simulation) if package == "jax"
                else (tcal, qt.run_multi_code_simulation))
    saved = mod._sample_errors_and_syndromes
    mod._sample_errors_and_syndromes = numpy_sampler(21, package)
    try:
        kw = dict(KW, estimation_plot_dir=str(plot_dir))
        if package == "torch":
            kw["device"] = "cpu"
        return run(CODES, 0.006, **kw)
    finally:
        mod._sample_errors_and_syndromes = saved


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """{package: (results, plot directory)}."""
    out = {}
    for pkg in ("jax", "torch"):
        plot_dir = tmp_path_factory.mktemp(pkg)
        out[pkg] = (_run(pkg, plot_dir), plot_dir)
    return out


@pytest.mark.parametrize("name", CODES)
def test_calibrated_multi_code_matches_jax(both, name):
    want, got = both["jax"][0][name], both["torch"][0][name]
    assert set(got) == set(want), set(got) ^ set(want)
    assert got["num_trials"] == 8 and got["num_devices"] == 1
    for b in "zx":
        assert len(got[f"alpha_seq_{b}"]) == MAXITER
        np.testing.assert_allclose(got[f"alpha_seq_{b}"],
                                   want[f"alpha_seq_{b}"], rtol=1e-4)
        np.testing.assert_allclose(got[f"alpha_values_{b}"],
                                   want[f"alpha_values_{b}"], rtol=1e-4)
        assert got[f"n_alpha_fallbacks_{b}"] == want[f"n_alpha_fallbacks_{b}"]
    assert got["n_alpha_fallbacks"] == want["n_alpha_fallbacks"]


def test_calibration_plots_per_code(both):
    """Each code's fits are plotted under its own tag, as JAX names them."""
    names = {pkg: sorted(p.name for p in d.iterdir())
             for pkg, (_, d) in both.items()}
    assert names["torch"] == names["jax"]
    assert len(names["torch"]) == len(CODES) * 2 * MAXITER
    assert any(n.startswith("[[90,8,10]]_autoregressive") for n in
               names["torch"])
