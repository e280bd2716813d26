"""The port's calibration (qldpc_tpu_torch/ops/calibrate.py) vs the JAX
package's, on the same error samples.

PyTorch cannot replay ``jax.random``, so both packages'
``_sample_errors_and_syndromes`` are replaced by one numpy stream each,
seeded alike and drawn in call order. On those errors Alvarado's harvest
(one unscaled check pass on the prior) and hence its fit must be
identical; the autoregressive sequence must agree within 1e-4 relative with
the same fallbacks; SCOPT's beta within 1e-4 relative.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import qldpc_tpu
from qldpc_tpu.ops import bp as jbp
from qldpc_tpu.ops import calibrate as jcal

from qldpc_tpu_torch.ops import bp as tbp
from qldpc_tpu_torch.ops import calibrate as tcal

torch.set_num_threads(1)

P = 0.01


@pytest.fixture(scope="module")
def setup72():
    """tests/test_calibrate.py's [[72,12,6]], 3 cycles, p=0.01."""
    code = qldpc_tpu.get_code("[[72, 12, 6]]")
    circ = qldpc_tpu.SyndromeCircuit(code, num_cycles=3)
    M = qldpc_tpu.build_decoding_matrices(circ, code.Lx, code.Lz, P)
    return {b: (M[f"Hdec{b}"], qldpc_tpu.channel_llrs(M[f"channel_probs{b}"]))
            for b in "ZX"}


def numpy_sampler(seed: int, package: str):
    """A replacement for ``_sample_errors_and_syndromes`` of ``package``
    ("jax" or "torch"): iid errors from one numpy stream, syndromes exact
    mod 2, returned in the package's array type."""
    rng = np.random.default_rng(seed)

    def sample(_key, HT, n, p, trials):
        if package == "jax":
            Hn = np.asarray(HT.astype(jnp.float32))
        else:
            Hn = HT.cpu().numpy()
        e = rng.random((trials, n)) < p
        syn = ((e.astype(np.float32) @ Hn).astype(np.int64) & 1)
        syn = syn.astype(np.int8)
        if package == "jax":
            return jnp.asarray(e), jnp.asarray(syn)
        return torch.as_tensor(e), torch.as_tensor(syn)

    return sample


@pytest.fixture
def shared_errors(monkeypatch):
    """Both samplers replaced by the same numpy stream (seed 11)."""
    monkeypatch.setattr(jcal, "_sample_errors_and_syndromes",
                        numpy_sampler(11, "jax"))
    monkeypatch.setattr(tcal, "_sample_errors_and_syndromes",
                        numpy_sampler(11, "torch"))


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_alvarado_buckets_and_fit_identical(setup72, shared_errors, basis):
    H, llrs = setup72[basis]
    Hb = (np.asarray(H) != 0)
    jb = jcal._harvest_buckets(
        jbp.TannerGraph.from_dense(H),
        jnp.asarray(Hb.astype(np.float32), dtype=jnp.bfloat16).T,
        jnp.asarray(llrs, jnp.float32), P, 700, jax.random.key(0),
        np.zeros(0, np.float32), 0)
    tb = tcal._harvest_buckets(
        tbp.TannerGraph.from_dense(H, device="cpu"),
        torch.as_tensor(Hb.T.astype(np.float32)),
        torch.as_tensor(llrs, dtype=torch.float32), P, 700, (0,),
        np.zeros(0, np.float32), 0)
    for a, b in zip(jb, tb):
        assert a.dtype == b.numpy().dtype == np.float32
        assert np.array_equal(a, b.numpy())
    assert len(tb[1]) > 0
    want = jcal.estimate_alpha_alvarado(H, P, trials=600, llrs=llrs)
    got = tcal.estimate_alpha_alvarado(H, P, trials=600, llrs=llrs,
                                       device="cpu")
    assert got == want
    assert 0.05 < got[0] < 1.5 and got[1] > 0.5


def _record_gates(monkeypatch, module, log):
    gate = module._gate_alpha

    def recorded(a, r2, k, *rest):
        out = gate(a, r2, k, *rest)
        log.append((k, out[1]))
        return out

    monkeypatch.setattr(module, "_gate_alpha", recorded)


@pytest.mark.parametrize("basis,trials", [("Z", 200), ("X", 200),
                                          ("Z", 8)])
def test_autoregressive_matches_jax(setup72, shared_errors, monkeypatch,
                                    basis, trials):
    """maxIter 4; 8 trials starve the fits so that the gate engages."""
    H, llrs = setup72[basis]
    jlog, tlog = [], []
    _record_gates(monkeypatch, jcal, jlog)
    _record_gates(monkeypatch, tcal, tlog)
    ja, jr, jn = jcal.estimate_alpha_alvarado_autoregressive(
        H, P, 4, trials=trials, llrs=llrs, return_fallbacks=True)
    ta, tr, tn = tcal.estimate_alpha_alvarado_autoregressive(
        H, P, 4, trials=trials, llrs=llrs, return_fallbacks=True,
        device="cpu")
    assert tlog == jlog and tn == jn
    assert ta.shape == tr.shape == (4,)
    np.testing.assert_allclose(ta, ja, rtol=1e-4, atol=0)
    assert np.array_equal(np.isnan(tr), np.isnan(jr))
    fin = np.isfinite(jr)
    np.testing.assert_allclose(tr[fin], jr[fin], rtol=1e-4, atol=1e-6)
    assert ta[0] == ja[0] and tr[0] == jr[0]   # k = 0 is exact
    assert np.all(ta >= 0.05) and np.all(ta <= 1.5)
    if trials == 8:
        assert tn > 0


@pytest.mark.parametrize("mode,alpha", [("dynamical", 1.0),
                                        ("alvarado", 0.8)])
def test_scopt_beta_matches_jax(setup72, shared_errors, mode, alpha):
    H, llrs = setup72["Z"]
    want = jcal.estimate_scopt_beta(H, P, trials=300, maxIter=8, llrs=llrs,
                                    alpha=alpha, alpha_mode=mode)
    got = tcal.estimate_scopt_beta(H, P, trials=300, maxIter=8, llrs=llrs,
                                   alpha=alpha, alpha_mode=mode,
                                   device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[0] < 0 and np.isfinite(got[1])


@pytest.mark.parametrize("case", ["spread", "ties", "one value"])
def test_histogram_is_numpys(case):
    """The binning rule reproduces np.histogram's densities exactly,
    values on the edges included."""
    rng = np.random.default_rng(7)
    x = {"spread": rng.normal(0.3, 7.0, 20000),
         "ties": rng.choice([-20.0, -1.5, 0.0, 2.25, 20.0], 5000),
         "one value": np.full(100, 4.0)}[case]
    lo, hi = float(x.min()), float(x.max())
    if case == "ties":
        x = np.concatenate([x, np.linspace(lo, hi, 51)])  # every edge
    for bins in (7, 50):
        want = np.histogram(x, bins=bins, range=(lo, hi), density=True)
        got = tcal._histogram(torch.as_tensor(x), lo, hi, bins)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)


def test_gate_rules():
    """The fit gate substitutes the dynamical value for untrustworthy fits:
    low R^2, out-of-range alpha, or NaN; the same rules as JAX's."""
    good, fb = tcal._gate_alpha(0.8, 0.95, 3, 0.85, (0.05, 1.5))
    assert good == 0.8 and not fb
    for bad in [(0.8, 0.5), (3.0, 0.99), (-0.2, 0.99), (np.nan, np.nan),
                (0.8, np.nan)]:
        a, fb = tcal._gate_alpha(bad[0], bad[1], 3, 0.85, (0.05, 1.5))
        assert fb and a == tcal._dynamical_alpha(3) == 1.0 - 2.0 ** -4
        assert (a, fb) == jcal._gate_alpha(bad[0], bad[1], 3, 0.85,
                                           (0.05, 1.5))
    for k in range(6):
        assert tcal._dynamical_alpha(k) == jcal._dynamical_alpha(k)


def test_invalid_arguments(setup72):
    H, llrs = setup72["Z"]
    with pytest.raises(ValueError, match="error_rate"):
        tcal.estimate_alpha_alvarado(H, 0.7, llrs=llrs, device="cpu")
    with pytest.raises(ValueError, match="error_rate"):
        tcal.estimate_scopt_beta(H, 0.0, llrs=llrs, device="cpu")
    with pytest.raises(ValueError, match="maxIter"):
        tcal.estimate_alpha_alvarado_autoregressive(H, 0.01, maxIter=0,
                                                    llrs=llrs, device="cpu")
    with pytest.raises(ValueError, match="No finite samples"):
        tcal._fit_log_ratio(np.array([1e30]), np.array([1.0]), 10)


def test_only_fit_failures_fall_back(setup72, monkeypatch):
    """A fit that fails (FitFailed: no sample, no shared bin, or scipy's
    optimum not found) falls back to the dynamical value; an error of the
    device work around it (harvest, binning) propagates."""
    import scipy.optimize
    H, llrs = setup72["Z"]
    kw = dict(maxIter=3, trials=64, llrs=llrs, return_fallbacks=True,
              device="cpu")
    fit = tcal._fit_log_ratio
    calls = []

    def fail_second(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise tcal.FitFailed("No overlapping histogram bins")
        return fit(*a, **k)
    monkeypatch.setattr(tcal, "_fit_log_ratio", fail_second)
    alphas, r2s, n_fb = tcal.estimate_alpha_alvarado_autoregressive(
        H, P, **kw)
    assert alphas[1] == tcal._dynamical_alpha(1) and np.isnan(r2s[1])
    assert n_fb >= 1 and np.isfinite(r2s[0])

    def device_error(*a, **k):
        raise RuntimeError("CUDA error: out of memory")
    for name in ("_fit_log_ratio", "_harvest_buckets"):
        with monkeypatch.context() as m:
            m.setattr(tcal, name, device_error)
            with pytest.raises(RuntimeError, match="out of memory"):
                tcal.estimate_alpha_alvarado_autoregressive(H, P, **kw)

    def no_optimum(*a, **k):
        raise RuntimeError("Optimal parameters not found")
    monkeypatch.setattr(tcal, "_fit_log_ratio", fit)
    monkeypatch.setattr(scipy.optimize, "curve_fit", no_optimum)
    rng = np.random.default_rng(0)
    with pytest.raises(tcal.FitFailed, match="Optimal parameters"):
        tcal._fit_log_ratio(rng.normal(2, 1, 500), rng.normal(-2, 1, 500),
                            20)
    _, r2s, n_fb = tcal.estimate_alpha_alvarado_autoregressive(H, P, **kw)
    assert n_fb == 3 and np.isnan(r2s).all()


def test_plot_written_only_when_asked(tmp_path, setup72):
    H, llrs = setup72["Z"]
    tcal.estimate_alpha_alvarado(H, 0.01, trials=200, llrs=llrs,
                                 device="cpu")
    assert not any(tmp_path.iterdir())
    path = tmp_path / "fit.png"
    tcal.estimate_alpha_alvarado(H, 0.01, trials=200, llrs=llrs,
                                 plot_path=str(path), device="cpu")
    assert path.exists() and path.stat().st_size > 0


def test_fit_imports_matplotlib_only_for_a_plot():
    """A fit without a plot must not import matplotlib, so that calibration
    runs where scipy is installed and matplotlib is not."""
    root = Path(__file__).resolve().parent.parent
    code = ("import sys, numpy as np\n"
            "from qldpc_tpu_torch.ops import calibrate\n"
            "rng = np.random.default_rng(0)\n"
            "a, r2 = calibrate._fit_log_ratio(rng.normal(2, 1, 5000),\n"
            "                                 rng.normal(-2, 1, 5000), 30)\n"
            "assert 0.5 < a < 8, a\n"
            "assert 'matplotlib' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr


def test_port_sampler(setup72):
    """The port's own sampler: exact syndromes, iid rate, and one stream
    per seed path."""
    H, _ = setup72["Z"]
    HT = torch.as_tensor((np.asarray(H) != 0).T.astype(np.float32))
    n = HT.shape[0]
    e, syn = tcal._sample_errors_and_syndromes(
        tcal._generator("cpu", 3, 0), HT, n, 0.05, 64)
    assert e.dtype == torch.bool and syn.dtype == torch.int8
    assert np.array_equal(syn.numpy(), (e.numpy().astype(np.int64)
                                        @ (np.asarray(H) != 0).T) % 2)
    assert abs(float(e.float().mean()) - 0.05) < 0.01
    again = tcal._sample_errors_and_syndromes(
        tcal._generator("cpu", 3, 0), HT, n, 0.05, 64)[0]
    other = tcal._sample_errors_and_syndromes(
        tcal._generator("cpu", 3, 512), HT, n, 0.05, 64)[0]
    assert torch.equal(e, again) and not torch.equal(e, other)
