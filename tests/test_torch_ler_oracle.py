"""The port's ``ler_oracle`` decode on the reference-sampled trials
committed in ``scripts/oracle_data/``, against the JAX package.

The trials' true logicals are recorded in the CSS standard-form basis of
the logical operators (``models.gf2.css_standard_form_logicals``), not in
the basis ``codes/*.npz`` stores: built with the stored basis the port
reads nearly every trial as an error, ``ler_oracle basis`` recovers the
standard form from the trials themselves, and with it JAX's
``_decode_one_basis`` reproduces its committed per-trial flags. On
the first 64 [[90,8,10]] trials at maxIter 20 the port's plain path equals
JAX's ``_decode_one_basis`` on its XLA path (``use_pallas=False``,
float32, as the JAX script's ``ourdecode`` ran) per trial: errors,
converged and rank-deficient flags, and both equal the committed flags.
At maxIter 50 JAX's XLA lift drifts from its Pallas path on a few
trials, and the port follows the Pallas path:
test_torch_ler_oracle_pallas.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qldpc_tpu.models.bb import make_code as jmake_code
from qldpc_tpu.models.builder import build_decoding_matrices as jbuild
from qldpc_tpu.models.circuit import SyndromeCircuit as JCircuit
from qldpc_tpu.ops.bp import alpha_schedule
from qldpc_tpu.parallel import engine as jengine

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.models import gf2
from qldpc_tpu_torch.scripts import ler_oracle

torch.set_num_threads(1)

CODE, CYCLES, P, N = "[[90, 8, 10]]", 10, 0.004, 64


@pytest.fixture(scope="module")
def trials():
    return np.load(ler_oracle.data_path(CODE, CYCLES, P))


def jax_matrices(logicals: str):
    """JAX's code, circuit and matrices of [[90]] with the logical basis
    ``logicals`` (the port's choice of it)."""
    c = ler_oracle.load_code(CODE, logicals)
    bb = dict(ell=c.ell, m=c.m, a_x_powers=c.a_x_powers,
              a_y_powers=c.a_y_powers, b_y_powers=c.b_y_powers,
              b_x_powers=c.b_x_powers)
    code = jmake_code(c.Hx, c.Hz, c.Lx, c.Lz, **bb)
    circ = JCircuit(code, num_cycles=CYCLES)
    return circ, jbuild(circ, code.Lx, code.Lz, P)


def jax_decode(circ, M, trials, basis, max_iter, n=N, use_pallas=False):
    dec = jengine._make_basis(circ, M, basis, alpha_schedule("dynamical",
                                                              max_iter),
                              osd_order=2)
    key = "syn_z" if basis == "Z" else "syn_x"
    tkey = "true_z" if basis == "Z" else "true_x"
    return [np.asarray(x) for x in jengine._decode_one_basis(
        jnp.asarray(trials[key][:n]), jnp.asarray(trials[tkey][:n]), dec,
        max_iter, 2, 1.0, 20.0, use_pallas, jnp.float32)]


def test_standard_form_logicals_are_valid_and_differ_from_codes():
    d = np.load(ler_oracle.CODES_DIR / f"{CODE}.npz")
    Lx, Lz = gf2.css_standard_form_logicals(d["Hx"], d["Hz"])
    assert not (d["Hz"] @ Lx.T % 2).any() and not (d["Hx"] @ Lz.T % 2).any()
    assert np.array_equal(Lx.astype(int) @ Lz.T % 2, np.eye(8, dtype=int))
    # the same logical operators as the stored basis, another basis of them
    assert gf2.rank(np.vstack([d["Hx"], Lx])) == \
        gf2.rank(np.vstack([d["Hx"], d["Lx"]])) == gf2.rank(d["Hx"]) + 8
    assert gf2.rank(np.vstack([d["Hx"], Lx, d["Lx"]])) == gf2.rank(d["Hx"]) + 8
    assert not np.array_equal(Lx, d["Lx"] % 2)


def test_port_equals_jax_per_trial_mi20(trials):
    """Both bases, the first 64 trials: port == JAX (XLA path) == record."""
    circ, jM = jax_matrices("standard")
    tcode = ler_oracle.load_code(CODE)
    tcirc = qt.SyndromeCircuit(tcode, num_cycles=CYCLES)
    M = qt.build_decoding_matrices(tcirc, tcode.Lx, tcode.Lz, P)
    for key in ("HdecZ", "HZ_full", "HX_full"):
        assert np.array_equal(M[key], jM[key]), key
    record = np.load(ler_oracle.record_path(CODE, CYCLES, P, 20))
    res = ler_oracle.decode_file(tcirc, M, trials, 20, 2, "cpu", first=N)
    for basis, rkey in (("Z", "z_err"), ("X", "x_err")):
        jerr, jconv, jrdef = jax_decode(circ, jM, trials, basis, 20)
        got = res[basis]
        assert np.array_equal(got["err"], jerr), basis
        assert np.array_equal(got["conv"], jconv), basis
        assert np.array_equal(got["rank_deficient"], jrdef), basis
        assert np.array_equal(jerr, record[rkey][:N]), basis
        assert not got["overflow"].any()
        assert 0 < jconv.sum() < N and jerr.sum() < N // 4


def test_stored_logicals_read_as_errors(trials):
    """The negative control: with ``codes/*.npz``'s logical basis the
    port's decode of the first 32 trials errs on nearly all of them."""
    n = 32
    code = ler_oracle.load_code(CODE, "codes")
    circ = qt.SyndromeCircuit(code, num_cycles=CYCLES)
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, P)
    res = ler_oracle.decode_file(circ, M, trials, 20, 2, "cpu", first=n)
    record = np.load(ler_oracle.record_path(CODE, CYCLES, P, 20))
    for b, k in (("Z", "z_err"), ("X", "x_err")):
        assert res[b]["err"].sum() > 0.8 * n > record[k][:n].sum()


def test_basis_regression_recovers_the_standard_form():
    """``ler_oracle basis`` on the first 256 trials: the BP-converged
    trials' decoded frames have full rank, so each true bit's operator is
    unique; it predicts every such trial and is the standard form."""
    out = ler_oracle.main(["basis", "--code", CODE, "--cycles", str(CYCLES),
                           "--p", str(P), "--first", "256", "--max-iter",
                           "30", "--device", "cpu"])
    for b in "ZX":
        r = out[b]
        assert r["rank"] == r["n"] == 90 and r["converged"] > 100
        assert r["min_share"] == 1.0
        assert r["equals_standard"] and not r["equals_stored"]


def test_main_on_a_handful(tmp_path, capsys):
    out = ler_oracle.main(["ourdecode", "--code", CODE, "--cycles",
                           str(CYCLES), "--p", str(P), "--max-iter", "20",
                           "--first", "8", "--device", "cpu",
                           "--flags-out", str(tmp_path)])
    text = capsys.readouterr().out
    assert '"max_iter": 20' in text and "vs record" in text
    (r,) = out
    assert r["line"]["n"] == 8 and r["extra"]["z_disagree"] == 0
    assert r["extra"]["x_disagree"] == 0 and r["extra"]["z"] == 0.0
    saved = np.load(tmp_path / ler_oracle.record_path(CODE, CYCLES, P,
                                                       20).name)
    assert np.array_equal(saved["z_err"], r["flags"]["Z"]["err"])
    assert sum(r["extra"]["overflow_trials"].values()) == 0
