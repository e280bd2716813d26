"""The port's breakdowns and micro-benchmarks on the CPU: ``profile_round
--cumulative`` (the JAX package's ``scripts/round_breakdown.py``),
``osd_batch``'s prefixes (``scripts/osd_breakdown.py``, timed by
``osd_microbench``), ``scripts/osd_post_micro.py``,
``scripts/bp_microbench.py`` and ``bp_lift_bench --layered``
(``scripts/bp288_layered_lift_probe.py``).

Each prefix of ``ops.osd.osd_batch`` returns what the whole call goes on
from: the residual and reliability order equal the JAX script's, the
prefixes' validity equals the JAX ``osd_batch``'s (its XLA path, per shot)
and the whole call's outputs equal JAX's. ``osd_post_micro``'s ops equal
the JAX script's expressions on the same inputs. The roll decoder without
its host read gives the outputs it gives with it. Each ``main`` runs to its
end on [[72,12,6]] with ``--device cpu``.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import qldpc_tpu
from qldpc_tpu.ops import osd as jax_osd
from qldpc_tpu.ops.bp import alpha_schedule
from qldpc_tpu.parallel import engine as jengine

import qldpc_tpu_torch as qt
from qldpc_tpu_torch import profile_round, scripts
from qldpc_tpu_torch.ops import osd
from qldpc_tpu_torch.ops.bp_lift import decode_batch_lift
from qldpc_tpu_torch.scripts import (bp_lift_bench, bp_microbench,
                                     osd_post_micro)

torch.set_num_threads(1)

CODE, CYCLES, P, B = "[[72, 12, 6]]", 3, 0.01, 32


@pytest.fixture(scope="module")
def inputs():
    """Both packages' Z decoder (OSD order 2), numpy-made syndromes,
    posteriors and hard decisions (tests/test_torch_osd_studies.py's)."""
    seq = alpha_schedule("dynamical", 10)
    jcode = qldpc_tpu.get_code(CODE)
    jcirc = qldpc_tpu.SyndromeCircuit(jcode, num_cycles=CYCLES)
    jM = qldpc_tpu.build_decoding_matrices(jcirc, jcode.Lx, jcode.Lz, P)
    jdz = jengine._make_basis(jcirc, jM, "Z", seq, osd_order=2)
    circ = qt.SyndromeCircuit(qt.get_code(CODE), num_cycles=CYCLES)
    (dz,) = scripts.bases(circ, jM, 10, 2, "cpu", which="Z")
    H = np.asarray(jM["HdecZ"]) != 0
    m, n = H.shape
    rng = np.random.default_rng(11)
    err = rng.random((B, n)) < np.asarray(jM["channel_probsZ"]) * 3
    syn = (err.astype(np.int64) @ H.T.astype(np.int64)) % 2
    syn = syn.astype(np.int8)
    flip = err & (rng.random((B, n)) < 0.5)
    llr = (dz.prior.numpy() * (1 + 0.3 * rng.standard_normal((B, n)))
           * np.where(flip, -1, 1)).astype(np.float32)
    return dict(jdz=jdz, dz=dz, H=H, syn=syn, llr=llr,
                hard=(llr < 0).astype(np.int8))


def _osd(inp, stop, stage1=None):
    d = inp["dz"]
    t = torch.as_tensor
    return osd.osd_batch(d.H, d.HT, t(inp["syn"]), t(inp["llr"]),
                         t(inp["hard"]), K=d.K, order=2,
                         num_test=d.num_test, rank=d.rank,
                         basis_cols=d.basis_cols,
                         logical_pack=d.logical_pack, return_solution=False,
                         col_index=d.col_index, stop_after=stop,
                         stage1_cols=stage1)


@pytest.mark.parametrize("stage1", [0, 128])
def test_osd_prefixes_against_jax(inputs, stage1):
    """Single-stage and staged at 128 columns (K = 512 here)."""
    d, jd = inputs["dz"], inputs["jdz"]
    want = jax_osd.osd_batch(
        jd.H, jd.HT_bf16, jnp.asarray(inputs["syn"]),
        jnp.asarray(inputs["llr"]), jnp.asarray(inputs["hard"]), K=jd.K,
        order=2, num_test=jd.num_test, use_pallas=False, rank=jd.rank,
        basis_cols=jd.basis_cols, logical_pack=jd.logical_pack,
        return_solution=False)
    (residual,) = _osd(inputs, "residual", stage1)
    H = inputs["H"].astype(np.int64)
    assert np.array_equal(residual.numpy(), inputs["syn"]
                          ^ ((inputs["hard"].astype(np.int64) @ H.T) % 2))
    res2, colsK = _osd(inputs, "sort", stage1)
    assert torch.equal(res2, residual)
    assert np.array_equal(colsK.numpy(), np.argsort(
        np.abs(inputs["llr"]), axis=1, kind="stable")[:, :d.K])
    m = H.shape[0]
    covered = {}
    for stop in ("stage1", "tail", "basis"):
        s_red, prow, used, cf = _osd(inputs, stop, stage1)
        covered[stop] = (scripts.unsatisfied(s_red, used, m) == 0).numpy()
        if stop != "stage1" or not stage1:
            assert prow.shape == (B, d.K + d.basis_cols.numel())
    # the basis rerun covers every shot the prefix can: OSD-0's validity
    assert np.array_equal(covered["basis"],
                          ~np.asarray(want["rank_deficient"]))
    assert (covered["stage1"] <= covered["tail"]).all()
    assert (covered["tail"] <= covered["basis"]).all()
    e_perm, valid, overflow = _osd(inputs, "reprocess", stage1)
    assert np.array_equal(valid.numpy(), np.asarray(want["valid"]))
    assert not overflow.any()
    whole = _osd(inputs, None, stage1)
    assert np.array_equal(whole["logical_delta_packed"].numpy(),
                          np.asarray(want["logical_delta_packed"]))
    assert torch.equal(whole["valid"], valid)
    with pytest.raises(ValueError):
        _osd(inputs, "readout", stage1)


def test_osd_post_micro_ops_match_the_jax_expressions():
    x = osd_post_micro.inputs(16, 100, 300, 64, 32, "cpu")
    got = dict(osd_post_micro.ops(x))
    s, prow = (jnp.asarray(x[k].numpy()) for k in ("s_red", "prow"))
    take = got["e0 take_along (B,KT)<-(B,M) lanes"]().numpy()
    assert np.array_equal(take, np.asarray(jnp.take_along_axis(
        s, jnp.maximum(prow, 0), axis=1)))
    lp, e, c = (x[k].numpy() for k in ("lp", "e_perm", "colsE"))
    want = np.bitwise_xor.reduce(np.where(e > 0, lp[c], 0), axis=1)
    assert np.array_equal(
        got["logical gather (n,)->(B,KT) + xor reduce"]().numpy(), want)
    u = x["used"].numpy()
    a, b = got["unsat row sums x2"]()
    assert np.array_equal(a.numpy(), np.where(~u, x["s_red"].numpy(), 0)
                          .sum(1))
    assert np.array_equal(b.numpy(), np.where(u, x["s_red"].numpy(), 0)
                          .sum(1))
    llr = jnp.asarray(x["llr"].numpy())
    assert np.array_equal(got["argsort full (B,n) f32 (stable)"]().numpy(),
                          np.asarray(jnp.argsort(jnp.abs(llr), axis=1)))
    e0 = got["e0 scatter (B,M)->(B,KT+1) (the port's)"]().numpy()
    assert e0.shape == (16, x["KT"]) and set(np.unique(e0)) <= {0, 1}
    out = osd_post_micro.main(["16", "100", "300", "64", "32", "--device",
                               "cpu"])
    assert list(out) == [name for name, _ in osd_post_micro.ops(x)]
    assert out["noop floor"]["minus_floor_ms"] == 0.0


@pytest.fixture
def at_72(tmp_path, monkeypatch):
    """Matrices cached in a temporary directory; ``build`` at 3 cycles."""
    monkeypatch.chdir(tmp_path)
    build = functools.partial(scripts.build, cycles=CYCLES)
    for mod in (bp_lift_bench, scripts):
        monkeypatch.setattr(mod, "build", build)


def test_cumulative_round_on_cpu(at_72, capsys):
    out = profile_round.main(["--cumulative", CODE, "0.006", "32", "2",
                              "--max-iter", "6", "--reps", "2", "--device",
                              "cpu"])
    assert list(out["variant_ms"]) == list(profile_round.CUMULATIVE)
    assert list(out["delta_ms"]) == ["sample", "BP", "sort", "OSD",
                                     "readout"]
    assert all(v > 0 for v in out["variant_ms"].values())
    text = capsys.readouterr().out
    assert "deltas: sample" in text and "round throughput" in text


def test_bp_microbench_on_cpu(at_72):
    out = bp_microbench.main([CODE, "0.006", "16", "6", "--device", "cpu"])
    rows, split = out["rows"], out["split"]
    assert "csr full decode_batch f32" in rows and \
        "K1 decode_batch_lift_cuda f32" in rows
    assert all(r["ms"] > 0 and r["launches"] is None for r in rows.values())
    assert split["csr_launch_ms"] is None and split["k1_ms"] > 0
    assert isinstance(split["roll_float64_update_ms"], float)


def test_plain_loops_and_roll_decoder_without_its_read(inputs):
    """The check and the read do not change a plain loop's messages; the
    roll decoder without its host read gives the same outputs."""
    d = inputs["dz"]
    syn = torch.as_tensor(inputs["syn"])
    seq = d.alpha_seq
    base = bp_microbench.csr_loop(d.graph, syn, d.prior, seq, 10)
    assert torch.equal(base, bp_microbench.csr_loop(
        d.graph, syn, d.prior, seq, 10, check=True))
    onehot = bp_microbench.onehot_matrix(d.graph, "cpu")
    assert onehot.shape == (d.graph.n, d.graph.m * d.graph.dr)
    assert int(onehot.float().sum()) == int(d.graph.row_mask.sum())
    for kw in ({}, dict(damping=0.8)):
        a = decode_batch_lift(d.lifted, syn, d.prior, seq, 10, **kw)
        b = decode_batch_lift(d.lifted, syn, d.prior, seq, 10,
                              exit_check=False, **kw)
        for k in a:
            assert torch.equal(a[k], b[k]), (kw, k)


def test_layered_row_on_cpu(at_72, capsys):
    out = bp_lift_bench.main(["--layered", CODE, "0.006", "16", "6",
                              "--device", "cpu"])
    names = ["layered lift (PyTorch ops)", "K3 layered", "K1 flooding"]
    assert [k for k in out if k != "osd_ms"] == names
    assert out["osd_ms"] > 0
    k1, k3 = out["K1 flooding"], out["K3 layered"]
    un_f, un_l = 16 - k1["converged"], 16 - k3["converged"]
    assert k3["saves_ms"] == pytest.approx(
        2 * out["osd_ms"] * (un_f - un_l) / un_f)
    assert k3["pays_ms"] == pytest.approx(2 * 6 * k3["ms_per_iter"])
    assert "break-even at" in capsys.readouterr().out
