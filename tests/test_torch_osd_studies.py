"""The port's OSD studies (qldpc_tpu_torch/scripts/{osd144_stage_ab,
osd288_ab,osd288_probe,osd_margin_probe,osd_microbench}.py) against the
JAX functions the JAX scripts call.

On numpy-made posteriors and syndromes at [[72,12,6]] (3 cycles, basis Z),
each statistic an entry point reports equals the same computation done
with the JAX package's ``osd_batch``, ``_gather_pack`` and
``eliminate_blocks`` (its Pallas kernel in interpret mode, as the JAX
package's own tests run it on the CPU): the delta-sum, valid and
rank-deficient counts per stage-1 width (6 and 7), the exit depths and
the stage-1 prefix coverage (8), the valid shots within each K (9), and
the valid counts with and without the validity exit (10). The port's
eliminators exit per shot, so the JAX kernel runs one shot a block where
the depth is compared. Each ``main`` runs to its end with ``--device cpu``
(3 cycles: the tests wrap each module's ``build``).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import qldpc_tpu
from qldpc_tpu.ops import osd as jax_osd
from qldpc_tpu.ops import osd_pallas as jax_osd_pallas
from qldpc_tpu.ops.bp import alpha_schedule
from qldpc_tpu.parallel import engine as jengine

import qldpc_tpu_torch as qt
from qldpc_tpu_torch import scripts
from qldpc_tpu_torch.ops.osd import PREFIXES
from qldpc_tpu_torch.scripts import (bp_lift_bench, osd144_stage_ab,
                                     osd288_ab, osd288_probe,
                                     osd_margin_probe, osd_microbench)

torch.set_num_threads(1)

CODE, CYCLES, P, B, MAXITER = "[[72, 12, 6]]", 3, 0.01, 32, 10


@pytest.fixture(scope="module")
def inputs():
    """Both packages' Z decoder (OSD order 2) on the same matrices, and
    syndromes, posteriors and hard decisions made with numpy: errors from
    the channel, LLRs the prior with noise and the sign of a fault's
    column flipped half the time, hard decisions their signs."""
    seq = alpha_schedule("dynamical", MAXITER)
    jcode = qldpc_tpu.get_code(CODE)
    jcirc = qldpc_tpu.SyndromeCircuit(jcode, num_cycles=CYCLES)
    jM = qldpc_tpu.build_decoding_matrices(jcirc, jcode.Lx, jcode.Lz, P)
    jdz = jengine._make_basis(jcirc, jM, "Z", seq, osd_order=2)
    code = qt.get_code(CODE)
    circ = qt.SyndromeCircuit(code, num_cycles=CYCLES)
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, P)
    (dz,) = scripts.bases(circ, M, MAXITER, 2, "cpu", which="Z")
    H = np.asarray(M["HdecZ"]) != 0
    m, n = H.shape
    rng = np.random.default_rng(11)
    err = rng.random((B, n)) < np.asarray(M["channel_probsZ"]) * 3
    syn = (err.astype(np.int64) @ H.T.astype(np.int64)) % 2
    prior = dz.prior.numpy()
    flip = err & (rng.random((B, n)) < 0.5)
    llr = (prior * (1 + 0.3 * rng.standard_normal((B, n)))
           * np.where(flip, -1, 1)).astype(np.float32)
    hard = (llr < 0).astype(np.int8)
    return dict(jdz=jdz, dz=dz, syn=syn.astype(np.int8), llr=llr, hard=hard,
                m=m, n=n)


@pytest.fixture
def interpreted(monkeypatch):
    """JAX's eliminator in interpret mode."""
    elim = jax_osd_pallas.eliminate_blocks
    monkeypatch.setattr(jax_osd_pallas, "eliminate_blocks",
                        lambda *a, **k: elim(*a, **k, interpret=True))
    jax.clear_caches()
    yield elim
    jax.clear_caches()


def _port(inp):
    t = torch.as_tensor
    return t(inp["syn"]), t(inp["llr"]), t(inp["hard"])


def _jax_prep(inp, Kx: int):
    """The JAX probes' prep: residual, reliability order, the words-major
    pack of the first Kx columns, rows padded to 128 lanes."""
    d, m = inp["jdz"], inp["m"]
    syn, llr, hard = (jnp.asarray(inp[k]) for k in ("syn", "llr", "hard"))
    hard_syn = (jnp.dot(hard.astype(jnp.bfloat16), d.HT_bf16,
                        preferred_element_type=jnp.float32)
                .astype(jnp.int32) & 1)
    residual = syn.astype(jnp.int32) ^ hard_syn
    order = jnp.argsort(jnp.abs(llr), axis=1, stable=True)
    Kp = -(-Kx // 32) * 32
    packed = jax_osd._gather_pack(d.H, order[:, :Kx], Kp, words_major=True)
    M_pad = -(-m // 128) * 128
    return (jnp.pad(packed, ((0, 0), (0, 0), (0, M_pad - m))),
            jnp.pad(residual, ((0, 0), (0, M_pad - m))), order)


@pytest.mark.parametrize("order, widths", [(2, (0, 128)), (0, (0, 256))])
def test_stage_sums_match_jax(inputs, interpreted, order, widths):
    """osd144_stage_ab (order 2) and osd288_ab (OSD-0): per stage-1 width,
    the delta-sum, valid and rank-deficient counts of JAX's osd_batch."""
    dz, jdz = inputs["dz"], inputs["jdz"]
    syn, llr, hard = _port(inputs)
    num_test = jdz.num_test if order else 0
    bp = dict(values=llr, hard=hard)
    got = osd144_stage_ab.run_widths(dz, syn, bp, widths, order, num_test,
                                     0, torch.device("cpu"))
    for s1 in widths:
        rr = jax_osd.osd_batch(
            jdz.H, jdz.HT_bf16, jnp.asarray(inputs["syn"]),
            jnp.asarray(inputs["llr"]), jnp.asarray(inputs["hard"]),
            K=jdz.K, order=order, num_test=num_test, use_pallas=True,
            rank=jdz.rank, basis_cols=jdz.basis_cols,
            logical_pack=jdz.logical_pack, return_solution=False,
            stage1_cols=s1)
        want = (int(rr["logical_delta_packed"].sum()), int(rr["valid"].sum()),
                int(rr["rank_deficient"].sum()))
        assert got[s1][:3] == want, s1
    assert got[widths[0]][1] > 0 and got[widths[0]][0] != 0


def test_probe_depths_and_coverage_match_jax(inputs, interpreted):
    """osd288_probe: each shot's exit depth and cover at the full prefix,
    and the shots a stage-1 prefix leaves uncovered."""
    dz, jdz, m = inputs["dz"], inputs["jdz"], inputs["m"]
    syn, llr, hard = _port(inputs)
    res = osd288_probe.probe(dz, syn, llr, hard, (96,), 0,
                             torch.device("cpu"))
    hp, s_pad, _ = _jax_prep(inputs, jdz.K)
    for Kx in (jdz.K, 96):
        _, s_red, _, used, cf = interpreted(
            hp[:, :-(-Kx // 32)], s_pad, Kx, m, block_shots=1,
            interpret=True, rank=jdz.rank)
        unsat = np.asarray(jnp.sum(jnp.where(~used[:, :m], s_red[:, :m], 0),
                                   axis=1))
        if Kx == jdz.K:
            depth = np.asarray(jnp.max(jnp.where(used, cf, -1), axis=1))
            assert np.array_equal(res["depth"], depth)
            assert np.array_equal(res["unsat"] != 0, unsat != 0)
            assert depth.max() > 96  # the prefix below cuts some shots
        else:
            assert res["prefix"][96] == int((unsat != 0).sum()) > 0


def test_margin_valid_fractions_match_jax(inputs, interpreted):
    """osd_margin_probe: the shots valid within each K of the grid, with
    JAX's own block sizing (validity does not depend on it)."""
    dz, jdz, m, n = inputs["dz"], inputs["jdz"], inputs["m"], inputs["n"]
    syn, llr, hard = _port(inputs)
    residual, order = scripts.residual_order(dz, syn, llr, hard)
    grid = (64, 256, 512)
    got = osd_margin_probe.valid_within(dz, order, residual, grid,
                                        torch.device("cpu"))
    _, s_pad, jorder = _jax_prep(inputs, 32)
    M_pad = s_pad.shape[1]
    for K in grid:
        Kc = min(n, K)
        packed = jax_osd._gather_pack(jdz.H, jorder[:, :Kc], Kc)
        HpT = jnp.pad(jnp.transpose(packed, (0, 2, 1)),
                      ((0, 0), (0, 0), (0, M_pad - m)))
        S = jax_osd_pallas.pick_block_shots(M_pad, HpT.shape[1])
        while B % S:
            S //= 2
        _, s_out, _, used, _ = interpreted(HpT, s_pad, Kc, m, block_shots=S,
                                           interpret=True, rank=jdz.rank)
        want = np.asarray(jnp.sum(jnp.where(~used[:, :m], s_out[:, :m], 0),
                                  axis=1) == 0)
        assert np.array_equal(got[K].numpy(), want), K
    assert not got[64].all() and got[512].sum() > got[64].sum()


def test_microbench_valid_counts_match_jax(inputs, interpreted):
    """osd_microbench: valid shots on the prefix alone and with the column
    basis appended, with and without the validity exit."""
    dz, jdz, m = inputs["dz"], inputs["jdz"], inputs["m"]
    syn, llr, hard = _port(inputs)
    residual, order = scripts.residual_order(dz, syn, llr, hard)
    got = osd_microbench.valid_counts(dz, order, residual, 0,
                                      torch.device("cpu"))
    hp, s_pad, _ = _jax_prep(inputs, jdz.K)
    R = int(jdz.basis_cols.shape[0])
    Rp = -(-R // 32) * 32
    Hb = jnp.pad(jnp.take(jdz.H.astype(jnp.uint8), jdz.basis_cols, axis=1),
                 ((0, 0), (0, Rp - R)))
    basis = jnp.broadcast_to(jax_osd._pack_columns(Hb)[None], (B, m, Rp // 32))
    basis = jnp.pad(jnp.transpose(basis, (0, 2, 1)),
                    ((0, 0), (0, 0), (0, hp.shape[2] - m)))
    for label, h, kk in (("prefix-only", hp, jdz.K),
                         ("prefix+basis", jnp.concatenate([hp, basis], 1),
                          jdz.K + R)):
        for ev in (False, True):
            _, s_red, _, used, _ = interpreted(h, s_pad, kk, m, block_shots=8,
                                               interpret=True, rank=jdz.rank,
                                               exit_on_valid=ev)
            want = int(jnp.sum(jnp.sum(jnp.where(~used[:, :m], s_red[:, :m],
                                                 0), axis=1) == 0))
            assert got[(label, ev)][0] == want, (label, ev)
    assert got[("prefix-only", True)][0] > 0


@pytest.fixture
def at_3_cycles(tmp_path, monkeypatch):
    """Matrices cached in a temporary directory; each entry point's
    ``build`` at 3 cycles and [[72,12,6]] for its fixed code."""
    monkeypatch.chdir(tmp_path)
    build = functools.partial(scripts.build, cycles=CYCLES)
    for mod in (osd144_stage_ab, osd288_ab, osd288_probe, osd_margin_probe,
                osd_microbench):
        monkeypatch.setattr(mod, "build", build)
    for mod in (osd144_stage_ab, osd288_ab, osd288_probe):
        monkeypatch.setattr(mod, "CODE", CODE)
    monkeypatch.setattr(osd144_stage_ab, "STAGE1", (0, 128))
    monkeypatch.setattr(osd288_ab, "STAGE1", (0, 128))
    monkeypatch.setattr(osd288_ab, "MAX_ITERS", (5, 10))
    monkeypatch.setattr(osd288_probe, "PREFIXES", (128,))
    monkeypatch.setattr(osd_margin_probe, "K_GRID", (64, 512))


def test_osd_study_mains_on_cpu(at_3_cycles, capsys):
    cpu = ["--device", "cpu"]
    s144 = osd144_stage_ab.main(["16", "8"] + cpu)
    assert list(s144) == [0, 128]
    assert len({v[:3] for v in s144.values()}) == 1  # width-independent
    s288 = osd288_ab.main(["16"] + cpu)
    assert list(s288) == [5, 10] and all(len(v) == 2 for v in s288.values())
    probe = osd288_probe.main(["16", "8"] + cpu)
    assert list(probe) == ["flooding-f32 (K1)", "layered-f32 (K3)"]
    assert all(len(r["depth"]) == 16 for r in probe.values())
    margin = osd_margin_probe.main([CODE, "0.006", "16", "1"] + cpu)
    assert set(margin["valid_frac"]) == {64, 512}
    micro = osd_microbench.main([CODE, "0.006", "16"] + cpu)
    assert micro["prefix-only_valid-exit_valid"] == \
        micro["prefix-only_full-scan_valid"]
    assert micro["osd_batch_ms"] > 0
    assert list(micro["prefix_ms"]) == list(PREFIXES) + ["readout"]
    out = capsys.readouterr().out
    assert out.count("exit depth: mean=") == 2
    assert out.count("delta-sum") == 2 + 4


def test_bp_lift_bench_main_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rows = bp_lift_bench.main([CODE, "0.006", "16", "6", "--device", "cpu"])
    assert [(r["decoder"], r["msg"]) for r in rows] == [
        ("generic", "f32"), ("lifted", "f32"), ("generic", "bf16"),
        ("lifted", "bf16"), ("K1", "f32")]
    conv = {(r["decoder"], r["msg"]): r["converged"] for r in rows}
    # float32 min-sum on the same syndromes: every decoder agrees
    assert conv[("generic", "f32")] == conv[("lifted", "f32")] == \
        conv[("K1", "f32")]
    assert all(r["ms"] > 0 and r["ms_per_iter"] > 0 for r in rows)
