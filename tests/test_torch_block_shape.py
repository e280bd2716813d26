"""The eliminators' block shape on the CPU: ``block_shots`` and
``smem_budget`` (qldpc_tpu_torch/ops/osd_cuda.py), ``pick_block_shots``,
``osd_batch``'s tail budget (``QLDPC_OSD_TAIL_SMEM_KB``, ops/osd.py), and
the entry points that set them (qldpc_tpu_torch/scripts/{
osd_blockshots_sweep,osd288_tailblock_ab,osd_panel_probe}.py).

On numpy-made posteriors and syndromes at [[72,12,6]] (3 cycles, basis Z;
tests/test_torch_osd_studies.py's): the plain versions accept and ignore
the block shape; ``pick_block_shots`` follows the plan's arithmetic; the
port's consumed outputs (reduced syndrome, validity, OSD-0 bits, logical
delta) equal those of the JAX package's ``eliminate_blocks`` at block_shots
1, 2 and 4 (its Pallas kernel in interpret mode, as its own tests run it),
and every output at 1, the one block shape whose exit is per shot as the
port's is; ``osd_batch`` gives the same outputs whatever the block shape
and tail budget, and they equal JAX's ``osd_batch`` under
``QLDPC_OSD_TAIL_MB`` 26 and 78; the panel-entry transform's bits equal the
JAX script's expression's and an integer XOR version's. Each entry point's
``main`` runs to its end with ``--device cpu``.
"""
import functools
import os

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
from qldpc_tpu_torch.ops import osd, osd_cuda
from qldpc_tpu_torch.scripts import (osd288_tailblock_ab,
                                     osd_blockshots_sweep, osd_panel_probe)

torch.set_num_threads(1)

CODE, CYCLES, P, B = "[[72, 12, 6]]", 3, 0.01, 32
PLAIN = {"K2": osd_cuda.eliminate_blocks_plain,
         "K4": osd_cuda.eliminate_blocks_fused_plain,
         "K5": osd_cuda.eliminate_blocks_plain}


@pytest.fixture(scope="module")
def inputs():
    """Both packages' Z decoder (OSD order 2) on the same matrices;
    syndromes, posteriors and hard decisions made with numpy."""
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
    syn = ((err.astype(np.int64) @ H.T.astype(np.int64)) % 2).astype(
        np.int8)
    flip = err & (rng.random((B, n)) < 0.5)
    llr = (dz.prior.numpy() * (1 + 0.3 * rng.standard_normal((B, n)))
           * np.where(flip, -1, 1)).astype(np.float32)
    hard = (llr < 0).astype(np.int8)
    t = torch.as_tensor
    residual, order = scripts.residual_order(dz, t(syn), t(llr), t(hard))
    return dict(jdz=jdz, dz=dz, syn=syn, llr=llr, hard=hard, m=m, n=n,
                residual=residual, order=order)


@pytest.fixture(scope="module")
def jax_elim():
    """JAX's eliminator in interpret mode, its outputs cached by block
    shape so the file compiles each shape once."""
    cache = {}

    def run(inp, S):
        if S not in cache:
            d, m = inp["jdz"], inp["m"]
            M_pad = -(-m // 128) * 128
            order = jnp.asarray(inp["order"].numpy())
            packed = jax_osd._gather_pack(d.H, order[:, :d.K], d.K,
                                          words_major=True)
            hp = jnp.pad(packed, ((0, 0), (0, 0), (0, M_pad - m)))
            s_pad = jnp.pad(jnp.asarray(inp["residual"].numpy()),
                            ((0, 0), (0, M_pad - m)))
            out = jax_osd_pallas.eliminate_blocks(
                hp, s_pad, d.K, m, block_shots=S, interpret=True,
                rank=d.rank)
            cache[S] = [np.asarray(x) for x in out]
        return cache[S]
    return run


def _port_elim(inp, **kw):
    """The port's eliminator (its plain version: CPU tensors) on G1's
    pack of the prefix, every output words-major."""
    dz, m = inp["dz"], inp["m"]
    Hp = osd_cuda.gather_pack(dz.col_index, inp["order"][:, :dz.K], dz.K)
    return [x.numpy() for x in osd_cuda.eliminate_blocks(
        Hp, inp["residual"], dz.K, m, rank=dz.rank, **kw)]


def _consumed(out, inp):
    """(reduced syndrome, valid, OSD-0 bits, logical delta) of an
    elimination's outputs (Hp, s_red, prow_of_col, used, colofrow)."""
    m, K = inp["m"], inp["dz"].K
    s_red, used, cf = out[1][:, :m], out[3][:, :m], out[4][:, :m]
    valid = np.where(used, 0, s_red).sum(1) == 0
    e0 = np.zeros((B, K + 1), np.int32)
    np.put_along_axis(e0, np.where(used, cf, K), s_red, axis=1)
    e0 = e0[:, :K]
    lp = inp["dz"].logical_pack.numpy()[inp["order"].numpy()[:, :K]]
    delta = np.bitwise_xor.reduce(np.where(e0 > 0, lp, 0), axis=1)
    return s_red, valid, e0, delta


@pytest.mark.parametrize("plain", sorted(set(PLAIN.values()),
                                         key=lambda f: f.__name__),
                         ids=lambda f: f.__name__)
def test_plain_versions_ignore_block_shape(inputs, plain):
    dz, m = inputs["dz"], inputs["m"]
    Hp = osd_cuda.columns_to_words(osd_cuda.gather_pack(
        dz.col_index, inputs["order"][:, :dz.K], dz.K), m)
    ref = plain(Hp, inputs["residual"], dz.K, m, rank=dz.rank,
                return_steps=True)
    for kw in (dict(block_shots=1), dict(block_shots=8, smem_budget=0),
               dict(smem_budget=1 << 20)):
        got = plain(Hp, inputs["residual"], dz.K, m, rank=dz.rank,
                    return_steps=True, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), kw


@pytest.mark.parametrize("kernel", ["K2", "K4", "K5"])
def test_wrappers_on_cpu_ignore_block_shape(inputs, kernel):
    """Each wrapper on CPU tensors runs its plain version whatever the
    block shape; K5's equals K2's."""
    dz, m = inputs["dz"], inputs["m"]
    wrapper = osd_cuda._ELIMINATORS[kernel]
    Hp = osd_cuda.gather_pack(dz.col_index, inputs["order"][:, :dz.K], dz.K)
    ref = wrapper(Hp, inputs["residual"], dz.K, m, rank=dz.rank)
    for S in (1, 3, 16):
        got = wrapper(Hp, inputs["residual"], dz.K, m, rank=dz.rank,
                      block_shots=S, smem_budget=4096 * S)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), S


def test_pick_block_shots_rule():
    assert osd_cuda.pick_block_shots(1008, 8) is None
    assert osd_cuda.pick_block_shots(1008, 8, kernel="K5") is None
    lim = osd_cuda._SMEM_LIMIT
    for kernel, spt, narrow in (("K2", 1, False), ("K4", 1, True),
                                ("K5", 2, True)):
        for M, W in ((180, 2), (1008, 8), (1008, 40), (1008, 70),
                     (2880, 24), (2880, 82)):
            tb = osd_cuda.team_bytes(M, W, kernel)
            assert tb == spt * 4 * 32 * W * (-(-M // 32) | 1)
            T = min(max(W // 2, 1), 16)
            warps = (512 if narrow and M > 1024 else 1024) // 32
            for budget, cap in ((None, 64), (lim, None), (0, None),
                                (tb, None), (3 * tb, 64), (10 ** 9, 2),
                                (None, 1)):
                S = osd_cuda.pick_block_shots(M, W, budget, cap, kernel)
                assert S >= 1 and S & (S - 1) == 0, (kernel, M, W, S)
                if cap is not None:
                    assert S <= cap
                b = lim if budget is None else min(budget, lim)
                teams = -(-S // spt)
                if b >= tb:  # shared memory: the teams' columns fit
                    assert teams * tb <= b and teams <= 8
                    assert teams * T <= warps
                    bigger = -(-2 * S // spt)
                    assert (cap is not None and 2 * S > cap) or \
                        bigger * tb > b or bigger > 8 or \
                        bigger * T > warps
                else:  # device-memory branch: one team, as JAX's floor
                    assert teams == 1
    # the shapes of the main path on the card (chip_smoke.py phase 25)
    assert osd_cuda.pick_block_shots(1008, 8, cap=64, kernel="K2") == 4
    assert osd_cuda.pick_block_shots(1008, 40, cap=64, kernel="K2") == 1
    assert osd_cuda.pick_block_shots(1008, 8, cap=64, kernel="K5") == 4
    assert osd_cuda.pick_block_shots(1008, 8, 0, kernel="K5") == 2
    assert osd_cuda.pick_block_shots(1008, 8, 10 ** 9, 64, "K2") == \
        osd_cuda.pick_block_shots(1008, 8, lim, 64, "K2")
    with pytest.raises(ValueError):
        osd_cuda.pick_block_shots(1008, 8, -1)


def test_tail_budget_variable(monkeypatch):
    monkeypatch.delenv(osd.TAIL_BUDGET_ENV, raising=False)
    assert osd.tail_smem_budget() is None
    monkeypatch.setenv(osd.TAIL_BUDGET_ENV, "48")
    assert osd.tail_smem_budget() == 48 * 1024
    assert osd.TAIL_BUDGET_ENV == "QLDPC_OSD_TAIL_SMEM_KB"


@pytest.mark.parametrize("S", [1, 2, 4])
def test_consumed_outputs_match_jax_block_shots(inputs, jax_elim, S):
    """JAX's eliminator at ``block_shots=S`` against the port's (which
    exits per shot whatever its block shape): the consumed outputs at
    every S, every output at S=1."""
    want = jax_elim(inputs, S)
    got = _port_elim(inputs, block_shots=S, smem_budget=S * 8192)
    for name, a, b in zip(("s_red", "valid", "e0", "delta"),
                          _consumed(got, inputs), _consumed(want, inputs)):
        assert np.array_equal(a, b), (S, name)
    assert _consumed(got, inputs)[1].any()
    if S == 1:
        m, W = inputs["m"], got[0].shape[1]
        assert np.array_equal(got[0].view(np.uint32),
                              want[0][:, :W, :m])
        assert np.array_equal(got[2], want[2])
        for i in (3, 4):
            assert np.array_equal(got[i], want[i][:, :m]), i


def _osd_port(inp, **kw):
    dz = inp["dz"]
    t = torch.as_tensor
    out = osd.osd_batch(dz.H, dz.HT, t(inp["syn"]), t(inp["llr"]),
                        t(inp["hard"]), K=dz.K, order=0, rank=dz.rank,
                        basis_cols=dz.basis_cols,
                        logical_pack=dz.logical_pack, return_solution=False,
                        col_index=dz.col_index, **kw)
    return [out[k].numpy() for k in ("logical_delta_packed", "valid",
                                     "rank_deficient")]


def test_osd_batch_block_shape_and_tail_budget_match_jax(inputs,
                                                         monkeypatch):
    """osd_batch (OSD-0, staged: K >= 512) under a patched
    pick_block_shots and under tail budgets of the default, one team and
    below one team: identical outputs, equal to JAX's osd_batch under
    QLDPC_OSD_TAIL_MB 26 and 78."""
    dz, jdz = inputs["dz"], inputs["jdz"]
    assert dz.K >= 512  # the staged scan: a tail launch runs
    monkeypatch.delenv(osd.TAIL_BUDGET_ENV, raising=False)
    ref = _osd_port(inputs)
    assert ref[1].any() and ref[0].any()
    seen = []
    orig = osd_cuda.pick_block_shots

    def patched(S):
        def pick(M, W, smem_budget=None, cap=None, kernel=None):
            seen.append((W, smem_budget))
            return S
        return pick
    for S in (1, 2, 4):
        monkeypatch.setattr(osd_cuda, "pick_block_shots", patched(S))
        got = _osd_port(inputs)
        assert all(np.array_equal(a, b) for a, b in zip(got, ref)), S
    monkeypatch.setattr(osd_cuda, "pick_block_shots", orig)
    # every site asked: stage 1, the tail and the basis rerun, no budget
    assert {W for W, _ in seen} >= {8, -(-dz.K // 32)}
    assert {b for _, b in seen} == {None}
    one_team = -(-osd_cuda.team_bytes(inputs["m"], -(-dz.K // 32)) // 1024)
    for kb in (one_team, 1):
        monkeypatch.setenv(osd.TAIL_BUDGET_ENV, str(kb))
        got = _osd_port(inputs)
        assert all(np.array_equal(a, b) for a, b in zip(got, ref)), kb
    monkeypatch.setenv(osd.TAIL_BUDGET_ENV, "1")
    monkeypatch.setattr(osd_cuda, "pick_block_shots", patched(2))
    seen.clear()
    _osd_port(inputs)
    assert (-(-dz.K // 32), 1024) in seen and (8, None) in seen

    elim = jax_osd_pallas.eliminate_blocks
    monkeypatch.setattr(jax_osd_pallas, "eliminate_blocks",
                        functools.partial(elim, interpret=True))
    try:
        for mb in (26, 78):
            monkeypatch.setenv("QLDPC_OSD_TAIL_MB", str(mb))
            jax.clear_caches()  # osd_batch reads the budget at its trace
            rr = jax_osd.osd_batch(
                jdz.H, jdz.HT_bf16, jnp.asarray(inputs["syn"]),
                jnp.asarray(inputs["llr"]), jnp.asarray(inputs["hard"]),
                K=jdz.K, order=0, num_test=0, use_pallas=True,
                rank=jdz.rank, basis_cols=jdz.basis_cols,
                logical_pack=jdz.logical_pack, return_solution=False)
            want = [np.asarray(rr[k]) for k in (
                "logical_delta_packed", "valid", "rank_deficient")]
            for a, b in zip(ref, want):
                assert np.array_equal(a.astype(np.int64),
                                      b.astype(np.int64)), mb
    finally:
        jax.clear_caches()


def _jax_transform(cur, Vw, cf):
    """The JAX script's apply_transform (scripts/osd_panel_probe.py), on
    numpy inputs."""
    cur, Vw, cf = jnp.asarray(cur), jnp.asarray(Vw), jnp.asarray(cf)
    Bx, _, M = cur.shape
    Pc = 128
    cols0 = jnp.arange(Pc, dtype=jnp.int32)
    bits = jnp.arange(32, dtype=jnp.int32)
    cu = ((cur.astype(jnp.int32)[:, :, None, :]
           >> bits[None, None, :, None]) & 1)
    cu = cu.reshape(Bx, Pc, M).transpose(0, 2, 1).astype(jnp.bfloat16)
    G = (cf[:, None, :] == cols0[None, :, None]).astype(jnp.bfloat16)
    piv = jnp.einsum("bpm,bmc->bpc", G, cu,
                     preferred_element_type=jnp.float32)
    Vu = ((Vw.astype(jnp.int32)[:, :, None, :]
           >> bits[None, None, :, None]) & 1)
    Vu = Vu.reshape(Bx, Pc, M).transpose(0, 2, 1).astype(jnp.bfloat16)
    delta = jnp.einsum("bmp,bpc->bmc", Vu, piv.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
    dbits = delta.astype(jnp.int32) & 1
    dw = (dbits.reshape(Bx, M, 4, 32) << bits[None, None, None, :])
    dw = dw.sum(axis=3).transpose(0, 2, 1)
    return np.asarray(cur ^ jax.lax.bitcast_convert_type(dw, jnp.uint32))


@pytest.mark.parametrize("shift", [0, 3])
def test_panel_transform_matches_jax_and_xor(shift):
    rng = np.random.default_rng(5)
    cur, Vw, cf = osd_panel_probe.transform_inputs(rng, 4, 256)
    cf = cf + shift
    want = _jax_transform(cur, Vw, cf)
    got = osd_panel_probe.apply_transform(
        torch.as_tensor(cur.view(np.int32)), torch.as_tensor(
            Vw.view(np.int32)), torch.as_tensor(cf)).numpy()
    plain = osd_panel_probe.transform_plain(cur.view(np.int32),
                                            Vw.view(np.int32), cf)
    assert np.array_equal(got.view(np.uint32), want)
    assert np.array_equal(plain, got)
    assert not np.array_equal(got.view(np.uint32), cur)  # it changed bits


@pytest.fixture
def at_3_cycles(tmp_path, monkeypatch):
    """Matrices cached in a temporary directory; the entry points' build
    at 3 cycles and [[72,12,6]] for their fixed codes, small batches."""
    monkeypatch.chdir(tmp_path)
    build = functools.partial(scripts.build, cycles=CYCLES)
    for mod in (osd_blockshots_sweep, osd288_tailblock_ab):
        monkeypatch.setattr(mod, "build", build)
    monkeypatch.setattr(osd_blockshots_sweep, "CODE", CODE)
    monkeypatch.setattr(osd_blockshots_sweep, "B", 32)
    monkeypatch.setattr(osd_blockshots_sweep, "CHUNK", 16)
    monkeypatch.setattr(osd_blockshots_sweep, "REPS", 1)
    monkeypatch.setattr(osd288_tailblock_ab, "REPS", 1)
    monkeypatch.setattr(osd_panel_probe, "REPS", 1)
    monkeypatch.delenv(osd.TAIL_BUDGET_ENV, raising=False)


def test_blockshots_sweep_main_on_cpu(at_3_cycles, capsys):
    res = osd_blockshots_sweep.main(["--device", "cpu"])
    assert list(res) == [1, 2, 4, 8]
    assert len({(r["delta_sum"], r["valid"]) for r in res.values()}) == 1
    assert all(r["taken"] is None for r in res.values())
    out = capsys.readouterr().out
    assert out.count("osd_batch 2x16 chunks, block_shots=") == 4
    assert "consumed outputs identical across block_shots" in out
    assert osd_cuda.pick_block_shots(1008, 8) is None  # restored


def test_tailblock_ab_main_on_cpu(at_3_cycles, capsys):
    res = osd288_tailblock_ab.main(["16", "8", "--budgets-kb", "1",
                                    "--code", CODE, "--device", "cpu"])
    one = res["one_team_kb"]
    assert list(res["best_ms"]) == ["default", f"{one}KB (one team)",
                                    "1KB"]
    assert all(v > 0 for v in res["best_ms"].values())
    out = capsys.readouterr().out
    assert "outputs identical across tail budgets" in out
    assert "tail block_shots None" in out and "tail block_shots 1" in out
    assert out.count("full osd_batch") == 3
    assert osd.TAIL_BUDGET_ENV not in os.environ


def test_panel_probe_main_on_cpu(at_3_cycles, capsys):
    res = osd_panel_probe.main(["8", "128", "--device", "cpu"])
    assert set(res) == {8, 16, 40, "transform_ms"}
    assert res[16]["scaling"] > 0 and res[40]["us_per_step"] > 0
    out = capsys.readouterr().out
    assert out.count("width scaling vs W=8") == 2
    assert "panel-entry transform (6 pairs = Q4 total)" in out
