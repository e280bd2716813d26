"""The port's pooled dispatch vs the JAX engine: layered BP and the other
eliminator generations.

One pooled dispatch of the port, fed the gate randoms JAX draws, must give
the per-shot flags of the JAX pooled round (Pallas kernels in interpret
mode): with ``bp_variant="layered"`` (JAX Pallas K3 vs the port's K3 plain
twin) and under ``QLDPC_OSD_KERNEL=2`` / ``3`` set on both packages (JAX
``_elim_kernel_v2`` / ``_v3`` vs the port's K4 / K5 plain twins). Each JAX
round is compiled once per configuration (compilation dominates the cost
of interpret mode), and its flags are shared by the tests that need them.
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
from qldpc_tpu_torch.convert import LIFT_STATICS, basis_from_jax
from qldpc_tpu_torch.ops import osd_cuda
from qldpc_tpu_torch.ops.sampler import sample_gate_randoms
from qldpc_tpu_torch.parallel import engine as tengine

torch.set_num_threads(1)

FLAG_KEYS = ("z_conv", "x_conv", "z_err", "x_err", "z_rankdef", "x_rankdef",
             "any_err")
POOL = dict(p=0.01, cycles=3, batch=32, rounds=2, maxIter=12, osd_order=2)


@pytest.fixture(scope="module")
def pool_setup():
    """JAX and port bundles of the small pooled configuration, the gate
    randoms of JAX key 3 (as the JAX pooled round draws them), and a cache
    of JAX flags per (bp_variant, eliminator version)."""
    c = POOL
    jcode = qldpc_tpu.get_code("[[72, 12, 6]]")
    jcirc = qldpc_tpu.SyndromeCircuit(jcode, num_cycles=c["cycles"])
    jM = qldpc_tpu.build_decoding_matrices(jcirc, jcode.Lx, jcode.Lz, c["p"])
    seq = alpha_schedule("dynamical", c["maxIter"])
    jdecs = [jengine._make_basis(jcirc, jM, b, seq, osd_order=c["osd_order"])
             for b in "ZX"]
    n_locs = jcirc.num_error_locs
    key = jengine.make_key(3)
    randoms = [tuple(torch.as_tensor(np.array(x)) for x in jax_randoms(
        jax.random.fold_in(key, i), c["batch"], n_locs, c["p"]))
        for i in range(c["rounds"])]
    code = qt.get_code("[[72, 12, 6]]")
    circ = qt.SyndromeCircuit(code, num_cycles=c["cycles"])
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, c["p"])
    tdecs = [tengine._make_basis(circ, M, b, seq, osd_order=c["osd_order"],
                                 device="cpu") for b in "ZX"]
    return dict(jdecs=jdecs, tdecs=tdecs, n_locs=n_locs, key=key,
                randoms=randoms, jax_flags={})


@pytest.fixture
def jax_flags(monkeypatch, pool_setup):
    """flags(bp_variant, version): the JAX pooled round's per-shot flags
    with both Pallas kernels in interpret mode, as the JAX package's own
    tests run them on the CPU."""
    def flags(bp_variant, version):
        cache = pool_setup["jax_flags"]
        if (bp_variant, version) not in cache:
            bp = jengine.decode_batch_lift_pallas
            elim = jax_osd_pallas.eliminate_blocks
            with monkeypatch.context() as mp:
                mp.setattr(jengine, "decode_batch_lift_pallas",
                           lambda *a, **k: bp(*a, **k, interpret=True))
                mp.setattr(jax_osd_pallas, "eliminate_blocks",
                           lambda *a, **k: elim(*a, **k, interpret=True))
                mp.setattr(jax_osd_pallas, "_KERNEL_VERSION", version)
                jax.clear_caches()
                c = POOL
                jdz, jdx = pool_setup["jdecs"]
                jfn = jengine.make_pooled_round_fn(
                    jdz, jdx, pool_setup["n_locs"], c["p"], c["batch"],
                    c["maxIter"], c["osd_order"], c["rounds"],
                    use_pallas=True, bp_variant=bp_variant)
                cache[bp_variant, version] = {
                    k: np.asarray(v) for k, v in
                    jax.jit(jfn)(pool_setup["key"], jdz, jdx).items()}
            jax.clear_caches()
        return cache[bp_variant, version]
    return flags


def _port_flags(setup, bp_variant, decs=None):
    c = POOL
    dz, dx = decs or setup["tdecs"]
    fn = tengine.make_pooled_round_fn(
        dz, dx, setup["n_locs"], c["p"], c["batch"], c["maxIter"],
        c["osd_order"], c["rounds"], bp_variant=bp_variant)
    return fn(None, randoms=setup["randoms"])


def _assert_flags_equal(got, want):
    # the port's round adds its OSD overflow flag; no slice overflowed
    assert set(got) == set(FLAG_KEYS) | {"osd_overflow"}
    assert not got["osd_overflow"].any()
    for k in FLAG_KEYS:
        assert got[k].shape == (POOL["rounds"] * POOL["batch"],), k
        assert np.array_equal(got[k].numpy(), want[k]), k
    # the comparison bites: some shots fail BP, some decode wrongly
    assert not want["z_conv"].all() and want["any_err"].any()


@pytest.mark.parametrize("bp_variant, version", [
    ("layered", 1), ("minsum", 2), ("minsum", 3)])
def test_pooled_dispatch_matches_jax(monkeypatch, pool_setup, jax_flags,
                                     bp_variant, version):
    """The layered schedule (K3's twin) and the alternative eliminators
    (K4's twin under QLDPC_OSD_KERNEL=2, K5's under 3) give the JAX pooled
    round's flags shot for shot."""
    want = jax_flags(bp_variant, version)
    monkeypatch.setattr(osd_cuda, "_KERNEL_VERSION", version)
    _assert_flags_equal(_port_flags(pool_setup, bp_variant), want)


@pytest.mark.parametrize("version", [2, 3])
def test_layered_dispatch_under_each_eliminator(monkeypatch, pool_setup,
                                                jax_flags, version):
    """Per-shot OSD outputs do not depend on the eliminator generation, so
    the layered dispatch through K4's or K5's twin keeps the JAX layered
    round's flags."""
    want = jax_flags("layered", 1)
    monkeypatch.setattr(osd_cuda, "_KERNEL_VERSION", version)
    _assert_flags_equal(_port_flags(pool_setup, "layered"), want)


def test_layered_dispatch_from_converted_bundles(pool_setup, jax_flags):
    """JAX decode bundles carried across with ``basis_from_jax`` drive the
    layered dispatch to the JAX flags, as the port's own bundles do."""
    decs = []
    for jdec in pool_setup["jdecs"]:
        g, mp, tg = jdec.lifted, jdec.maps, jdec.graph
        arrays = dict(
            sel=mp.sel, gate_loc=mp.gate_loc,
            A_loc=np.asarray(mp.A_loc, np.float32),
            prior_grid=g.prior_grid, slot_mask=g.slot_mask, cmask=g.cmask,
            out_gather=g.out_gather, residual=g.residual,
            row_cols=tg.row_cols, row_mask=tg.row_mask,
            col_edges=tg.col_edges, col_mask=tg.col_mask, H=jdec.H,
            H_logical=np.asarray(jdec.H_logical, np.float32),
            logical_pack=jdec.logical_pack, prior=jdec.prior,
            alpha_seq=jdec.alpha_seq, basis_cols=jdec.basis_cols)
        meta = dict(num_syn=mp.num_syn, k=mp.k, K=jdec.K,
                    num_test=jdec.num_test, rank=jdec.rank,
                    **{k: getattr(g, k) for k in LIFT_STATICS})
        decs.append(basis_from_jax({k: np.asarray(v)
                                    for k, v in arrays.items()}, meta,
                                   device="cpu"))
    _assert_flags_equal(_port_flags(pool_setup, "layered", decs),
                        jax_flags("layered", 1))


def _bb_kwargs(code):
    return dict(ell=code.ell, m=code.m, a_x_powers=code.a_x_powers,
                a_y_powers=code.a_y_powers, b_y_powers=code.b_y_powers,
                b_x_powers=code.b_x_powers)


def test_layered_run_simulation_converges_more():
    """run_simulation(bp_variant="layered") runs end to end on the CPU, and
    on the same randoms its BP converges at least as many shots as
    flooding (the JAX package's claim for the schedule)."""
    code = qt.get_code("[[72, 12, 6]]")
    res = qt.run_simulation(code.Hx, code.Hz, code.Lx, code.Lz, 0.01,
                            num_cycles=3, maxIter=8, osd_order=0,
                            max_trials=128, batch_size=64, base_seed=5,
                            bp_variant="layered", verbose=False,
                            device="cpu", **_bb_kwargs(code))
    assert res["num_trials"] == 128 and res["osd_rank_deficient_shots"] == 0
    assert 0.0 < res["logical_error_rate"] < 1.0
    circ = qt.SyndromeCircuit(code, num_cycles=3)
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, 0.01)
    seq = alpha_schedule("dynamical", 8)
    dz, dx = (tengine._make_basis(circ, M, b, seq, device="cpu")
              for b in "ZX")
    randoms = sample_gate_randoms(torch.Generator().manual_seed(0), 128,
                                  circ.num_error_locs, 0.01)
    conv = {}
    for variant in ("minsum", "layered"):
        fn = tengine.make_round_fn(dz, dx, circ.num_error_locs, 0.01, 128, 8,
                                   0, bp_variant=variant)
        out = fn(None, randoms=randoms)
        conv[variant] = int(out["z_conv"].sum() + out["x_conv"].sum())
    assert conv["layered"] >= conv["minsum"]
