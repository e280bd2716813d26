"""The port's bench sweeps (qldpc_tpu_torch/scripts/{pooled_ab,
maxiter_sweep,bench288_sweep}.py) against JAX's pooled round.

Every dispatch those entry points time, fed the gate randoms JAX draws for
each round (``fold_in(key, r)``), must give exactly the per-shot flags of
JAX's ``make_pooled_round_fn`` with both Pallas kernels in interpret mode,
computed once for the file; so do the statistics each entry point reports
from the flags (errors, converged shot-bases). Every ``pooled@cN`` gives
the same flags, and so does the unpooled ``scanned`` schedule. The file
holds the tests that share JAX's interpret-mode compile (about 30 s);
test_torch_bench_sweeps_main.py holds the entry points' ``main``, JAX's
scanned and multi-code rounds, and the shard counts of scaling_bench.
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
from qldpc_tpu_torch.scripts import bench288_sweep, maxiter_sweep, pooled_ab

torch.set_num_threads(1)

FLAG_KEYS = ("z_conv", "x_conv", "z_err", "x_err", "z_rankdef", "x_rankdef",
             "any_err")
CODE = "[[72, 12, 6]]"
P, CYCLES, BATCH, ROUNDS, MAXITER, OSD_ORDER = 0.01, 3, 8, 2, 5, 2


@pytest.fixture(scope="module")
def jax_pooled():
    """JAX's pooled dispatch with both Pallas kernels in interpret mode
    (as the JAX package's own tests run them on the CPU): its flags, the
    draws it made, and the port's two bases on the same matrices."""
    bp = jengine.decode_batch_lift_pallas
    elim = jax_osd_pallas.eliminate_blocks
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "decode_batch_lift_pallas",
                   lambda *a, **k: bp(*a, **k, interpret=True))
        mp.setattr(jax_osd_pallas, "eliminate_blocks",
                   lambda *a, **k: elim(*a, **k, interpret=True))
        jax.clear_caches()
        seq = alpha_schedule("dynamical", MAXITER)
        jcode = qldpc_tpu.get_code(CODE)
        jcirc = qldpc_tpu.SyndromeCircuit(jcode, num_cycles=CYCLES)
        jM = qldpc_tpu.build_decoding_matrices(jcirc, jcode.Lx, jcode.Lz, P)
        jdz, jdx = (jengine._make_basis(jcirc, jM, b, seq,
                                        osd_order=OSD_ORDER) for b in "ZX")
        n_locs = jcirc.num_error_locs
        jfn = jengine.make_pooled_round_fn(jdz, jdx, n_locs, P, BATCH,
                                           MAXITER, OSD_ORDER, ROUNDS,
                                           use_pallas=True)
        key = jengine.make_key(5)
        want = {k: np.asarray(v) for k, v in
                jax.jit(jfn)(key, jdz, jdx).items()}
        jax.clear_caches()
    randoms = [tuple(torch.as_tensor(np.array(x)) for x in jax_randoms(
        jax.random.fold_in(key, r), BATCH, n_locs, P))
        for r in range(ROUNDS)]
    code = qt.get_code(CODE)
    circ = qt.SyndromeCircuit(code, num_cycles=CYCLES)
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, P)
    decs = [tengine._make_basis(circ, M, b, seq, osd_order=OSD_ORDER,
                                device="cpu") for b in "ZX"]
    # the comparison bites: some shots fail BP, some decode wrongly
    assert not want["z_conv"].all() and want["any_err"].any()
    assert 0 < want["any_err"].sum() < len(want["any_err"])
    return want, randoms, decs, n_locs


def _same_flags(got, want, rows=slice(None)):
    for k in FLAG_KEYS:
        assert got[k].shape == want[k][rows].shape, k
        assert np.array_equal(got[k].numpy(), want[k][rows]), k


CONFIGS = ("scanned", "pooled", "pooled@c4", "pooled@c8", "pooled@c16")


def test_pooled_ab_configs_match_jax(jax_pooled):
    """Every schedule and OSD chunk pooled_ab times gives JAX's pooled
    flags, and so the same reported errors and unconverged share."""
    want, randoms, decs, n_locs = jax_pooled
    fns = pooled_ab.make_config_fns(CONFIGS, *decs, n_locs, P, BATCH,
                                    ROUNDS, MAXITER, OSD_ORDER)
    assert [pooled_ab.osd_chunk(c) for c in CONFIGS] == [None, None, 4, 8,
                                                         16]
    for cfg, fn in fns.items():
        got = fn(None, randoms=randoms)
        _same_flags(got, want)
        assert pooled_ab.round_counts(got) == pooled_ab.round_counts(want)
    assert pooled_ab.round_counts(want) == (
        int(want["any_err"].sum()),
        int(want["z_conv"].sum() + want["x_conv"].sum()))


@pytest.mark.parametrize("pooled, chunk", [(True, None), (True, 4),
                                           (False, None)])
def test_maxiter_sweep_dispatch_matches_jax(jax_pooled, pooled, chunk):
    want, randoms, decs, n_locs = jax_pooled
    fn = maxiter_sweep.make_fn(*decs, n_locs, P, BATCH, MAXITER, ROUNDS,
                               "minsum", pooled, chunk)
    got = fn(None, randoms=randoms)
    _same_flags(got, want)
    assert maxiter_sweep.conv_counts(got) == maxiter_sweep.conv_counts(want)
    assert maxiter_sweep.parse_configs(["20", "50:layered"],
                                       ["minsum", "tanh"]) == [
        (20, "minsum"), (20, "tanh"), (50, "layered")]


@pytest.mark.parametrize("rpd", [ROUNDS, 1])
def test_bench288_sweep_dispatch_matches_jax(jax_pooled, rpd):
    """A pooled configuration gives JAX's flags; a one-round one gives the
    first round's."""
    want, randoms, decs, n_locs = jax_pooled
    fn = bench288_sweep.make_fn(*decs, n_locs, P, BATCH, MAXITER, OSD_ORDER,
                                rpd)
    got = (fn(None, randoms=randoms) if rpd > 1
           else fn(None, randoms=randoms[0]))
    rows = slice(None, BATCH * rpd)
    _same_flags(got, want, rows)
    assert bench288_sweep.round_stats(got) == bench288_sweep.round_stats(
        {k: v[rows] for k, v in want.items()})
