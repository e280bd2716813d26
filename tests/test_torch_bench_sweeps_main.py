"""The port's bench-sweep entry points end to end on the CPU, and their
remaining rounds against JAX.

Each ``main`` of qldpc_tpu_torch/scripts/{multicode_bench,pooled_ab,
maxiter_sweep,bench288_sweep,scaling_bench}.py runs to its end with
``--device cpu`` at [[72,12,6]] (3 cycles: the tests wrap each module's
``build``) and prints the JAX script's result lines. multicode_bench's
dispatch, fed the draws JAX makes for each round and code
(``fold_in(fold_in(key, r), i)``), gives exactly the per-code flags of
JAX's ``make_multi_code_pooled_round_fn``, and pooled_ab's ``scanned``
schedule those of JAX's ``make_scanned_round_fn``; both JAX rounds run as
the JAX package's own CPU tests run them, through its XLA path (its plain
reference of the Pallas kernels; test_torch_bench_sweeps.py holds the
pooled round against the kernels in interpret mode). scaling_bench's
round over 1 and 2 shards gives the one-shard flags, shard for shard.
"""
import functools
import json

import numpy as np
import pytest
import torch

import jax

import qldpc_tpu
from qldpc_tpu.ops.bp import alpha_schedule
from qldpc_tpu.ops.sampler import sample_gate_randoms as jax_randoms
from qldpc_tpu.parallel import engine as jengine

from qldpc_tpu_torch import scripts
from qldpc_tpu_torch.ops.sampler import sample_gate_randoms
from qldpc_tpu_torch.scripts import (bench288_sweep, maxiter_sweep,
                                     multicode_bench, pooled_ab,
                                     scaling_bench)

torch.set_num_threads(1)

FLAG_KEYS = ("z_conv", "x_conv", "z_err", "x_err", "z_rankdef", "x_rankdef",
             "any_err")
CODE = "[[72, 12, 6]]"
P, CYCLES, BATCH, ROUNDS, MAXITER, OSD_ORDER = 0.01, 3, 8, 2, 5, 2


@pytest.fixture
def at_3_cycles(tmp_path, monkeypatch):
    """Matrices cached in a temporary directory; every entry point's
    ``build`` at 3 cycles."""
    monkeypatch.chdir(tmp_path)
    build = functools.partial(scripts.build, cycles=CYCLES)
    for mod in (pooled_ab, maxiter_sweep, bench288_sweep, scaling_bench):
        monkeypatch.setattr(mod, "build", build)
    monkeypatch.setattr(multicode_bench, "build_specs", functools.partial(
        multicode_bench.build_specs, cycles=CYCLES))
    monkeypatch.setattr(bench288_sweep, "CODE", CODE)
    monkeypatch.setattr(multicode_bench, "CODES", (CODE, CODE))


def _jax_bases(seq):
    jcode = qldpc_tpu.get_code(CODE)
    jcirc = qldpc_tpu.SyndromeCircuit(jcode, num_cycles=CYCLES)
    jM = qldpc_tpu.build_decoding_matrices(jcirc, jcode.Lx, jcode.Lz, P)
    return [jengine._make_basis(jcirc, jM, b, seq, osd_order=OSD_ORDER)
            for b in "ZX"], jcirc.num_error_locs


def _draws(key, n_locs):
    return tuple(torch.as_tensor(np.array(x))
                 for x in jax_randoms(key, BATCH, n_locs, P))


def _same_flags(got, want, rows=slice(None)):
    for k in FLAG_KEYS:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])[rows]), k


def test_multicode_dispatch_matches_jax(at_3_cycles):
    seq = alpha_schedule("dynamical", MAXITER)
    (jdz, jdx), n_locs = _jax_bases(seq)
    jspec = dict(dec_z=jdz, dec_x=jdx, n_locs=n_locs, error_rate=P,
                 batch=BATCH, maxIter=MAXITER, osd_order=OSD_ORDER)
    jfn = jengine.make_multi_code_pooled_round_fn([jspec, jspec], ROUNDS)
    key = jengine.make_key(9)
    want = jax.device_get(jax.jit(jfn)(key, [(jdz, jdx)] * 2))
    randoms = [[_draws(jax.random.fold_in(jax.random.fold_in(key, r), i),
                       n_locs) for r in range(ROUNDS)] for i in range(2)]
    specs = multicode_bench.build_specs(multicode_bench.CODES, P, BATCH,
                                        MAXITER, OSD_ORDER, "cpu")
    got = multicode_bench.make_dispatch(specs, ROUNDS)([None, None],
                                                          randoms=randoms)
    assert len(got) == 2
    for g, w in zip(got, want):
        _same_flags(g, w)
    assert multicode_bench.ler_sanity(got) == [
        round(float(np.asarray(w["any_err"]).mean()), 4) for w in want]
    assert not np.asarray(want[0]["z_conv"]).all()
    # one round a dispatch: each code's first round, on the same draws
    one = multicode_bench.make_dispatch(specs, 1)(
        [None, None], randoms=[r[0] for r in randoms])
    for g, w in zip(one, want):
        _same_flags(g, w, slice(None, BATCH))


def test_scanned_schedule_matches_jax(at_3_cycles):
    seq = alpha_schedule("dynamical", MAXITER)
    (jdz, jdx), n_locs = _jax_bases(seq)
    jfn = jengine.make_scanned_round_fn(
        jengine.make_round_fn(jdz, jdx, n_locs, P, BATCH, MAXITER,
                              OSD_ORDER), ROUNDS)
    key = jengine.make_key(4)
    want = jax.device_get(jax.jit(jfn)(key, jdz, jdx))
    randoms = [_draws(jax.random.fold_in(key, r), n_locs)
               for r in range(ROUNDS)]
    circ, _M, decs = scripts.build(CODE, P, MAXITER, OSD_ORDER, "cpu",
                                   cycles=CYCLES)
    fns = pooled_ab.make_config_fns(["scanned", "pooled"], *decs,
                                    circ.num_error_locs, P, BATCH, ROUNDS,
                                    MAXITER, OSD_ORDER)
    for fn in fns.values():
        got = fn(None, randoms=randoms)
        _same_flags(got, want)
        assert pooled_ab.round_counts(got) == pooled_ab.round_counts(want)


def test_scaling_shards_give_the_one_shard_flags(at_3_cycles):
    fn = scaling_bench.make_round(CODE, BATCH, "cpu")
    one, gens1 = scaling_bench.sharded_round(fn, 1, "cpu")
    two, gens2 = scaling_bench.sharded_round(fn, 2, "cpu")
    assert len(gens1) == 1 and len(gens2) == 2
    circ, _M, _ = scripts.build(CODE, scaling_bench.P, scaling_bench.MAX_ITER,
                                scaling_bench.OSD_ORDER, "cpu",
                                cycles=CYCLES, which="")
    g = torch.Generator().manual_seed(3)
    draws = [sample_gate_randoms(g, BATCH, circ.num_error_locs,
                                 scaling_bench.P) for _ in range(2)]
    alone = [fn(None, randoms=d) for d in draws]
    got1 = one([None], randoms=draws[:1])
    got2 = two([None, None], randoms=draws)
    for k in FLAG_KEYS:
        assert torch.equal(got1[k], alone[0][k]), k
        assert torch.equal(got2[k], torch.cat([a[k] for a in alone])), k
    assert int(got2["any_err_count"]) == int(got2["any_err"].sum())
    assert got2["any_err"].any() and not got2["z_conv"].all()


def test_multicode_bench_main_on_cpu(at_3_cycles, capsys):
    out = multicode_bench.main(["4", "2", "0", "--windows", "1", "--device",
                                "cpu"])
    printed = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert set(printed) >= {"metric", "p", "batch_per_code",
                            "rounds_per_dispatch", "shots_per_sec_per_code",
                            "shots_per_sec_combined", "ler_sanity"}
    assert printed["metric"] == "multi_code_single_launch_[[72]]+[[72]]"
    assert out["shots_per_sec_combined"] == pytest.approx(
        2 * out["shots_per_sec_per_code"], abs=0.11)
    assert len(out["ler_sanity"]) == 2 and out["batch_per_code"] == 4
    assert multicode_bench.metric_name(
        ("[[90, 8, 10]]", "[[108, 8, 10]]")) == \
        "multi_code_single_launch_[[90]]+[[108]]"


def test_pooled_ab_main_on_cpu(at_3_cycles, capsys):
    out = pooled_ab.main(["--code", CODE, "--p", "0.006", "--batch", "4",
                          "--rpd", "2", "--maxiter", "4", "--seconds", "0",
                          "--reps", "1", "--windows", "1", "--configs",
                          "scanned", "pooled", "pooled@c4", "--device",
                          "cpu"])
    lines = capsys.readouterr().out.splitlines()
    printed = json.loads(lines[-1])
    assert set(printed) >= {"config", "best_shots_per_sec",
                            "bp_unconverged_frac"}
    assert printed["best_shots_per_sec"] == out["best_shots_per_sec"]
    assert all(v > 0 for v in out["best_shots_per_sec"].values())
    # one seed for every configuration: the same shots, the same share
    fracs = set(out["bp_unconverged_frac"].values())
    assert len(fracs) == 1 and 0 < fracs.pop() < 1
    assert sum(ln.startswith("rep0 ") for ln in lines) == 3
    assert sum("chunk" in ln for ln in lines) == 2


def test_maxiter_sweep_main_on_cpu(at_3_cycles, capsys):
    res = maxiter_sweep.main(["3", "6:layered", "--code", CODE, "--p",
                              "0.006", "--batch", "4", "--rpd", "2",
                              "--pooled", "--seconds", "0", "--device",
                              "cpu"])
    assert list(res) == ["3:minsum", "6:layered"]
    assert all(r["shots_per_sec"] > 0 for r in res.values())
    assert res["3:minsum"]["unconverged"] > res["6:layered"]["unconverged"]
    out = capsys.readouterr().out
    assert out.count("maxIter=3 minsum:") == 3
    assert "best-of-2 per config:" in out


def test_bench288_sweep_main_on_cpu(at_3_cycles, capsys):
    out = bench288_sweep.main(["--p", "0.006", "--seconds", "0",
                               "--windows", "1", "--configs", "4,4,2",
                               "4,6,1", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert set(printed) >= {"p", "results"} and printed["p"] == 0.006
    assert list(printed["results"]) == ["4,4,2", "4,6,1"]
    for r in out["results"].values():
        assert set(r) >= {"shots_per_sec", "bp_unconverged", "ler"}
        assert r["shots_per_sec"] > 0 and 0 <= r["ler"] <= 1


def test_scaling_bench_main_on_cpu(at_3_cycles, capsys):
    rows = scaling_bench.main(["--devices", "1", "2", "--batch", "4",
                               "--reps", "1", "--cpu"])
    assert [r["devices"] for r in rows] == [1, 2]
    assert rows[0]["efficiency"] == 1.0 and rows[1]["shots_per_sec"] > 0
    out = capsys.readouterr().out
    assert "decoded in turn by one process" in out
    assert out.count("weak-scaling efficiency") == 2
