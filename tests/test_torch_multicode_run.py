"""The port's multi-code path on its own: one pooled multi-code dispatch
([[72,12,6]] + [[90,8,10]]) must equal each code's own pooled dispatch on
the same generator seeds, and run_multi_code_simulation must stop every
code at its own crossing trial. test_torch_multicode.py holds the same
dispatch against JAX's.
"""
import logging

import numpy as np
import torch

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.ops.bp import alpha_schedule
from qldpc_tpu_torch.parallel import engine as tengine
from qldpc_tpu_torch.parallel import mesh as tmesh

from test_torch_multicode import (BATCH, CODES, FLAG_KEYS, MAXITER,
                                  OSD_ORDER, P, ROUNDS, _specs)

torch.set_num_threads(1)

# JAX's own multi-code test (tests/test_engine.py::test_run_multi_code_simulation)
RUN = dict(num_cycles=2, maxIter=5, osd_order=0, target_logical_errors=6,
           max_trials=400, batch_size=16, base_seed=9, verbose=False)


def test_multi_code_dispatch_equals_per_code_dispatches():
    """Each code's share of a pooled multi-code dispatch equals its own
    single-code pooled dispatch on a generator seeded alike; the one-round
    form is the one-round pool."""
    seq = alpha_schedule("dynamical", MAXITER)
    specs = _specs("torch", seq)
    multi = tengine.make_multi_code_pooled_round_fn(specs, ROUNDS)
    got = multi([tmesh.generator(5, 0, i, device="cpu") for i in range(2)])
    one_round = tengine.make_multi_code_round_fn(specs)(
        [tmesh.generator(5, 0, i, device="cpu") for i in range(2)])
    for i, sp in enumerate(specs):
        own = tengine.make_pooled_round_fn(
            sp["dec_z"], sp["dec_x"], sp["n_locs"], P, BATCH, MAXITER,
            OSD_ORDER, ROUNDS)(tmesh.generator(5, 0, i, device="cpu"))
        for k in FLAG_KEYS:
            assert torch.equal(got[i][k], own[k]), (i, k)
            assert torch.equal(one_round[i][k], own[k][:BATCH]), (i, k)
    assert not torch.equal(got[0]["any_err"][:BATCH],
                           got[1]["any_err"][:BATCH])


def _own_stream(name, i, target, max_trials, round_shots, base_seed):
    """A code's stopping point from its own stream alone: its pooled rounds
    on generator (base_seed, 0, i), flags read in shot order."""
    code = qt.get_code(name)
    circ = qt.SyndromeCircuit(code, num_cycles=RUN["num_cycles"])
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, P)
    seq = alpha_schedule("dynamical", RUN["maxIter"])
    dz, dx = (tengine._make_basis(circ, M, b, seq, osd_order=0, device="cpu")
              for b in "ZX")
    fn = tengine.make_round_fn(dz, dx, circ.num_error_locs, P, round_shots,
                               RUN["maxIter"], 0)
    gen = tmesh.generator(base_seed, 0, i, device="cpu")
    flags = np.zeros(0, bool)
    while flags.sum() < target and flags.size < max_trials:
        flags = np.concatenate([flags, fn(gen)["any_err"].numpy()])
    cum = np.cumsum(flags)
    n = (int(np.searchsorted(cum, target)) + 1 if cum[-1] >= target
         else max_trials)
    return n, int(cum[n - 1]), -(-n // round_shots)


def test_run_multi_code_simulation_stops_each_code(caplog):
    """JAX's multi-code configuration: every code stops exactly at its
    target (or max_trials), at the trial its own stream crosses it, though
    [[72]] finishes a round before [[90]] (its later shares are discarded,
    and logged); a seed replays the run."""
    with caplog.at_level(logging.INFO, logger=tengine.__name__):
        res = qt.run_multi_code_simulation(list(CODES), P, device="cpu",
                                           **dict(RUN, verbose=True))
    again = qt.run_multi_code_simulation(list(CODES), P, device="cpu", **RUN)
    assert set(res) == set(CODES)
    rounds = {}
    for i, name in enumerate(CODES):
        r = res[name]
        assert r["logical_errors"] == 6 or r["num_trials"] == 400, (name, r)
        n, errs, rounds[name] = _own_stream(name, i, 6, 400, 16, 9)
        assert (r["num_trials"], r["logical_errors"]) == (n, errs), name
        assert (again[name]["num_trials"], again[name]["logical_errors"]) \
            == (n, errs)
        assert r["num_devices"] == 1 and r["combined_shots_per_sec"] > 0
        assert set(r) == {
            "logical_error_rate", "z_logical_error_rate",
            "x_logical_error_rate", "num_trials", "logical_errors",
            "shots_per_sec", "combined_shots_per_sec", "elapsed_sec",
            "num_devices", "osd_rank_deficient_shots", "alpha_z", "alpha_x"}
    assert rounds[CODES[0]] < rounds[CODES[1]]
    assert "[[72, 12, 6]] reached its target" in caplog.text
