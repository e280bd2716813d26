"""The port's shot mesh (qldpc_tpu_torch/parallel/mesh.py) on the CPU.

A mesh of one shard must reproduce run_simulation without a mesh, bit for
bit, at the numbers the engine gave before the mesh existed; the counts of
a sharded round must equal its flags' sums; the stopping rule must hold
under two shards; and two real processes in one gloo group, one shard each, must reproduce one
process holding two shards: under dynamical alpha, under autoregressive
calibration (the broadcast sequences identical on both ranks, and shown to
take effect on a rank whose own fit was replaced), and for a multi-code
run. The file imports no JAX (test_torch_mesh_jax.py holds the mesh
against JAX's ``shard_rounds``), so the spawned processes load only
PyTorch.
"""
import numpy as np
import pytest
import torch

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.ops import calibrate as tcal
from qldpc_tpu_torch.ops.bp import alpha_schedule
from qldpc_tpu_torch.parallel import engine as tengine
from qldpc_tpu_torch.parallel import mesh as tmesh
from qldpc_tpu_torch.scripts import multihost_smoke as mh

torch.set_num_threads(1)

FLAG_KEYS = ("z_conv", "x_conv", "z_err", "x_err", "z_rankdef", "x_rankdef",
             "any_err")
COUNTED = ("any_err", "z_err", "x_err", "z_rankdef", "x_rankdef")


def _bb_kwargs(code):
    return dict(ell=code.ell, m=code.m, a_x_powers=code.a_x_powers,
                a_y_powers=code.a_y_powers, b_y_powers=code.b_y_powers,
                b_x_powers=code.b_x_powers)


def _run(mesh=None, **kw):
    code = qt.get_code("[[72, 12, 6]]")
    kw = dict(dict(num_cycles=3, maxIter=8), **kw)
    return qt.run_simulation(code.Hx, code.Hz, code.Lx, code.Lz, 0.008,
                             verbose=False, device="cpu", mesh=mesh,
                             **_bb_kwargs(code), **kw)


@pytest.fixture(scope="module")
def round_setup():
    code = qt.get_code("[[72, 12, 6]]")
    circ = qt.SyndromeCircuit(code, num_cycles=2)
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, 0.01)
    seq = alpha_schedule("dynamical", 5)
    dz, dx = (tengine._make_basis(circ, M, b, seq, osd_order=2, device="cpu")
              for b in "ZX")
    return tengine.make_pooled_round_fn(dz, dx, circ.num_error_locs, 0.01,
                                        16, 5, 2, 2)


def test_distributed_init_noop_without_env(monkeypatch):
    monkeypatch.delenv("QLDPC_COORDINATOR", raising=False)
    assert tmesh.distributed_init_from_env() is False
    assert tmesh.shot_mesh() == tmesh.ShotMesh(n_shards=1, shards=(0,))
    monkeypatch.setenv("QLDPC_COORDINATOR", "localhost:1")
    monkeypatch.setenv("QLDPC_NUM_PROCESSES", "1")
    monkeypatch.setenv("QLDPC_PROCESS_ID", "0")
    with pytest.raises(ValueError, match="backend"):
        tmesh.distributed_init_from_env(backend="mpi")
    # the default backend is NCCL, which raises without a GPU instead of
    # falling back to gloo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        tmesh.distributed_init_from_env()
    assert not torch.distributed.is_initialized()


# (num_trials, logical_errors, z errors, x errors) that run_simulation gave
# on these settings before the mesh existed
@pytest.mark.parametrize("kw, want", [
    (dict(osd_order=2, target_logical_errors=20, max_trials=2000,
          batch_size=64, rounds_per_dispatch=2, base_seed=3),
     (30, 20, 17, 14)),
    (dict(osd_order=2, max_trials=200, batch_size=48, rounds_per_dispatch=1,
          base_seed=11), (200, 124, 85, 90)),
])
@pytest.mark.parametrize("mesh", [None, tmesh.ShotMesh(1, (0,))])
def test_one_shard_mesh_reproduces_run_simulation(kw, want, mesh):
    res = _run(mesh=mesh, **kw)
    n = res["num_trials"]
    got = (n, res["logical_errors"],
           round(res["z_logical_error_rate"] * n),
           round(res["x_logical_error_rate"] * n))
    assert got == want and res["num_devices"] == 1


def test_counts_equal_flag_sums(round_setup):
    """shard_rounds' counts equal the sums of the flags over every shard;
    the gather returns the flags unchanged in shard order; shard 0 draws
    the stream of a run without a mesh; the two shards' draws differ."""
    mesh = tmesh.shot_mesh(2)
    assert mesh.shards == (0, 1)
    out = tmesh.shard_rounds(round_setup, mesh)(tengine._gens(4, mesh,
                                                              "cpu"))
    for k in COUNTED:
        assert out[k].shape == (64,)
        assert out[f"{k}_count"] == int(out[k].sum()), k
    g = tmesh.gather_flags({k: out[k] for k in COUNTED})
    for k in COUNTED:
        assert np.array_equal(g[k], out[k].numpy()), k
    one = round_setup(torch.Generator().manual_seed(4))
    for k in FLAG_KEYS:
        assert torch.equal(out[k][:32], one[k]), k
    assert not torch.equal(out["any_err"][:32], out["any_err"][32:])
    assert out["any_err_count"] > 0


def test_stopping_under_two_shards():
    """max_trials not a multiple of the round (8 shots x 2 shards x 2
    rounds = 32): the run stops at exactly max_trials; a crossed target
    stops at exactly the target; a seed replays the run."""
    mesh = tmesh.shot_mesh(2)
    kw = dict(osd_order=0, batch_size=8, rounds_per_dispatch=2,
              base_seed=13, maxIter=5)
    res = _run(mesh=mesh, max_trials=50, **kw)
    assert res["num_trials"] == 50 and res["num_devices"] == 2
    runs = [_run(mesh=mesh, max_trials=2000, target_logical_errors=7, **kw)
            for _ in range(2)]
    assert runs[0]["logical_errors"] == 7
    assert runs[0]["num_trials"] < 2000
    assert (runs[0]["num_trials"], runs[0]["z_logical_error_rate"]) == \
        (runs[1]["num_trials"], runs[1]["z_logical_error_rate"])


# --- two processes in one gloo group --------------------------------------

CALIBRATED = dict(mh.CONFIG, maxIter=6, alpha_mode="alvarado-autoregressive",
                  alpha_estimation_trials=100)
MULTI = dict(codes=["[[72, 12, 6]]", "[[90, 8, 10]]"], error_rate=0.01,
             num_cycles=2, maxIter=5, osd_order=0, target_logical_errors=6,
             max_trials=400, batch_size=16, base_seed=9)


def _tamper(setter):
    """Replace this process's autoregressive fits by alpha 0.1 at every
    iteration; returns the list the calls are counted in."""
    calls = []
    fit = tcal.estimate_alpha_alvarado_autoregressive

    def replaced(*a, **kw):
        values, r2, fallbacks = fit(*a, **kw)
        calls.append(1)
        return np.full_like(values, 0.1), r2, fallbacks

    setter(tcal, "estimate_alpha_alvarado_autoregressive",
                     replaced)
    return calls


def _multi(device, mesh=None):
    res = qt.run_multi_code_simulation(verbose=False, device=device,
                                       mesh=mesh, **MULTI)
    return {name: mh.summary(r) for name, r in res.items()}


def _jobs(rank, device):
    out = dict(dynamical=mh.run_config(mh.CONFIG, device),
               calibrated=mh.run_config(CALIBRATED, device),
               multicode=_multi(device))
    calls = _tamper(setattr) if rank == 1 else []
    out["tampered"] = mh.run_config(CALIBRATED, device)
    out["tamper_calls"] = len(calls)
    return out


@pytest.fixture(scope="module")
def two_processes():
    return mh.spawn(_jobs, 2, ("cpu",))


@pytest.fixture(scope="module")
def two_shards():
    mesh = tmesh.shot_mesh(2)
    return dict(dynamical=mh.run_config(mh.CONFIG, "cpu", mesh),
                calibrated=mh.run_config(CALIBRATED, "cpu", mesh),
                multicode=_multi("cpu", mesh))


@pytest.mark.parametrize("job", ["dynamical", "calibrated"])
def test_two_processes_match_two_shards(two_processes, two_shards, job):
    single = two_shards[job]
    assert single["num_devices"] == 2
    assert single["logical_errors"] == mh.CONFIG["target_logical_errors"]
    for r in two_processes:
        assert r[job] == single, (job, r[job], single)
    if job == "calibrated":
        assert len(single["alpha_seq_z"]) == CALIBRATED["maxIter"]


def test_two_processes_multi_code(two_processes, two_shards):
    single = two_shards["multicode"]
    assert set(single) == set(MULTI["codes"])
    for r in two_processes:
        assert r["multicode"] == single
    for s in single.values():
        assert s["num_devices"] == 2
        assert s["logical_errors"] == 6 or s["num_trials"] == 400


def test_broadcast_takes_effect(two_processes, two_shards, monkeypatch):
    """Rank 1's own fits were replaced (alpha 0.1 everywhere); it still
    reports and decodes with rank 0's sequences: both ranks equal the
    untampered two-shard run. One process with the replaced fits decodes
    otherwise, so the comparison bites."""
    r0, r1 = two_processes
    assert (r0["tamper_calls"], r1["tamper_calls"]) == (0, 2)
    assert r0["tampered"] == r1["tampered"] == two_shards["calibrated"]
    _tamper(monkeypatch.setattr)
    alone = mh.run_config(CALIBRATED, "cpu", tmesh.shot_mesh(2))
    assert alone["alpha_seq_z"] == [np.float32(0.1)] * CALIBRATED["maxIter"]
    assert alone["num_trials"] != r1["tampered"]["num_trials"]
