"""The port's code-capacity path vs the JAX package's.

``_code_capacity_round`` on fixed numpy error draws against JAX's round
body (``decode_batch`` + ``osd_batch`` composed as
``qldpc_tpu/parallel/code_capacity.py`` does; OSD through the XLA path and
through the Pallas eliminator in interpret mode): ``fail`` and ``conv``
exact, for the Steane code and the [[72,12,6]] ``Hz`` at p=0.05. JAX's two
Steane tests re-run on the port. A two-shard mesh counts ``fail`` and
``conv`` (the mesh's count keys), and a truncated final round takes the
per-shot prefix.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qldpc_tpu.models import gf2 as jgf2
from qldpc_tpu.ops import bp as jbp
from qldpc_tpu.ops import osd as josd
from qldpc_tpu.ops import osd_pallas as jax_osd_pallas

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.parallel.code_capacity import (_code_capacity_round,
                                                    capacity_decoder,
                                                    run_code_capacity,
                                                    steane_code)
from qldpc_tpu_torch.parallel.mesh import (gather_flags, generator,
                                           shard_rounds, shot_mesh)

torch.set_num_threads(1)


def _jax_round(e, H, L, p, maxIter, osd_order, use_pallas):
    """The JAX package's code-capacity round body on the draws ``e``."""
    H = (np.asarray(H) % 2).astype(np.uint8)
    m, n = H.shape
    graph = jbp.TannerGraph.from_dense(H)
    HT = jnp.asarray(H.T.astype(np.float32), dtype=jnp.bfloat16)
    prior = jnp.full((n,), float(np.log((1 - p) / p)), jnp.float32)
    seq = jnp.asarray(jbp.alpha_schedule("dynamical", maxIter, 1.0))
    e = jnp.asarray(e)
    syn = (jnp.dot(e.astype(jnp.bfloat16), HT,
                   preferred_element_type=jnp.float32)
           .astype(jnp.int32) & 1).astype(jnp.int8)
    bp = jbp.decode_batch(graph, syn, prior, seq, maxIter)
    osd = josd.osd_batch(jnp.asarray(H), HT, syn, bp["values"], bp["hard"],
                         K=josd.choose_K(m, n), order=osd_order,
                         num_test=(osd_order + 10) if osd_order else 0,
                         use_pallas=use_pallas, rank=jgf2.rank_fast(H),
                         basis_cols=jnp.asarray(jgf2.column_basis(H)))
    sol = jnp.where(bp["converged"][:, None], bp["hard"], osd["solution"])
    resid = sol.astype(jnp.int32) ^ e.astype(jnp.int32)
    if L is None:
        fail = jnp.any(resid != 0, axis=1)
    else:
        L_j = jnp.asarray((np.asarray(L) % 2).T.astype(np.float32),
                          dtype=jnp.bfloat16)
        act = (jnp.dot(resid.astype(jnp.bfloat16), L_j,
                       preferred_element_type=jnp.float32)
               .astype(jnp.int32) & 1)
        fail = jnp.any(act != 0, axis=1)
    return dict(fail=np.asarray(fail), conv=np.asarray(bp["converged"]))


def _case(name):
    if name == "steane":
        _, Hz, Lx, _ = steane_code()
        return Hz, Lx, 256, 1
    code = qt.get_code("[[72, 12, 6]]")
    return code.Hz, code.Lx, 128, 2


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", ["steane", "[[72,12,6]]"])
@pytest.mark.parametrize("with_L", [True, False])
def test_round_matches_jax(monkeypatch, name, use_pallas, with_L):
    if use_pallas:  # the JAX eliminator in interpret mode, on the CPU
        elim = jax_osd_pallas.eliminate_blocks
        monkeypatch.setattr(jax_osd_pallas, "eliminate_blocks",
                            lambda *a, **k: elim(*a, **k, interpret=True))
        jax.clear_caches()
    H, L, B, osd_order = _case(name)
    L = L if with_L else None
    p, maxIter = 0.05, 20
    e = np.random.default_rng(7).random((B, H.shape[1])) < p
    want = _jax_round(e, H, L, p, maxIter, osd_order, use_pallas)
    cc = capacity_decoder(H, p, L, maxIter, osd_order, device="cpu")
    got = _code_capacity_round(torch.as_tensor(e), cc)
    for key in ("fail", "conv"):
        assert got[key].dtype == torch.bool
        assert np.array_equal(got[key].numpy(), want[key]), key
    assert want["fail"].any()
    if name != "steane":  # BP fails on some shots there: OSD decides them
        assert 0 < want["conv"].sum() < B


def test_steane_low_p_corrects_single_errors():
    Hx, Hz, Lx, Lz = steane_code()
    assert Lx.shape == (1, 7)
    res = run_code_capacity(Hz, 0.01, num_shots=4000, L=Lx, maxIter=30,
                            osd_order=1, batch_size=500, base_seed=1,
                            device="cpu")
    # distance 3: LER ~ 21 p^2 ~ 2e-3 at p=0.01; well below p
    assert res["logical_error_rate"] < 0.01
    assert res["converged_rate"] > 0.9
    assert res["num_shots"] == 4000


def test_block_error_without_logicals():
    Hx, Hz, Lx, Lz = steane_code()
    res = run_code_capacity(Hz, 0.02, num_shots=2000, maxIter=20,
                            batch_size=250, base_seed=2, device="cpu")
    # block error rate (any miscorrection) >= logical error rate
    res_l = run_code_capacity(Hz, 0.02, num_shots=2000, L=Lx, maxIter=20,
                              batch_size=250, base_seed=2, device="cpu")
    assert res["logical_error_rate"] >= res_l["logical_error_rate"]


def test_steane_matches_jax_code():
    """The port's Steane matrices equal the JAX package's."""
    from qldpc_tpu.parallel.code_capacity import steane_code as jsteane
    for a, b in zip(steane_code(), jsteane()):
        assert np.array_equal(a, b)


def _flags_by_hand(H, L, p, B, n_shards, rounds, base_seed=5):
    """Each shard's draws from its own generator, decoded round by round
    and concatenated in shard order, as the mesh lays them out."""
    cc = capacity_decoder(H, p, L, 20, 1, device="cpu")
    gens = [generator(base_seed, s, device="cpu") for s in range(n_shards)]
    out = {"fail": [], "conv": []}
    for _ in range(rounds):
        for g in gens:
            e = torch.rand((B, H.shape[1]), generator=g) < p
            f = _code_capacity_round(e, cc)
            for k in out:
                out[k].append(f[k])
    return {k: torch.cat(v).numpy() for k, v in out.items()}


def test_two_shard_mesh_counts_fail_and_conv():
    """shard_rounds counts the code-capacity flags (fail, conv) over a
    two-shard mesh; the counts equal the gathered flags' sums."""
    _, Hz, Lx, _ = steane_code()
    p, B = 0.08, 128
    cc = capacity_decoder(Hz, p, Lx, 20, 1, device="cpu")
    sharded = shard_rounds(
        lambda g, randoms=None: _code_capacity_round(
            torch.rand((B, 7), generator=g) < p, cc), shot_mesh(2))
    out = sharded([generator(5, s, device="cpu") for s in range(2)])
    assert set(out) == {"fail", "conv", "fail_count", "conv_count"}
    g = gather_flags({k: out[k] for k in ("fail", "conv")})
    assert g["fail"].shape == (2 * B,)
    assert out["fail_count"] == int(g["fail"].sum()) > 0
    assert out["conv_count"] == int(g["conv"].sum())
    want = _flags_by_hand(Hz, Lx, p, B, 2, 1)
    assert np.array_equal(g["fail"], want["fail"])
    assert np.array_equal(g["conv"], want["conv"])


def test_truncated_final_round_takes_prefix():
    """1100 shots over two shards of 256: two full rounds read the counts,
    the third is cut at 76 shots of shard order."""
    _, Hz, Lx, _ = steane_code()
    p, B, n = 0.08, 256, 1100
    res = run_code_capacity(Hz, p, num_shots=n, L=Lx, maxIter=20,
                            osd_order=1, batch_size=B, base_seed=5,
                            mesh=shot_mesh(2), device="cpu")
    want = _flags_by_hand(Hz, Lx, p, B, 2, 3)
    assert res["num_shots"] == n
    assert round(res["logical_error_rate"] * n) == int(want["fail"][:n].sum())
    assert round(res["converged_rate"] * n) == int(want["conv"][:n].sum())
    assert int(want["fail"][:n].sum()) != int(want["fail"].sum())


def test_device_rule(monkeypatch):
    """Without a GPU the default device raises; nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, Hz, Lx, _ = steane_code()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_code_capacity(Hz, 0.01, num_shots=10, L=Lx)
