"""The port's shot mesh against the JAX package's.

One pooled dispatch on a two-shard mesh (qldpc_tpu_torch/parallel/mesh.py),
fed the draws JAX makes on each device, must equal JAX's ``shard_rounds``
over a two-device CPU mesh (tests/conftest.py gives JAX eight virtual CPU
devices) with both Pallas kernels in interpret mode: every per-shot flag
in the same global (shard-major) order, and every count.
"""
import numpy as np
import torch

import jax

import qldpc_tpu
from qldpc_tpu.ops import osd_pallas as jax_osd_pallas
from qldpc_tpu.ops.bp import alpha_schedule
from qldpc_tpu.ops.sampler import sample_gate_randoms as jax_randoms
from qldpc_tpu.parallel import engine as jengine
from qldpc_tpu.parallel import mesh as jmesh

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.parallel import engine as tengine
from qldpc_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

FLAG_KEYS = ("z_conv", "x_conv", "z_err", "x_err", "z_rankdef", "x_rankdef",
             "any_err")
COUNTED = ("any_err", "z_err", "x_err", "z_rankdef", "x_rankdef")


def test_two_shard_dispatch_matches_jax_shard_rounds(monkeypatch):
    """One pooled dispatch (2 rounds of 8 shots a shard) on a two-shard
    mesh, fed JAX's draws per shard (``fold_in(fold_in(key, d), r)``),
    equals JAX's shard_rounds over two CPU devices with both Pallas kernels
    in interpret mode: every flag in the same global order, and the
    counts."""
    bp, elim = jengine.decode_batch_lift_pallas, jax_osd_pallas.eliminate_blocks
    monkeypatch.setattr(jengine, "decode_batch_lift_pallas",
                        lambda *a, **k: bp(*a, **k, interpret=True))
    monkeypatch.setattr(jax_osd_pallas, "eliminate_blocks",
                        lambda *a, **k: elim(*a, **k, interpret=True))
    jax.clear_caches()
    p, cycles, batch, rounds, maxIter, osd_order = 0.01, 2, 8, 2, 6, 2
    jcode = qldpc_tpu.get_code("[[72, 12, 6]]")
    jcirc = qldpc_tpu.SyndromeCircuit(jcode, num_cycles=cycles)
    jM = qldpc_tpu.build_decoding_matrices(jcirc, jcode.Lx, jcode.Lz, p)
    seq = alpha_schedule("dynamical", maxIter)
    jdz, jdx = (jengine._make_basis(jcirc, jM, b, seq, osd_order=osd_order)
                for b in "ZX")
    n_locs = jcirc.num_error_locs
    jfn = jengine.make_pooled_round_fn(jdz, jdx, n_locs, p, batch, maxIter,
                                       osd_order, rounds, use_pallas=True)
    sharded = jmesh.shard_rounds(jax.jit(jfn),
                                 jmesh.shot_mesh(jax.devices()[:2]))
    key = jengine.make_key(5)
    want = jax.device_get(sharded(key, jdz, jdx))
    jax.clear_caches()
    randoms = [[tuple(torch.as_tensor(np.array(x)) for x in jax_randoms(
        jax.random.fold_in(jax.random.fold_in(key, d), r), batch, n_locs, p))
        for r in range(rounds)] for d in range(2)]

    code = qt.get_code("[[72, 12, 6]]")
    circ = qt.SyndromeCircuit(code, num_cycles=cycles)
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, p)
    dz, dx = (tengine._make_basis(circ, M, b, seq, osd_order=osd_order,
                                  device="cpu") for b in "ZX")
    fn = tengine.make_pooled_round_fn(dz, dx, n_locs, p, batch, maxIter,
                                      osd_order, rounds)
    got = tmesh.shard_rounds(fn, tmesh.shot_mesh(2))([None, None],
                                                      randoms=randoms)
    for k in FLAG_KEYS:
        assert got[k].shape == (2 * rounds * batch,), k
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    for k in COUNTED:
        assert got[f"{k}_count"] == int(want[f"{k}_count"]), k
    # the comparison bites: BP fails on some shots, some decode wrongly
    assert not want["z_conv"].all() and want["any_err"].any()
