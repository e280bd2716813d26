"""The port's multi-code rounds and run_multi_code_simulation vs JAX.

One pooled multi-code dispatch of the port ([[72,12,6]] + [[90,8,10]]),
fed the draws JAX makes for each round and code
(``fold_in(fold_in(key, r), i)``), must give exactly the per-shot flags of
JAX's ``make_multi_code_pooled_round_fn`` with both Pallas kernels in
interpret mode, code by code. JAX's multi-code rounds pick the Pallas
kernels from the backend, so the test makes ``_round_defaults`` ask for
them; nothing in the JAX package changes. The file holds that one test,
which compiles JAX's interpret-mode round once per code;
test_torch_multicode_run.py holds the port's multi-code path on its own.
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

torch.set_num_threads(1)

FLAG_KEYS = ("z_conv", "x_conv", "z_err", "x_err", "z_rankdef", "x_rankdef",
             "any_err")
CODES = ("[[72, 12, 6]]", "[[90, 8, 10]]")
P, CYCLES, BATCH, ROUNDS, MAXITER, OSD_ORDER = 0.01, 2, 8, 2, 5, 2


def _specs(package, seq):
    """Per-code round specs of ``package`` ("jax" or "torch")."""
    mod, eng = ((qldpc_tpu, jengine) if package == "jax" else (qt, tengine))
    kw = {} if package == "jax" else dict(device="cpu")
    specs = []
    for name in CODES:
        code = mod.get_code(name)
        circ = mod.SyndromeCircuit(code, num_cycles=CYCLES)
        M = mod.build_decoding_matrices(circ, code.Lx, code.Lz, P)
        dz, dx = (eng._make_basis(circ, M, b, seq, osd_order=OSD_ORDER, **kw)
                  for b in "ZX")
        specs.append(dict(dec_z=dz, dec_x=dx, n_locs=circ.num_error_locs,
                          error_rate=P, batch=BATCH, maxIter=MAXITER,
                          osd_order=OSD_ORDER))
    return specs


@pytest.fixture
def jax_pallas_interpreted(monkeypatch):
    """JAX's multi-code rounds on both Pallas kernels, in interpret mode."""
    bp = jengine.decode_batch_lift_pallas
    elim = jax_osd_pallas.eliminate_blocks
    defaults = jengine._round_defaults
    monkeypatch.setattr(jengine, "decode_batch_lift_pallas",
                        lambda *a, **k: bp(*a, **k, interpret=True))
    monkeypatch.setattr(jax_osd_pallas, "eliminate_blocks",
                        lambda *a, **k: elim(*a, **k, interpret=True))
    monkeypatch.setattr(jengine, "_round_defaults",
                        lambda dz, d, _up, md, bv: defaults(dz, d, True, md,
                                                            bv))
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_pooled_multi_code_dispatch_matches_jax(jax_pallas_interpreted):
    seq = alpha_schedule("dynamical", MAXITER)
    jspecs = _specs("jax", seq)
    decs = [(sp["dec_z"], sp["dec_x"]) for sp in jspecs]
    jfn = jengine.make_multi_code_pooled_round_fn(jspecs, ROUNDS)
    key = jengine.make_key(11)
    want = jax.device_get(jax.jit(jfn)(key, decs))
    randoms = [[tuple(torch.as_tensor(np.array(x)) for x in jax_randoms(
        jax.random.fold_in(jax.random.fold_in(key, r), i), BATCH,
        sp["n_locs"], P)) for r in range(ROUNDS)]
        for i, sp in enumerate(jspecs)]

    fn = tengine.make_multi_code_pooled_round_fn(_specs("torch", seq), ROUNDS)
    got = fn([None, None], randoms=randoms)
    assert len(got) == len(want) == 2
    for name, g, w in zip(CODES, got, want):
        # the port's round adds its OSD overflow flag; no slice overflowed
        assert set(g) == set(FLAG_KEYS) | {"osd_overflow"}
        assert not g["osd_overflow"].any()
        for k in FLAG_KEYS:
            assert g[k].shape == (ROUNDS * BATCH,), (name, k)
            assert np.array_equal(g[k].numpy(), np.asarray(w[k])), (name, k)
        # the comparison bites: BP fails on some shots, OSD runs
        assert not np.asarray(w["z_conv"]).all(), name
    assert any(np.asarray(w["any_err"]).any() for w in want)
