"""The cycle-periodic BP layout (qldpc_tpu_torch/scripts/bp_grid_experiment.py)
against the port's padded-CSR decoder and the JAX package's grid layout.

The port of ``scripts/test_bp_grid_experiment.py``, on its inputs:
[[72,12,6]] at 4 cycles, p=0.005, both bases, 32 shots of channel errors
(numpy seed 7), maxIter 12. ``decode_batch_grid`` must give the port's
``ops.bp.decode_batch`` bit for bit in float32 on the CPU (same algebra,
same summation order), and JAX's ``decode_batch_grid`` (imported from
``scripts/`` as its own test does) likewise; an aperiodic matrix is
rejected or, if accepted, decodes identically.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.ops.bp import TannerGraph, alpha_schedule, decode_batch
from qldpc_tpu_torch.scripts import bp_grid_experiment
from qldpc_tpu_torch.scripts.bp_grid_experiment import (PeriodicGraph,
                                                        decode_batch_grid)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "scripts"))
import bp_grid_experiment as jax_grid  # noqa: E402  (the JAX package's)

torch.set_num_threads(1)

CODE, CYCLES, P, B, MAXITER = "[[72, 12, 6]]", 4, 0.005, 32, 12
KEYS = ("hard", "converged", "iterations", "values")


@pytest.fixture(scope="module")
def matrices():
    code = qt.get_code(CODE)
    circ = qt.SyndromeCircuit(code, num_cycles=CYCLES)
    return qt.build_decoding_matrices(circ, code.Lx, code.Lz, P)


def _case(M, basis):
    H = (M[f"Hdec{basis}"] != 0).astype(np.uint8)
    prior = qt.channel_llrs(M[f"channel_probs{basis}"])
    rng = np.random.default_rng(7)
    errs = (rng.random((B, H.shape[1]))
            < M[f"channel_probs{basis}"]).astype(np.int8)
    syn = (errs.astype(np.int64) @ H.T) % 2
    return H, prior, syn


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_grid_detection(matrices, basis):
    H, prior, _ = _case(matrices, basis)
    g = PeriodicGraph.try_from_dense(H, H.shape[0] // (CYCLES + 2), prior,
                                     device="cpu")
    assert g is not None, "BB circuit graphs must be cycle-periodic"
    assert g.T == CYCLES + 2
    # the same structure as the JAX package's
    jg = jax_grid.PeriodicGraph.try_from_dense(H, H.shape[0] // (CYCLES + 2),
                                               prior)
    for name in ("row_src", "row_mask", "col_src", "prior_grid",
                 "out_gather", "residual"):
        assert np.array_equal(getattr(g, name).numpy(),
                              np.asarray(getattr(jg, name))), name
    for name in ("n2", "T", "nq", "dr", "dc", "S1", "n", "m"):
        assert getattr(g, name) == getattr(jg, name), name


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_grid_covers_every_column(matrices, basis):
    H, prior, _ = _case(matrices, basis)
    g = PeriodicGraph.try_from_dense(H, H.shape[0] // (CYCLES + 2), prior,
                                     device="cpu")
    # every real column lands in exactly one grid slot
    nz_cols = int((H != 0).any(0).sum())
    assert int((~g.residual).sum()) == nz_cols
    live = ~g.residual.numpy()
    assert np.unique(g.out_gather.numpy()[live]).size == nz_cols


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_grid_bitexact_vs_padded_csr_and_jax(matrices, basis):
    H, prior, syn = _case(matrices, basis)
    g = PeriodicGraph.try_from_dense(H, H.shape[0] // (CYCLES + 2), prior,
                                     device="cpu")
    graph = TannerGraph.from_dense(H, device="cpu")
    seq = torch.as_tensor(alpha_schedule("dynamical", MAXITER))
    pr = torch.as_tensor(prior, dtype=torch.float32)
    s = torch.as_tensor(syn)
    a = decode_batch(graph, s, pr, seq, MAXITER)
    b = decode_batch_grid(g, s, pr, seq, MAXITER)
    for k in KEYS:
        assert torch.equal(a[k], b[k]), k
    assert 0 < int(b["converged"].sum()) < B
    jg = jax_grid.PeriodicGraph.try_from_dense(H, H.shape[0] // (CYCLES + 2),
                                               prior)
    c = jax_grid.decode_batch_grid(jg, jnp.asarray(syn), jnp.asarray(pr),
                                   jnp.asarray(seq.numpy()), MAXITER)
    for k in KEYS:
        assert np.array_equal(b[k].numpy(), np.asarray(c[k])), k


def test_grid_damped_matches_padded_csr(matrices):
    H, prior, syn = _case(matrices, "Z")
    g = PeriodicGraph.try_from_dense(H, H.shape[0] // (CYCLES + 2), prior,
                                     device="cpu")
    graph = TannerGraph.from_dense(H, device="cpu")
    seq = torch.as_tensor(alpha_schedule("dynamical", MAXITER))
    pr = torch.as_tensor(prior, dtype=torch.float32)
    s = torch.as_tensor(syn)
    a = decode_batch(graph, s, pr, seq, MAXITER, damping=0.8)
    b = decode_batch_grid(g, s, pr, seq, MAXITER, damping=0.8)
    for k in KEYS:
        assert torch.equal(a[k], b[k]), k


def test_grid_rejects_aperiodic():
    rng = np.random.default_rng(0)
    H = (rng.random((24, 60)) < 0.15).astype(np.uint8)
    prior = np.ones(60, np.float32)
    # random matrices have ~unique column patterns -> grid is rejected as
    # too sparse (or structurally inconsistent), never built wrong
    g = PeriodicGraph.try_from_dense(H, 6, prior, device="cpu")
    assert (g is None) == (jax_grid.PeriodicGraph.try_from_dense(
        H, 6, prior) is None)
    syn = torch.as_tensor(rng.integers(0, 2, (4, 24)).astype(np.int8))
    if g is not None:  # if accepted, it must still decode identically
        graph = TannerGraph.from_dense(H, device="cpu")
        seq = torch.as_tensor(alpha_schedule("dynamical", 5))
        a = decode_batch(graph, syn, torch.as_tensor(prior), seq, 5)
        b = decode_batch_grid(g, syn, torch.as_tensor(prior), seq, 5)
        assert torch.equal(a["hard"], b["hard"])
    # a matrix whose rows are not a whole number of cycles is rejected
    assert PeriodicGraph.try_from_dense(H, 7, prior, device="cpu") is None


def test_grid_main_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(bp_grid_experiment, "REPS", 1)
    res = bp_grid_experiment.main([CODE, "0.006", "16", "6",
                                   "--device", "cpu"])
    assert res["max_value_diff"] == 0.0
    rows = res["rows"]
    assert list(rows) == ["padded-CSR decode_batch f32",
                          "grid decode_batch_grid f32"]
    assert all(r["ms_per_iter"] > 0 and r["launches_per_iter"] is None
               for r in rows.values())
    out = capsys.readouterr().out
    assert "hard, converged and iterations identical" in out
