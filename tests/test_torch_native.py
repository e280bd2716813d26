"""The port's native host kernels (qldpc_tpu_torch/native) vs the JAX
package's and vs the port's NumPy paths.

The C++ trial decoder is bench_cuda.py's vs_baseline denominator: on
tests/test_native_baseline.py's problem it must give the JAX package's
convergence flags and solutions. The native eliminator behind rank_fast /
column_basis, and the native frame propagation behind propagate_batch,
must equal the NumPy fallbacks. Skips only without g++, as the JAX
package's test does.
"""
import numpy as np
import pytest
import torch

from qldpc_tpu.native import build as jbuild

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.models import gf2
from qldpc_tpu_torch.models.builder import channel_llrs
from qldpc_tpu_torch.native import build
from qldpc_tpu_torch.ops.bp import TannerGraph, alpha_schedule, decode_batch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problem():
    if build.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    code = qt.get_code("[[72, 12, 6]]")
    circ = qt.SyndromeCircuit(code, num_cycles=6)
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, 0.006)
    H = (np.asarray(M["HdecZ"]) != 0).astype(np.uint8)
    prior = channel_llrs(M["channel_probsZ"])
    rng = np.random.default_rng(3)
    errs = (rng.random((48, H.shape[1])) < M["channel_probsZ"]).astype(np.int8)
    syns = ((errs @ H.T) % 2).astype(np.uint8)
    return circ, M, H, prior, syns


@pytest.mark.parametrize("maxIter,order", [(8, 2), (4, 0)])
def test_baseline_matches_jax_native(problem, maxIter, order):
    _, _, H, prior, syns = problem
    seq = np.asarray(alpha_schedule("dynamical", maxIter), np.float32)
    num_test = order + 10 if order else 0
    got = build.baseline_decode_native(H, prior, syns, maxIter, seq,
                                       order=order, num_test=num_test,
                                       return_solutions=True)
    want = jbuild.baseline_decode_native(H, prior, syns, maxIter, seq,
                                         order=order, num_test=num_test,
                                         return_solutions=True)
    if want is None:
        pytest.skip("the JAX package's native build is unavailable")
    assert got[0] > 0
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    # every decoded pattern reproduces its syndrome
    resid = (got[2].astype(np.int64) @ H.T.astype(np.int64)) % 2
    np.testing.assert_array_equal(resid.astype(np.uint8), syns)
    assert 0 < got[1].sum() < len(got[1])


def test_baseline_convergence_matches_port_decoder(problem):
    """The baseline's convergence decisions are the port's padded-CSR
    min-sum decoder's, float32."""
    _, _, H, prior, syns = problem
    maxIter = 8
    seq = np.asarray(alpha_schedule("dynamical", maxIter), np.float32)
    _, conv = build.baseline_decode_native(H, prior, syns, maxIter, seq)
    dec = decode_batch(TannerGraph.from_dense(H, device="cpu"),
                       torch.as_tensor(syns.astype(np.int8)),
                       torch.as_tensor(prior, dtype=torch.float32),
                       torch.as_tensor(seq), maxIter)
    np.testing.assert_array_equal(dec["converged"].numpy(), conv.astype(bool))


def test_baseline_order_two_never_heavier(problem):
    """JAX's test on the port's copy: order-2 reprocessing never picks a
    heavier solution than OSD-0."""
    _, _, H, prior, syns = problem
    seq = np.asarray(alpha_schedule("dynamical", 4), np.float32)
    _, conv0, sol0 = build.baseline_decode_native(
        H, prior, syns, 4, seq, order=0, num_test=0, return_solutions=True)
    _, conv2, sol2 = build.baseline_decode_native(
        H, prior, syns, 4, seq, order=2, num_test=12, return_solutions=True)
    np.testing.assert_array_equal(conv0, conv2)
    w = np.abs(prior)
    assert ((sol2 * w).sum(1) <= (sol0 * w).sum(1) + 1e-4).all()


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_rank_and_basis_native_vs_numpy(problem, basis):
    M = problem[1]
    H = (np.asarray(M[f"Hdec{basis}"]) != 0).astype(np.uint8)
    _, piv = gf2.row_reduce(H, full=False)
    assert gf2.rank_fast(H) == len(piv)
    assert np.array_equal(gf2.column_basis(H), piv.astype(np.int32))


def test_numpy_fallback_without_toolchain(problem, monkeypatch):
    """With the library unavailable every entry point returns None and the
    models take their NumPy paths, with the same results: ranks, bases and
    the whole decoding-matrix build (frame propagation)."""
    H = problem[2]
    code = qt.get_code("[[72, 12, 6]]")
    circ = qt.SyndromeCircuit(code, num_cycles=2)
    want = (gf2.rank_fast(H), gf2.column_basis(H),
            qt.build_decoding_matrices(circ, code.Lx, code.Lz, 0.01))
    monkeypatch.setattr(build, "get_lib", lambda: None)
    assert build.propagate_frames_native(
        np.zeros(1, np.int32), np.zeros(1, np.int32), np.zeros(1, np.int32),
        True, 0, 0, 1, 1, [], [], [], 1) is None
    assert gf2.rank_fast(H) == want[0]
    assert np.array_equal(gf2.column_basis(H), want[1])
    got = qt.build_decoding_matrices(circ, code.Lx, code.Lz, 0.01)
    assert set(got) == set(want[2])
    for key, v in want[2].items():
        assert np.array_equal(np.asarray(got[key]), np.asarray(v)), key
