"""Port layered BP (plain twin of kernel K3, and the roll twin) vs JAX.

Inputs as the JAX package's own layered-kernel test
(tests/test_bp_lift_pallas.py::test_kernel_layered_matches_xla_layered):
[[72,12,6]], 4 cycles, p=0.004, 32 shots per basis, maxIter 10.

Standard: against the Pallas layered kernel in interpret mode — which, like
the port, evaluates every product and sum as a separate float32 op — hard
decisions, convergence flags and sweep counts are exact and the values of
unconverged shots bit-exact. Against the JAX XLA layered lift, which
contracts multiply-adds, decisions are exact and values agree to relative
1e-2 (the JAX package's own tolerance for that pair).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qldpc_tpu import (SyndromeCircuit, build_decoding_matrices,
                       channel_llrs, get_code)
from qldpc_tpu.ops.bp import alpha_schedule
from qldpc_tpu.ops.bp_lift import LiftedGraph as JLiftedGraph
from qldpc_tpu.ops.bp_lift import decode_batch_lift_layered as jax_layered
from qldpc_tpu.ops.bp_lift_pallas import decode_batch_lift_pallas

from qldpc_tpu_torch.ops.bp_lift import (LiftedGraph, decode_batch_lift,
                                         decode_batch_lift_layered)
from qldpc_tpu_torch.ops.bp_lift_layered_cuda import (
    decode_batch_lift_layered_cuda, decode_batch_lift_layered_plain)

torch.set_num_threads(1)

MAXITER = 10


@pytest.fixture(scope="module")
def data():
    code = get_code("[[72, 12, 6]]")
    circ = SyndromeCircuit(code, num_cycles=4)
    M = build_decoding_matrices(circ, code.Lx, code.Lz, 0.004)
    rng = np.random.default_rng(1)
    B = 32
    seq = alpha_schedule("dynamical", MAXITER)
    out = {}
    for basis in ("Z", "X"):
        H = (np.asarray(M[f"Hdec{basis}"]) != 0).astype(np.uint8)
        prior = channel_llrs(M[f"channel_probs{basis}"]).astype(np.float32)
        errs = (rng.random((B, H.shape[1]))
                < M[f"channel_probs{basis}"]).astype(np.int8)
        syn = ((errs @ H.T) % 2).astype(np.int8)
        jg = JLiftedGraph.try_from_dense(H, code.ell, code.m, prior)
        args = (jnp.asarray(syn), jnp.asarray(prior), jnp.asarray(seq),
                MAXITER)
        pallas = decode_batch_lift_pallas(jg, *args, msg_dtype=jnp.float32,
                                          block_b=16, schedule="layered",
                                          interpret=True)
        xla = jax_layered(jg, *args, msg_dtype=jnp.float32)
        tg = LiftedGraph.try_from_dense(H, code.ell, code.m, prior,
                                        device="cpu")
        targs = (torch.as_tensor(syn), torch.as_tensor(prior),
                 torch.as_tensor(seq), MAXITER)
        out[basis] = dict(
            pallas={k: np.asarray(v) for k, v in pallas.items()},
            xla={k: np.asarray(v) for k, v in xla.items()},
            plain={k: v.numpy() for k, v in
                   decode_batch_lift_layered_plain(tg, *targs).items()},
            roll={k: v.numpy() for k, v in
                  decode_batch_lift_layered(tg, *targs).items()},
            wrapper={k: v.numpy() for k, v in
                     decode_batch_lift_layered_cuda(tg, *targs).items()},
            flooding={k: v.numpy() for k, v in
                      decode_batch_lift(tg, *targs).items()},
            H=H, syn=syn)
    return out


def _decisions_equal(a, b, what):
    for k in ("hard", "converged", "iterations"):
        assert np.array_equal(a[k], b[k]), (what, k)


@pytest.mark.parametrize("basis", ["Z", "X"])
@pytest.mark.parametrize("twin", ["plain", "roll", "wrapper"])
def test_exact_against_pallas_interpret(data, basis, twin):
    d = data[basis]
    ref, got = d["pallas"], d[twin]
    _decisions_equal(ref, got, twin)
    assert got["hard"].dtype == np.int8 and got["converged"].dtype == bool
    assert got["iterations"].dtype == np.int32
    conv = ref["converged"]
    assert conv.any() and not conv.all()  # both kinds of shots present
    assert np.array_equal(ref["values"][~conv], got["values"][~conv])


@pytest.mark.parametrize("basis", ["Z", "X"])
@pytest.mark.parametrize("twin", ["plain", "roll"])
def test_against_xla_layered(data, basis, twin):
    d = data[basis]
    ref, got = d["xla"], d[twin]
    _decisions_equal(ref, got, twin)
    # converged shots' values are frozen at convergence in both
    va, vb = ref["values"], got["values"]
    rel = np.abs(va - vb) / np.maximum(np.abs(va), 1e-9)
    assert rel.max() < 1e-2


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_plain_matches_roll_twin_everywhere(data, basis):
    """Both port twins freeze at convergence: every value agrees, and
    converged shots satisfy their syndrome."""
    d = data[basis]
    for k in ("hard", "converged", "iterations", "values"):
        assert np.array_equal(d["plain"][k], d["roll"][k]), k
    conv = d["plain"]["converged"]
    hard = d["plain"]["hard"].astype(np.int64)
    assert np.array_equal(((hard @ d["H"].T) % 2)[conv], d["syn"][conv])


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_layered_converges_no_worse_than_flooding(data, basis):
    """As the JAX package pins for its layered lift
    (tests/test_bp_lift.py::test_layered_converges_no_worse_than_flooding)."""
    d = data[basis]
    assert d["plain"]["converged"].sum() >= d["flooding"]["converged"].sum()
    # and fewer sweeps in all than flooding needs iterations, on the shots
    # both converge
    both = d["plain"]["converged"] & d["flooding"]["converged"]
    assert (d["plain"]["iterations"][both].sum()
            <= d["flooding"]["iterations"][both].sum())


def test_wrapper_rejects_bad_shapes(data):
    d = data["Z"]
    g = LiftedGraph.try_from_dense(d["H"], 6, 6, np.zeros(d["H"].shape[1],
                                                          np.float32),
                                   device="cpu")
    seq = torch.ones(MAXITER)
    with pytest.raises(ValueError, match="syndrome"):
        decode_batch_lift_layered_cuda(g, torch.zeros((2, 5), dtype=torch.int8),
                                       torch.zeros(g.n), seq, MAXITER)
    with pytest.raises(ValueError, match="maxIter"):
        decode_batch_lift_layered_cuda(
            g, torch.zeros((2, g.m), dtype=torch.int8), torch.zeros(g.n),
            seq, MAXITER + 1)
