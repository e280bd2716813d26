"""Port lifted BP (plain twin of kernel K1, and the roll twin) vs JAX.

Standard: against the Pallas flooding kernel in interpret mode — which, like
the port, evaluates every product and sum as a separate float32 op — hard
decisions, convergence flags and iteration counts are exact and the values
of unconverged shots bit-exact. Against the XLA lift, which contracts
multiply-adds, decisions are exact and values agree to relative 1e-2 (the
JAX package's own standard, tests/test_bp_lift_pallas.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qldpc_tpu import (SyndromeCircuit, build_decoding_matrices,
                       channel_llrs, get_code)
from qldpc_tpu.ops.bp import alpha_schedule
from qldpc_tpu.ops.bp_lift import LiftedGraph as JLiftedGraph
from qldpc_tpu.ops.bp_lift import decode_batch_lift as jax_lift
from qldpc_tpu.ops.bp_lift_pallas import decode_batch_lift_pallas

from qldpc_tpu_torch.ops.bp_lift import LiftedGraph, decode_batch_lift
from qldpc_tpu_torch.ops.bp_lift_cuda import (decode_batch_lift_cuda,
                                              decode_batch_lift_plain,
                                              flood_tables)

torch.set_num_threads(1)

MAXITER = 12


@pytest.fixture(scope="module")
def data():
    code = get_code("[[72, 12, 6]]")
    circ = SyndromeCircuit(code, num_cycles=3)
    M = build_decoding_matrices(circ, code.Lx, code.Lz, 0.003)
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
                                          block_b=16, interpret=True)
        xla = jax_lift(jg, *args, msg_dtype=jnp.float32)
        tg = LiftedGraph.try_from_dense(H, code.ell, code.m, prior,
                                        device="cpu")
        targs = (torch.as_tensor(syn), torch.as_tensor(prior),
                 torch.as_tensor(seq), MAXITER)
        out[basis] = dict(
            pallas={k: np.asarray(v) for k, v in pallas.items()},
            xla={k: np.asarray(v) for k, v in xla.items()},
            plain={k: v.numpy() for k, v in
                   decode_batch_lift_plain(tg, *targs).items()},
            roll={k: v.numpy() for k, v in
                  decode_batch_lift(tg, *targs).items()},
            wrapper={k: v.numpy() for k, v in
                     decode_batch_lift_cuda(tg, *targs).items()},
            graph=tg, H=H)
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
def test_against_xla_lift(data, basis, twin):
    d = data[basis]
    ref, got = d["xla"], d[twin]
    _decisions_equal(ref, got, twin)
    # converged shots' values are frozen at convergence in both
    va, vb = ref["values"], got["values"]
    rel = np.abs(va - vb) / np.maximum(np.abs(va), 1e-9)
    assert rel.max() < 1e-2


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_plain_matches_roll_twin_everywhere(data, basis):
    """Both port twins freeze at convergence: every value agrees."""
    d = data[basis]
    for k in ("hard", "converged", "iterations", "values"):
        assert np.array_equal(d["plain"][k], d["roll"][k]), k


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_flood_tables_are_inverse(data, basis):
    """Each live (edge, check) entry points at a column slot whose table
    entry points back at the same check, and the live count is nnz(H)."""
    d = data[basis]
    g = d["graph"]
    tabs = flood_tables(g, torch.device("cpu"))
    chk = tabs["chk_nbr"].numpy()
    col = tabs["col_chk"].numpy()
    P = tabs["P"]
    assert (chk >= 0).sum() == d["H"].sum() == (col >= 0).sum()
    e, r = np.nonzero(chk >= 0)
    assert np.array_equal(col[e, chk[e, r] % P], r)
    assert np.array_equal(chk[e, r] // P, np.asarray(g.eb_pb)[e])
