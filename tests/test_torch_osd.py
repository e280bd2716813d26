"""Port OSD vs JAX: the plain twin of kernel K2 and the orchestration.

The plain ``eliminate_blocks`` must be integer-exact against the JAX
package's Pallas eliminator (interpret mode) and its XLA loop when both scan
every column (exit_on_valid=False); with the validity exit on, the consumed
outputs must agree. ``osd_batch`` must be bit-exact against JAX
``osd_batch(use_pallas=False)`` on valid, rank_deficient,
logical_delta_packed and solution, for real BP-failed [[72]] shots.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qldpc_tpu import (SyndromeCircuit, build_decoding_matrices,
                       channel_llrs, get_code)
from qldpc_tpu.models.gf2 import column_basis, rank_fast
from qldpc_tpu.ops.osd import _eliminate_xla as jax_eliminate_xla
from qldpc_tpu.ops.osd import _gather_pack as jax_gather_pack
from qldpc_tpu.ops.osd import osd_batch as jax_osd_batch
from qldpc_tpu.ops.osd_pallas import eliminate_blocks as jax_eliminate_blocks

from qldpc_tpu_torch.ops.bp import alpha_schedule
from qldpc_tpu_torch.ops.bp_lift import LiftedGraph
from qldpc_tpu_torch.ops.bp_lift_cuda import decode_batch_lift_plain
from qldpc_tpu_torch.ops.osd import (_eliminate_xla, _gather_pack,
                                     choose_K, osd_batch)
from qldpc_tpu_torch.ops.osd_cuda import (column_stride, eliminate_blocks,
                                          words_to_columns)

torch.set_num_threads(1)


def _random_case(seed, m=40, n=320, K=288, B=8, p=0.1):
    rng = np.random.default_rng(seed)
    H = np.zeros((m, n), np.uint8)
    for j in range(n):
        H[rng.choice(m, 3, replace=False), j] = 1
    errors = (rng.random((B, n)) < p).astype(np.int8)
    residual = ((errors @ H.T) % 2).astype(np.int32)
    residual[2] = 0  # valid before any elimination
    cols = np.stack([rng.permutation(n)[:K] for _ in range(B)])
    return H, residual, cols


def _columns(words):
    """G1's column layout (what eliminate_blocks takes) of (B, W, M)
    words-major int32 numpy words."""
    _, W, M = words.shape
    return words_to_columns(torch.as_tensor(words),
                            column_stride(W, M, "cpu"))


@pytest.mark.parametrize("full_jordan", [False, True])
def test_eliminate_blocks_exact_full_scan(full_jordan):
    """K > 256 engages left-word skipping across several words."""
    H, residual, cols = _random_case(9)
    m, K = H.shape[0], cols.shape[1]
    Kp = -(-K // 32) * 32
    Hp = np.asarray(jax_gather_pack(jnp.asarray(H), jnp.asarray(cols), Kp))
    xHp, xs, xused, xprow = (np.asarray(a) for a in jax_eliminate_xla(
        jnp.asarray(Hp), jnp.asarray(residual), K, m, len(cols),
        exit_on_valid=False))
    M_pad = 128
    HpT = np.pad(Hp.transpose(0, 2, 1), ((0, 0), (0, 0), (0, M_pad - m)))
    s_pad = np.pad(residual, ((0, 0), (0, M_pad - m)))
    pHp, ps, pprow, pused, pcf = (np.asarray(a) for a in jax_eliminate_blocks(
        jnp.asarray(HpT), jnp.asarray(s_pad), K, m, block_shots=4,
        interpret=True, full_jordan=full_jordan, exit_on_valid=False))
    tHp, ts, tprow, tused, tcf = (a.numpy() for a in eliminate_blocks(
        _columns(HpT.view(np.int32)), torch.as_tensor(s_pad), K, m,
        full_jordan=full_jordan, exit_on_valid=False))
    # vs the Pallas kernel: every output
    assert np.array_equal(tprow, pprow)
    assert np.array_equal(ts, ps) and np.array_equal(tused, pused)
    assert np.array_equal(tcf, pcf)
    # vs the XLA loop (full Gauss-Jordan, (B, m, W) layout)
    assert np.array_equal(tprow, xprow)
    assert np.array_equal(ts[:, :m], xs) and np.array_equal(tused[:, :m],
                                                             xused)
    # the port's XLA twin scans the (B, m, W) layout in full
    vHp, vs, vused, vprow = (a.numpy() for a in _eliminate_xla(
        torch.as_tensor(Hp.view(np.int32).copy()), torch.as_tensor(residual),
        K, m, len(cols), exit_on_valid=False))
    assert np.array_equal(vHp.view(np.uint32), xHp)
    assert np.array_equal(vs, xs) and np.array_equal(vused, xused)
    assert np.array_equal(vprow, xprow)
    got = tHp.transpose(0, 2, 1)[:, :m, :].view(np.uint32)
    if full_jordan:
        assert np.array_equal(got, xHp)
        assert np.array_equal(tHp.view(np.uint32), pHp)
    else:
        # word-granular left skipping keeps every pivot column exact
        for b in range(len(cols)):
            for c in np.nonzero(xprow[b] >= 0)[0]:
                w, bit = divmod(int(c), 32)
                assert np.array_equal((got[b, :, w] >> bit) & 1,
                                      (xHp[b, :, w] >> bit) & 1), (b, c)


def test_eliminate_blocks_validity_exit_consumed_outputs():
    H, residual, cols = _random_case(21, p=0.08)
    m, K = H.shape[0], cols.shape[1]
    B, n = cols.shape[0], H.shape[1]
    Kp = -(-K // 32) * 32
    Hp = np.asarray(jax_gather_pack(jnp.asarray(H), jnp.asarray(cols), Kp))
    HpT = np.ascontiguousarray(Hp.transpose(0, 2, 1)).view(np.int32)
    outs = {}
    for exit_valid in (False, True):
        _, s, prow, used, _, steps = (a.numpy() for a in eliminate_blocks(
            _columns(HpT), torch.as_tensor(residual), K, m,
            exit_on_valid=exit_valid, return_steps=True))
        e0 = np.zeros((B, n), np.int32)
        for b in range(B):
            for c in range(K):
                if prow[b, c] >= 0:
                    e0[b, cols[b, c]] ^= s[b, prow[b, c]]
        unsat = np.array([int(s[b][~used[b]].sum()) for b in range(B)])
        outs[exit_valid] = (s, e0, unsat == 0, steps)
    for a, b in zip(outs[False][:3], outs[True][:3]):
        assert np.array_equal(a, b)
    assert outs[True][2].any()
    assert outs[True][3][2] == 0                 # all-zero residual: no step
    assert (outs[True][3] <= outs[False][3]).all()
    assert (outs[True][3] < outs[False][3]).any()


@pytest.fixture(scope="module")
def failed72():
    """Real BP-failed [[72,12,6]] shots (6 cycles, p=0.006)."""
    code = get_code("[[72, 12, 6]]")
    circ = SyndromeCircuit(code, num_cycles=6)
    M = build_decoding_matrices(circ, code.Lx, code.Lz, 0.006)
    H = (np.asarray(M["HdecZ"]) != 0).astype(np.uint8)
    prior = channel_llrs(M["channel_probsZ"])
    rng = np.random.default_rng(2)
    B = 96
    errs = (rng.random((B, H.shape[1])) < M["channel_probsZ"]).astype(np.int8)
    syn = ((errs @ H.T) % 2).astype(np.int8)
    g = LiftedGraph.try_from_dense(H, code.ell, code.m, prior, device="cpu")
    bp = decode_batch_lift_plain(
        g, torch.as_tensor(syn), torch.as_tensor(prior, dtype=torch.float32),
        torch.as_tensor(alpha_schedule("dynamical", 12)), 12)
    fail = ~bp["converged"].numpy()
    k = M["k"]
    first = M["first_logical_rowZ"]
    HL = (np.asarray(M["HZ_full"])[first:first + k] != 0).astype(np.int64)
    lp = (HL << np.arange(k)[:, None]).sum(0).astype(np.int32)
    return dict(H=H, syn=syn[fail], vals=bp["values"].numpy()[fail],
                hard=bp["hard"].numpy()[fail], lp=lp, rank=rank_fast(H),
                basis=column_basis(H))


def _compare_osd(d, syn, vals, hard, K, order, use_basis, stage1_cols=None,
                 use_blocks=True):
    H = d["H"]
    kw = dict(K=K, order=order, num_test=order + 10 if order else 0,
              rank=d["rank"])
    want = jax_osd_batch(
        jnp.asarray(H), jnp.asarray(H.T, dtype=jnp.bfloat16),
        jnp.asarray(syn), jnp.asarray(vals), jnp.asarray(hard),
        use_pallas=False, logical_pack=jnp.asarray(d["lp"]),
        basis_cols=jnp.asarray(d["basis"]) if use_basis else None, **kw)
    got = osd_batch(
        torch.as_tensor(H), torch.as_tensor(H.T.astype(np.float32)),
        torch.as_tensor(syn), torch.as_tensor(vals), torch.as_tensor(hard),
        use_blocks=use_blocks, stage1_cols=stage1_cols,
        logical_pack=torch.as_tensor(d["lp"]),
        basis_cols=torch.as_tensor(d["basis"]) if use_basis else None, **kw)
    for key in ("valid", "rank_deficient", "logical_delta_packed",
                "solution"):
        assert np.array_equal(np.asarray(want[key]), got[key].numpy()), key
    return got


@pytest.mark.parametrize("use_basis", [True, False])
@pytest.mark.parametrize("stage1_cols", [None, 0])
def test_osd_batch_matches_jax(failed72, use_basis, stage1_cols):
    """K=512 >= 512: the auto stage-1 width is 256 (staged); 0 is the
    single-stage scan."""
    d = failed72
    K = choose_K(*d["H"].shape, margin=128)
    assert K == 512 and len(d["syn"]) > 20
    got = _compare_osd(d, d["syn"], d["vals"], d["hard"], K, 2, use_basis,
                       stage1_cols)
    assert got["valid"].all()


def test_osd_batch_xla_twin_and_reprocess(failed72):
    """Syndromes outside H's column space fail OSD-0 and engage the order-2
    reprocess, on both elimination paths; a narrow K without the basis
    leaves some shots truncation-deficient."""
    d = failed72
    rng = np.random.default_rng(5)
    syn = d["syn"][:24].copy()
    syn[:6] = rng.integers(0, 2, syn[:6].shape)
    for use_blocks in (True, False):
        got = _compare_osd(d, syn, d["vals"][:24], d["hard"][:24], 512, 2,
                           True, use_blocks=use_blocks)
        assert not got["valid"].all() and got["valid"].any()
        got = _compare_osd(d, d["syn"][:24], d["vals"][:24], d["hard"][:24],
                           64, 1, False, use_blocks=use_blocks)
        assert got["rank_deficient"].any()


def test_gather_pack_matches_jax():
    H, _, cols = _random_case(3, K=100)
    want = np.asarray(jax_gather_pack(jnp.asarray(H), jnp.asarray(cols), 128))
    got = _gather_pack(torch.as_tensor(H.T.copy()), torch.as_tensor(cols),
                       128).numpy()
    assert np.array_equal(got.view(np.uint32), want)
