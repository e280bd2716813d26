"""Port eliminator versions (plain twins of kernels K4 and K5) vs JAX.

The JAX package selects its Pallas eliminator generation with
``osd_pallas._KERNEL_VERSION`` (``QLDPC_OSD_KERNEL``): 2 is the fused
4-column kernel (``_elim_kernel_v2``), 3 the two-block interleave
(``_elim_kernel_v3``). The port mirrors the selector in
``osd_cuda._KERNEL_VERSION``. Inputs as tests/test_osd_pallas.py
(test_kernel_versions_match_v1), plus a wider case that crosses JAX's word
groups; the JAX kernels run in interpret mode.

Standard: with the validity exit off every version scans every column, so
s_red, prow_of_col, used and colofrow are integer-exact, and so is the
reduced matrix under full_jordan; without full_jordan the port skips passed
words per word and the JAX kernels per word group, so the matrices agree on
every pivot column. With the exit on, one shot per JAX block
(block_shots=1), K4's plain version equals JAX v2 and K5's equals JAX v3 on
the same outputs. ``osd_batch`` gives the same flags under every version.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qldpc_tpu import (SyndromeCircuit, build_decoding_matrices,
                       channel_llrs, get_code)
from qldpc_tpu.models.gf2 import column_basis, rank_fast
from qldpc_tpu.ops import osd_pallas as jax_osd_pallas
from qldpc_tpu.ops.osd import _gather_pack as jax_gather_pack
from qldpc_tpu.ops.osd import osd_batch as jax_osd_batch

from qldpc_tpu_torch.ops import osd_cuda
from qldpc_tpu_torch.ops.osd import choose_K, osd_batch

torch.set_num_threads(1)

PLAIN = {1: osd_cuda.eliminate_blocks_plain,
         2: osd_cuda.eliminate_blocks_fused_plain,
         3: osd_cuda.eliminate_blocks_plain}
NAMES = ("Hp", "s_red", "prow_of_col", "used", "colofrow")


def _case(kind):
    """(HpT (B, W, M_pad) int32, s_pad (B, M_pad), K, m)."""
    if kind == "narrow":   # tests/test_osd_pallas.py::test_kernel_versions
        rng = np.random.default_rng(6)
        m, n, K, B, p = 24, 96, 96, 8, 0.12
    else:                  # W = 9 words: two JAX word groups
        rng = np.random.default_rng(9)
        m, n, K, B, p = 40, 320, 288, 8, 0.1
    H = np.zeros((m, n), np.uint8)
    for j in range(n):
        H[rng.choice(m, 3, replace=False), j] = 1
    errors = (rng.random((B, n)) < p).astype(np.int8)
    residual = ((errors @ H.T) % 2).astype(np.int32)
    residual[2] = 0  # valid before any elimination
    cols = np.stack([rng.permutation(n)[:K] for _ in range(B)])
    Kp = -(-K // 32) * 32
    Hp = np.asarray(jax_gather_pack(jnp.asarray(H), jnp.asarray(cols), Kp))
    M_pad = 128
    HpT = np.pad(Hp.transpose(0, 2, 1), ((0, 0), (0, 0), (0, M_pad - m)))
    s_pad = np.pad(residual, ((0, 0), (0, M_pad - m)))
    return np.ascontiguousarray(HpT).view(np.int32), s_pad, K, m


@pytest.fixture
def jax_version(monkeypatch):
    """Run the JAX eliminator under a chosen kernel generation."""
    def run(ver, *a, **k):
        monkeypatch.setattr(jax_osd_pallas, "_KERNEL_VERSION", ver)
        jax.clear_caches()
        return [np.asarray(x) for x in
                jax_osd_pallas.eliminate_blocks(*a, interpret=True, **k)]
    yield run
    jax.clear_caches()


def _port(ver, HpT, s_pad, K, m, **kw):
    return [a.numpy() for a in PLAIN[ver](torch.as_tensor(HpT),
                                          torch.as_tensor(s_pad), K, m,
                                          **kw)]


def _assert_same(got, want, full_jordan, what):
    for name, a, b in zip(NAMES[1:], got[1:], want[1:]):
        assert np.array_equal(a, b), (what, name)
    ga, wa = got[0], want[0].view(np.int32)
    if full_jordan:
        assert np.array_equal(ga, wa), (what, "Hp")
        return
    prow = want[2]
    for b in range(len(prow)):
        for c in np.nonzero(prow[b] >= 0)[0]:
            w, bit = divmod(int(c), 32)
            assert np.array_equal((ga[b, w] >> bit) & 1,
                                  (wa[b, w] >> bit) & 1), (what, b, c)


@pytest.mark.parametrize("ver", [2, 3])
@pytest.mark.parametrize("full_jordan", [False, True])
@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_full_scan_matches_jax_version(jax_version, ver, full_jordan, kind):
    HpT, s_pad, K, m = _case(kind)
    want = jax_version(ver, jnp.asarray(HpT.view(np.uint32)),
                       jnp.asarray(s_pad), K, m, block_shots=4,
                       full_jordan=full_jordan, exit_on_valid=False)
    got = _port(ver, HpT, s_pad, K, m, full_jordan=full_jordan,
                exit_on_valid=False)
    _assert_same(got, want, full_jordan, (ver, kind))
    # and the same as K2's plain version (v1), every output
    v1 = _port(1, HpT, s_pad, K, m, full_jordan=full_jordan,
               exit_on_valid=False)
    for name, a, b in zip(NAMES, got, v1):
        assert np.array_equal(a, b), name


@pytest.mark.parametrize("ver", [2, 3])
@pytest.mark.parametrize("full_jordan", [False, True])
def test_validity_exit_matches_jax_one_shot_blocks(jax_version, ver,
                                                   full_jordan):
    HpT, s_pad, K, m = _case("wide")
    want = jax_version(ver, jnp.asarray(HpT.view(np.uint32)),
                       jnp.asarray(s_pad), K, m, block_shots=1,
                       full_jordan=full_jordan, exit_on_valid=True)
    got = _port(ver, HpT, s_pad, K, m, full_jordan=full_jordan,
                exit_on_valid=True)
    _assert_same(got, want, full_jordan, ver)


@pytest.mark.parametrize("K", [288, 286])
def test_fused_exit_trails_v1_by_under_a_group(K):
    """K4 tests the exit once per 4-column group: it stops at the first
    group end at or after K2's exit, with the consumed outputs (s_red,
    OSD-0 bits, validity) unchanged. K=286 engages the guard on the last
    group's columns past K."""
    HpT, s_pad, _, m = _case("wide")
    kw = dict(exit_on_valid=True, return_steps=True)
    v1 = _port(1, HpT, s_pad, K, m, **kw)
    v2 = _port(2, HpT, s_pad, K, m, **kw)
    assert np.array_equal(v2[5], np.minimum(K, -(-v1[5] // 4) * 4))
    assert (v2[5] > v1[5]).any() and v1[5][2] == v2[5][2] == 0
    assert np.array_equal(v1[1], v2[1])

    def osd0(out):
        """Pivot columns whose correction bit is set, per shot."""
        s, prow = out[1], out[2]
        return [{int(c) for c in np.nonzero(prow[i] >= 0)[0]
                 if s[i, prow[i, c]]} for i in range(len(s))]

    # pivots past v1's exit carry a zero correction bit
    assert osd0(v1) == osd0(v2)
    unsat = [np.where(x[3], 0, x[1]).sum(1) for x in (v1, v2)]
    assert np.array_equal(unsat[0] == 0, unsat[1] == 0)
    # with the exit off only the rank stop remains: every output but the
    # step count (still rounded up to a group end) agrees
    full = [_port(v, HpT, s_pad, K, m, exit_on_valid=False,
                  return_steps=True) for v in (1, 2)]
    for name, a, b in zip(NAMES, *full):
        assert np.array_equal(a, b), name
    assert np.array_equal(full[1][5], np.minimum(K, -(-full[0][5] // 4) * 4))


def test_dispatch_follows_kernel_version(monkeypatch):
    HpT, s_pad, K, m = _case("narrow")
    args = (torch.as_tensor(HpT), torch.as_tensor(s_pad), K, m)
    # the wrappers take G1's column layout of the same matrix
    cols = osd_cuda.words_to_columns(args[0], osd_cuda.column_stride(
        HpT.shape[1], HpT.shape[2], "cpu"))
    outs = {}
    for ver in (1, 2, 3):
        monkeypatch.setattr(osd_cuda, "_KERNEL_VERSION", ver)
        outs[ver] = osd_cuda.eliminate_blocks(cols, *args[1:],
                                              return_steps=True)
        want = PLAIN[ver](*args, return_steps=True)
        for a, b in zip(outs[ver], want):
            assert torch.equal(a, b)
    monkeypatch.setattr(osd_cuda, "_KERNEL_VERSION", 4)
    with pytest.raises(ValueError, match="QLDPC_OSD_KERNEL=4"):
        osd_cuda.eliminate_blocks(cols, *args[1:])


@pytest.fixture(scope="module")
def failed72():
    """BP-hard [[72,12,6]] shots (6 cycles, p=0.006): random LLRs around
    the BP hard decision zero, as the OSD stage sees failed shots."""
    code = get_code("[[72, 12, 6]]")
    circ = SyndromeCircuit(code, num_cycles=6)
    M = build_decoding_matrices(circ, code.Lx, code.Lz, 0.006)
    H = (np.asarray(M["HdecZ"]) != 0).astype(np.uint8)
    rng = np.random.default_rng(4)
    B = 24
    errs = (rng.random((B, H.shape[1])) < 4 * M["channel_probsZ"])
    syn = ((errs.astype(np.int64) @ H.T) % 2).astype(np.int8)
    syn[:3] = rng.integers(0, 2, syn[:3].shape)  # outside the column space
    prior = channel_llrs(M["channel_probsZ"])
    vals = (prior[None] * rng.uniform(0.2, 1.0, (B, H.shape[1]))
            ).astype(np.float32)
    k, first = M["k"], M["first_logical_rowZ"]
    HL = (np.asarray(M["HZ_full"])[first:first + k] != 0).astype(np.int64)
    lp = (HL << np.arange(k)[:, None]).sum(0).astype(np.int32)
    return dict(H=H, syn=syn, vals=vals,
                hard=np.zeros((B, H.shape[1]), np.int8), lp=lp,
                rank=rank_fast(H), basis=column_basis(H))


@pytest.mark.parametrize("ver", [1, 2, 3])
def test_osd_batch_flags_under_each_version(monkeypatch, failed72, ver):
    """The staged scan, basis rerun and order-2 reprocess through each
    eliminator give the JAX package's flags (its XLA path, which no
    eliminator version touches)."""
    d = failed72
    H = d["H"]
    K = choose_K(*H.shape, margin=128)
    kw = dict(K=K, order=2, num_test=12, rank=d["rank"])
    want = jax_osd_batch(
        jnp.asarray(H), jnp.asarray(H.T, dtype=jnp.bfloat16),
        jnp.asarray(d["syn"]), jnp.asarray(d["vals"]), jnp.asarray(d["hard"]),
        use_pallas=False, logical_pack=jnp.asarray(d["lp"]),
        basis_cols=jnp.asarray(d["basis"]), **kw)
    monkeypatch.setattr(osd_cuda, "_KERNEL_VERSION", ver)
    got = osd_batch(
        torch.as_tensor(H), torch.as_tensor(H.T.astype(np.float32)),
        torch.as_tensor(d["syn"]), torch.as_tensor(d["vals"]),
        torch.as_tensor(d["hard"]), logical_pack=torch.as_tensor(d["lp"]),
        basis_cols=torch.as_tensor(d["basis"]), **kw)
    for key in ("valid", "rank_deficient", "logical_delta_packed",
                "solution"):
        assert np.array_equal(np.asarray(want[key]), got[key].numpy()), key
    assert not got["valid"].all() and got["valid"].any()


@pytest.mark.parametrize("ver", [2, 3])
def test_osd_batch_matches_jax_pallas_version(monkeypatch, jax_version, ver):
    """End to end through the JAX package's Pallas path under the same
    eliminator generation (tests/test_osd_pallas.py's small case)."""
    rng = np.random.default_rng(11)
    m, n, B = 24, 60, 4
    H = np.zeros((m, n), np.uint8)
    for j in range(n):
        H[rng.choice(m, 3, replace=False), j] = 1
    errors = (rng.random((B, n)) < 0.12).astype(np.int8)
    syn = ((errors @ H.T) % 2).astype(np.int8)
    llr = rng.normal(2.0, 1.0, (B, n)).astype(np.float32)
    hard = np.zeros((B, n), np.int8)
    lp = rng.integers(0, 1 << 6, n).astype(np.int32)
    kw = dict(K=n, order=2, num_test=12)
    monkeypatch.setattr(jax_osd_pallas, "_KERNEL_VERSION", ver)
    elim = jax_osd_pallas.eliminate_blocks
    monkeypatch.setattr(jax_osd_pallas, "eliminate_blocks",
                        lambda *a, **k: elim(*a, **k, interpret=True))
    jax.clear_caches()
    want = jax_osd_batch(jnp.asarray(H), jnp.asarray(H.T, dtype=jnp.bfloat16),
                         jnp.asarray(syn), jnp.asarray(llr),
                         jnp.asarray(hard), use_pallas=True,
                         logical_pack=jnp.asarray(lp), **kw)
    monkeypatch.setattr(osd_cuda, "_KERNEL_VERSION", ver)
    got = osd_batch(torch.as_tensor(H), torch.as_tensor(H.T.astype(np.float32)),
                    torch.as_tensor(syn), torch.as_tensor(llr),
                    torch.as_tensor(hard), logical_pack=torch.as_tensor(lp),
                    **kw)
    for key in ("valid", "rank_deficient", "logical_delta_packed",
                "solution"):
        assert np.array_equal(np.asarray(want[key]), got[key].numpy()), key
