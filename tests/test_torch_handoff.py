"""The OSD's matrix hand-off in the column layout, on the CPU.

G1 (``csrc/gather_pack.cu``) writes the eliminators' own column bitsets:
column 32w + c of a shot is S words over the rows, S the eliminators' odd
stride. K2, K4 and K5 take that layout; their plain versions, and G1's
reference ``_gather_pack(..., words_major=True)``, work words-major. Here,
at [[72,12,6]] (6 cycles, p=0.006), exact throughout (integer bits):

* ``gather_pack_plain`` is the bit transpose of the JAX package's
  ``_gather_pack(..., words_major=True)`` (qldpc_tpu/ops/osd.py:73) at the
  stage-1, prefix and full widths, over the whole batch and a gated span
  (the numpy emulation of G1's index arithmetic is in
  tests/test_torch_pipeline.py);
* each eliminator's wrapper on column input gives every output of its
  plain version on words-major input, and no matrix without
  ``want_matrix``;
* ``osd_batch``'s column hand-off equals the words-major reference
  hand-off shot for shot, under each eliminator generation.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qldpc_tpu_torch as qt
from qldpc_tpu.ops.osd import _gather_pack as jax_gather_pack
from qldpc_tpu_torch.models.gf2 import column_basis, rank_fast
from qldpc_tpu_torch.ops import osd, osd_cuda

torch.set_num_threads(1)

WRAPPERS = {"eliminate_blocks_v1": "eliminate_blocks_plain",
            "eliminate_blocks_fused": "eliminate_blocks_fused_plain",
            "eliminate_blocks_pair": "eliminate_blocks_plain"}


@pytest.fixture(scope="module")
def c72():
    """[[72,12,6]] basis Z: H, its CSC index, 24 shots' column orders
    (seeded), their syndromes of sampled errors, the OSD's widths."""
    code = qt.get_code("[[72, 12, 6]]")
    circ = qt.SyndromeCircuit(code, num_cycles=6)
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, 0.006)
    H = (np.asarray(M["HdecZ"]) != 0).astype(np.uint8)
    m, n = H.shape
    rng = np.random.default_rng(14)
    B = 24
    order = np.stack([rng.permutation(n) for _ in range(B)])
    errs = (rng.random((B, n)) < M["channel_probsZ"]).astype(np.int8)
    K = osd.choose_K(m, n)
    basis = column_basis(H)
    full = np.concatenate([order[:, :K], np.broadcast_to(basis,
                                                         (B, len(basis)))], 1)
    widths = {"stage1": (order[:, :256], 256),
              "prefix": (order[:, :K], K),
              "full": (full, -(-full.shape[1] // 32) * 32)}
    return dict(H=H, M=M, index=osd_cuda.column_index(H), order=order,
                syn=(errs @ H.T) % 2, K=K, rank=rank_fast(H), basis=basis,
                widths=widths)


def _transpose_np(words, S):
    """(B, W, m) words-major -> (B, 32W, S) column words, bit by bit in
    numpy: word l of column 32w + c holds bit c of words[b, w, 32l + i] as
    bit i."""
    B, W, m = words.shape
    u = words.astype(np.int64) & 0xFFFFFFFF
    bits = (u[:, :, None, :] >> np.arange(32)[None, None, :, None]) & 1
    bits = bits.reshape(B, 32 * W, m)                  # [b, column, row]
    NR = -(-m // 32)
    bits = np.pad(bits, ((0, 0), (0, 0), (0, 32 * S - m)))
    cols = (bits.reshape(B, 32 * W, S, 32) << np.arange(32)).sum(-1)
    assert not cols[..., NR:].any()
    return cols.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("span", [None, (5, 19)])
@pytest.mark.parametrize("width", ["stage1", "prefix", "full"])
def test_column_gather_pack_plain_is_jax_transposed(c72, width, span):
    """gather_pack_plain on the live shots is JAX's words-major
    gather-pack transposed bit for bit; gated-off shots read zero."""
    cols, Kx = c72["widths"][width]
    H, index = c72["H"], c72["index"]
    m = H.shape[0]
    want = np.asarray(jax_gather_pack(jnp.asarray(H), jnp.asarray(cols), Kx,
                                      words_major=True)).view(np.int32)
    S = -(-m // 32) | 1
    live = None if span is None else torch.tensor(span, dtype=torch.int32)
    got = osd_cuda.gather_pack_plain(index, torch.as_tensor(cols), Kx,
                                     live=live).numpy()
    B = len(cols)
    assert got.shape == (B, Kx, S)
    lo, hi = (0, B) if span is None else span
    assert np.array_equal(got[lo:hi], _transpose_np(want[lo:hi], S))
    assert not got[:lo].any() and not got[hi:].any()
    # the wrapper's CPU path is the plain version
    assert np.array_equal(osd_cuda.gather_pack(
        index, torch.as_tensor(cols), Kx, live=live).numpy(), got)


@pytest.mark.parametrize("want_matrix", [True, False])
@pytest.mark.parametrize("full_jordan, exit_on_valid",
                         [(False, True), (False, False), (True, True)])
@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_plain_eliminators_agree_across_layouts(c72, wrapper, full_jordan,
                                                exit_on_valid, want_matrix):
    """K2's, K4's and K5's wrapper on the CPU, given G1's column layout,
    gives every output of its plain version on words-major input, on a
    gated span; without want_matrix it returns no matrix."""
    fn = getattr(osd_cuda, wrapper)
    plain = getattr(osd_cuda, WRAPPERS[wrapper])
    cols, Kx = c72["widths"]["prefix"]
    index, m = c72["index"], c72["H"].shape[0]
    cols = torch.as_tensor(cols)
    words = osd_cuda._gather_pack(index.HT, cols, Kx, words_major=True)
    colw = osd_cuda.gather_pack(index, cols, Kx)
    s = torch.as_tensor(c72["syn"], dtype=torch.int32)
    live = torch.tensor((2, 21), dtype=torch.int32)
    kw = dict(rank=c72["rank"], full_jordan=full_jordan,
              exit_on_valid=exit_on_valid, return_steps=True, live=live)
    a = plain(words, s, Kx, m, **kw)
    b = fn(colw, s, Kx, m, want_matrix=want_matrix, **kw)
    if not want_matrix:
        assert b[0] is None
        a, b = a[1:], b[1:]
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        fn(colw[:, :, :-1], s, Kx, m)                # not the stride
    with pytest.raises(ValueError):
        fn(words, s, Kx, m)                          # words-major input


@pytest.mark.parametrize("version", [1, 2, 3])
def test_osd_batch_layouts_agree(c72, monkeypatch, version):
    """osd_batch through the column hand-off equals the words-major
    reference hand-off (``_gather_pack(..., words_major=True)`` into the
    plain eliminator) shot for shot (staged scan, basis rerun, order-2
    reprocess, a live prefix), under K2, K4 and K5's plain versions."""
    monkeypatch.setattr(osd_cuda, "_KERNEL_VERSION", version)
    H = torch.as_tensor(c72["H"])
    m, n = H.shape
    rng = np.random.default_rng(version)
    B = 40
    llr = torch.as_tensor(rng.standard_normal((B, n)) * 3,
                          dtype=torch.float32)
    hard = (llr < 0).to(torch.int8)
    syn = torch.as_tensor(c72["syn"][np.arange(B) % len(c72["syn"])])
    common = dict(H=H, HT=H.T.float().contiguous(), syndrome=syn, llr=llr,
                  hard=hard, K=c72["K"], order=2, num_test=12,
                  rank=c72["rank"], basis_cols=torch.as_tensor(c72["basis"]),
                  stage1_cols=256, n_live=torch.tensor(33),
                  col_index=c72["index"])
    a = osd.osd_batch(**common)
    plain = {1: osd_cuda.eliminate_blocks_plain,
             2: osd_cuda.eliminate_blocks_fused_plain,
             3: osd_cuda.eliminate_blocks_plain}[version]

    def pack_words(index, cols, Kp, live=None):
        lo, hi = osd_cuda._live_bounds(live, len(cols))
        out = torch.zeros((len(cols), Kp // 32, index.m), dtype=torch.int32)
        out[lo:hi] = osd_cuda._gather_pack(index.HT, cols[lo:hi], Kp,
                                           words_major=True)
        return out

    def eliminate_words(Hp, s, K, m, want_matrix=True, **kw):
        out = plain(Hp, s, K, m, **kw)
        return out if want_matrix else (None,) + out[1:]

    monkeypatch.setattr(osd, "gather_pack", pack_words)
    monkeypatch.setattr(osd, "eliminate_blocks", eliminate_words)
    b = osd.osd_batch(**common)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k][:33], b[k][:33]), k
    assert a["valid"][:33].any() and not a["reprocess_overflow"].any()
