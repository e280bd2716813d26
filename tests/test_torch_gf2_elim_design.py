"""Kernel K2's design, held on the CPU.

K2 (qldpc_tpu_torch/csrc/gf2_elim.cu) runs a team of warps per shot over
the shot's matrix held column-major: column j is ceil(M/32) words over the
rows, lane l owns row words l, l + 32, ..., and the row state (used rows,
the residual syndrome, rows < m) lives as bitmasks. A column step XORs the
pivot column's other rows into every other column the pivot row touches,
then writes the pivot column as the pivot's unit column. It takes G1's
column layout (``gather_pack``) as it is, a straight copy, and sends the
reduced matrix out words-major by a 32x32 bit transpose of five butterfly
rounds. The kernel itself runs only on the card; here its transpose and
its column steps, written out in PyTorch and vectorised over shots, are
held against the plain version (``eliminate_blocks_plain``, words-major):

* the transpose round-trips words to column bitsets and back exactly, and
  its column words hold the right bits, for ragged M and M > m;
* the transpose maps words to exactly G1's column layout (the plain
  ``words_to_columns``), so the store is the inverse of G1's layout;
* the column-bitset algorithm on G1's column layout equals the plain
  version on the same matrix words-major, on every output.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.models.gf2 import rank_fast
from qldpc_tpu_torch.ops.osd import _gather_pack, choose_K
from qldpc_tpu_torch.ops.osd_cuda import (column_index, columns_to_words,
                                          eliminate_blocks_plain,
                                          gather_pack, prow_of_col_from,
                                          words_to_columns)

torch.set_num_threads(1)

MASK32 = 0xFFFFFFFF
LANE = torch.arange(32)
# (shuffle distance j, bits c with (c & j) == 0), as transpose32 in the .cu
BUTTERFLY = ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F),
             (2, 0x33333333), (1, 0x55555555))
BIT = torch.ones(32, dtype=torch.int64) << torch.arange(32)
NAMES = ("Hp", "s_red", "prow_of_col", "used", "colofrow", "steps")


def transpose32(x):
    """The kernel's warp transpose on (..., 32) lane words (int64 holding
    32 bits): lane i holding row i becomes lane i holding column i."""
    for j, mk in BUTTERFLY:
        y = x[..., LANE ^ j]                       # __shfl_xor_sync
        x = torch.where((LANE & j) != 0,
                        (x & (MASK32 ^ mk)) | ((y >> j) & mk),
                        (x & mk) | ((y << j) & (MASK32 ^ mk)))
    return x


def to_int32(x):
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def to_columns(Hp):
    """(B, W, M) int32 words -> (B, 32W, S) column words as the kernel lays
    them out: word l of column 32w + c holds rows 32l..32l+31; the stride S
    is ceil(M/32) made odd (its pad word stays 0)."""
    B, W, M = Hp.shape
    NR = -(-M // 32)
    x = F.pad(Hp.to(torch.int64) & MASK32, (0, 32 * NR - M))
    t = transpose32(x.view(B, W, NR, 32))          # lane = column in word
    cols = t.permute(0, 1, 3, 2).reshape(B, 32 * W, NR)
    return F.pad(cols, (0, (NR | 1) - NR))


def from_columns(cols, M: int):
    B, C, _ = cols.shape
    NR = -(-M // 32)
    t = cols[..., :NR].reshape(B, C // 32, 32, NR).permute(0, 1, 3, 2)
    return to_int32(transpose32(t).reshape(B, C // 32, 32 * NR)[..., :M])


def pack_rows(bits):
    """(B, 32*NR) bool over rows -> (B, NR) words, bit i of word l = row
    32l + i."""
    B = bits.shape[0]
    return (bits.view(B, -1, 32).to(torch.int64) * BIT).sum(-1)


def eliminate_columns(Hp, s, K: int, m: int, rank: int = None,
                      full_jordan: bool = False, exit_on_valid: bool = True):
    """K2's column steps (csrc/gf2_elim.cu), all shots at once, from G1's
    column layout Hp (B, 32W, S), copied as it is; returns
    eliminate_blocks' outputs with steps, the matrix words-major."""
    B, M = s.shape
    rank = m if rank is None else rank
    NR = -(-M // 32)
    cols = Hp.to(torch.int64) & MASK32
    rows = torch.arange(32 * NR)
    valid = pack_rows((rows < m).expand(B, -1))
    sres = pack_rows(F.pad(s != 0, (0, 32 * NR - M)))
    used = torch.zeros((B, NR), dtype=torch.int64)
    cf = torch.full((B, M), -1, dtype=torch.int32)
    npiv = torch.zeros(B, dtype=torch.int64)
    steps = torch.zeros(B, dtype=torch.int32)
    done = torch.zeros(B, dtype=torch.bool)
    if exit_on_valid:
        done = ((sres & valid) == 0).all(1)
    bidx = torch.arange(B)
    for col in range(K):
        if bool(done.all()):
            break
        act = ~done
        steps += act.to(torch.int32)
        cw = cols[:, col, :NR]
        cand = torch.where(act[:, None], cw & (MASK32 ^ used) & valid, 0)
        has = (cand != 0).any(1)
        pq = (cand != 0).to(torch.int64).argmax(1)       # ballot + ffs
        c = cand[bidx, pq]
        pbit = c & -c                                    # lowest row
        pr = ((pbit[:, None] >> LANE) & 1).argmax(1)
        own = torch.zeros_like(used)
        own[bidx, pq] = pbit
        elim = torch.where(has[:, None], cw & (MASK32 ^ own), 0)
        ps = (sres[bidx, pq] >> pr) & 1
        sres = sres ^ torch.where((ps == 1)[:, None], elim, 0)
        used = used | own
        cf[bidx[has], (32 * pq + pr)[has]] = col
        # the pivot row's bit in every column from the pivot's word on,
        # column col left out: it becomes the pivot's unit column after
        # the step's barrier
        prow = (cols[bidx, :, pq] >> pr[:, None]) & 1    # (B, 32W)
        prow[:, :0 if full_jordan else 32 * (col // 32)] = 0
        prow[:, col] = 0
        cols[..., :NR] ^= torch.where(prow[:, :, None] == 1,
                                      elim[:, None, :], 0)
        cols[has, col, :NR] = own[has]
        npiv += has.to(torch.int64)
        stop = npiv >= rank
        if exit_on_valid:
            stop |= ((sres & (MASK32 ^ used) & valid) == 0).all(1)
        done = done | stop
    s_out = ((sres[:, :, None] >> LANE) & 1).reshape(B, -1)[:, :M]
    return (from_columns(cols, M), s_out.to(torch.int32),
            prow_of_col_from(cf, K), cf >= 0, cf, steps)


@pytest.fixture(scope="module")
def c72():
    """[[72,12,6]] (6 cycles, p=0.006) basis-Z shots: syndromes of sampled
    errors, a random column order per shot, packed as the OSD packs them."""
    code = qt.get_code("[[72, 12, 6]]")
    circ = qt.SyndromeCircuit(code, num_cycles=6)
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, 0.006)
    H = (np.asarray(M["HdecZ"]) != 0).astype(np.uint8)
    rng = np.random.default_rng(7)
    B = 12
    errs = (rng.random((B, H.shape[1])) < M["channel_probsZ"]).astype(np.int8)
    syn = torch.as_tensor((errs @ H.T) % 2, dtype=torch.int32)
    syn[3] = 0                                   # valid before any step
    cols = torch.as_tensor(np.stack([rng.permutation(H.shape[1])
                                     for _ in range(B)]))
    HT = torch.as_tensor(H.T.copy())
    K = choose_K(*H.shape)
    return dict(H=H, syn=syn, K=K, rank=rank_fast(H), cols=cols,
                Hp={Kx: _gather_pack(HT, cols[:, :Kx], Kx, words_major=True)
                    for Kx in (256, K)})


def _check(Hp, s, K, m, **kw):
    """The column steps on words-major Hp's column layout against the
    plain version on Hp."""
    S = -(-Hp.shape[2] // 32) | 1
    got = eliminate_columns(words_to_columns(Hp, S), s, K, m, **kw)
    want = eliminate_blocks_plain(Hp, s, K, m, return_steps=True, **kw)
    for name, x, y in zip(NAMES, got, want):
        assert torch.equal(x, y), name
    return got


@pytest.mark.parametrize("M, W", [(1008, 2), (100, 3), (2100, 1), (64, 2)])
def test_transpose_round_trips(M, W):
    """Ragged M (1008 rows are 31.5 words), a few rows, three words a lane
    (2100 rows), and a whole number of words."""
    rng = np.random.default_rng(M)
    Hp = torch.as_tensor(rng.integers(-2**31, 2**31, (2, W, M)),
                         dtype=torch.int32)
    cols = to_columns(Hp)
    NR = -(-M // 32)
    assert cols.shape == (2, 32 * W, NR | 1)
    assert not cols[..., NR:].any()              # the stride's pad word
    assert torch.equal(from_columns(cols, M), Hp)
    # column 32w + c, word l, bit i is row 32l + i's bit c of word w
    bits = (Hp.to(torch.int64)[:, :, None, :] >> LANE[:, None]) & 1
    bits = F.pad(bits.reshape(2, 32 * W, M), (0, 32 * NR - M))
    assert torch.equal(pack_rows(bits.reshape(-1, 32 * NR))
                       .view(2, 32 * W, NR), cols[..., :NR])


def test_transpose_is_an_involution_of_bit_matrices():
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.integers(0, 2**32, (5, 32)), dtype=torch.int64)
    t = transpose32(x)
    a = (x[:, :, None] >> LANE) & 1                 # a[., row, col]
    assert torch.equal((t[:, :, None] >> LANE) & 1, a.transpose(1, 2))
    assert torch.equal(transpose32(t), x)


@pytest.mark.parametrize("full_jordan", [False, True])
@pytest.mark.parametrize("exit_on_valid", [False, True])
@pytest.mark.parametrize("width", ["stage1", "full"])
def test_column_steps_match_plain(c72, width, exit_on_valid, full_jordan):
    """256 columns (stage 1) and the whole K, at the code's rank (< m)."""
    K = 256 if width == "stage1" else c72["K"]
    m = c72["H"].shape[0]
    assert c72["rank"] < m
    got = _check(c72["Hp"][K], c72["syn"], K, m, rank=c72["rank"],
                 full_jordan=full_jordan, exit_on_valid=exit_on_valid)
    steps = got[5]
    if exit_on_valid:
        assert steps[3] == 0 and (steps > 0).any()


def test_column_steps_rank_exit(c72):
    """A rank far below m stops every shot at that many pivots."""
    m = c72["H"].shape[0]
    got = _check(c72["Hp"][256], c72["syn"], 256, m, rank=40,
                 exit_on_valid=False)
    assert (got[3].sum(1) == 40).all()


def test_column_steps_rows_past_m(c72):
    """M > m: rows at or past m carry bits and residuals, are XORed and
    never pivot."""
    rng = np.random.default_rng(3)
    Hp, s = c72["Hp"][256], c72["syn"]
    B, W, m = Hp.shape
    extra = 37
    Hp = torch.cat([Hp, torch.as_tensor(
        rng.integers(-2**31, 2**31, (B, W, extra)), dtype=torch.int32)], 2)
    s = torch.cat([s, torch.as_tensor(rng.integers(0, 2, (B, extra)),
                                      dtype=torch.int32)], 1)
    for exit_on_valid in (False, True):
        got = _check(Hp, s, 256, m, rank=c72["rank"],
                     exit_on_valid=exit_on_valid)
        assert not got[3][:, m:].any()


@pytest.mark.parametrize("full_jordan", [False, True])
def test_column_steps_three_words_a_lane(full_jordan):
    """A synthetic 2100-row matrix: 66 row words, so a lane holds 3 (R = 3,
    as at [[288,12,18]]); 2090 rows may pivot."""
    rng = np.random.default_rng(11)
    B, W, M, m = 4, 2, 2100, 2090
    bits = rng.random((B, 32 * W, M)) < 0.01
    words = (bits.reshape(B, W, 32, M).astype(np.int64)
             << np.arange(32)[None, None, :, None]).sum(2)
    Hp = to_int32(torch.as_tensor(words))
    s = torch.as_tensor(rng.integers(0, 2, (B, M)), dtype=torch.int32)
    for exit_on_valid in (False, True):
        got = _check(Hp, s, 64, m, full_jordan=full_jordan,
                     exit_on_valid=exit_on_valid)
        assert (got[5] > 0).all() and got[3].any()


@pytest.mark.parametrize("M, W", [(1008, 2), (100, 3), (2100, 1), (64, 2)])
def test_transpose_gives_the_column_layout(M, W):
    """The kernel's transpose maps words to G1's column layout (the plain
    words_to_columns at the kernel's stride) word for word, so its store is
    that layout's inverse."""
    rng = np.random.default_rng(M + W)
    Hp = torch.as_tensor(rng.integers(-2**31, 2**31, (3, W, M)),
                         dtype=torch.int32)
    S = -(-M // 32) | 1
    assert torch.equal(to_int32(to_columns(Hp)), words_to_columns(Hp, S))


@pytest.mark.parametrize("full_jordan", [False, True])
@pytest.mark.parametrize("width", ["stage1", "full"])
def test_column_steps_from_column_input(c72, width, full_jordan):
    """The copied load: K2's column steps from G1's column layout (an odd
    batch) equal the plain version on every output."""
    K = 256 if width == "stage1" else c72["K"]
    H = c72["H"]
    m = H.shape[0]
    cols = gather_pack(column_index(H), c72["cols"][:11, :K], K)
    assert cols.shape[0] == 11
    s = c72["syn"][:11]
    kw = dict(rank=c72["rank"], full_jordan=full_jordan)
    got = eliminate_columns(cols, s, K, m, **kw)
    want = eliminate_blocks_plain(columns_to_words(cols, s.shape[1]), s, K,
                                  m, return_steps=True, **kw)
    for name, x, y in zip(NAMES, got, want):
        assert torch.equal(x, y), name
