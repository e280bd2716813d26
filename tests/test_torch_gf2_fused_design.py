"""Kernel K4's design, held on the CPU.

K4 (qldpc_tpu_torch/csrc/gf2_elim_fused.cu) runs K2's column-bitset layout
and team of warps per shot, four pivots per team barrier. A 4-column group:
every warp reads the four columns into registers; the four pivots are
chosen one after another from registers, pivot i's elim_i (its column
without the pivot row) XORed into each group column not yet pivoted whose
pivot-row bit is set, and the bit p_i of each earlier elim_l kept as
corr[i] bit l; the tail columns' pivot-row bits are read against the
pre-group state and corrected in pivot order,

    mask_i ^= XOR over l < i of (corr[i] bit l ? mask_l : 0);

one fused pass XORs into every tail column in the union of the masks the
elim_i whose mask holds it, the group's own columns left out; after the
barrier the four group columns are written from registers (a pivot column
as its unit column). The exit is tested once per group. The kernel runs
only on the card; here its group algebra, written out in PyTorch on the
column layout and vectorised over shots, is held against its plain version
(``eliminate_blocks_fused_plain``) on every output, ``steps`` included.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from qldpc_tpu_torch.ops.osd_cuda import (eliminate_blocks_fused_plain,
                                          prow_of_col_from)
from test_torch_gf2_elim_design import (LANE, MASK32, NAMES, c72,  # noqa: F401
                                        from_columns, pack_rows, to_columns,
                                        to_int32)

torch.set_num_threads(1)

GROUP = 4  # GF2_GROUP


def eliminate_fused_columns(Hp, s, K: int, m: int, rank: int = None,
                            full_jordan: bool = False,
                            exit_on_valid: bool = True):
    """K4's groups (csrc/gf2_elim_fused.cu, steps 1-5 of its design), all
    shots at once; returns eliminate_blocks' outputs with steps."""
    B, W, M = Hp.shape
    rank = m if rank is None else rank
    NR = -(-M // 32)
    C = 32 * W
    cols = to_columns(Hp)
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
    for col in range(0, K, GROUP):
        if bool(done.all()):
            break
        act = ~done               # a stopped shot's team has left its loop
        steps += act.to(torch.int32) * min(GROUP, K - col)
        # 1. the group's columns in registers; a pivoted one becomes its elim
        gw = cols[:, col:col + GROUP, :NR].clone()
        has = torch.zeros((B, GROUP), dtype=torch.bool)
        pq = torch.zeros((B, GROUP), dtype=torch.int64)   # 0 for none
        pr = torch.zeros((B, GROUP), dtype=torch.int64)
        pb = torch.zeros((B, GROUP), dtype=torch.int64)
        corr = torch.zeros((B, GROUP), dtype=torch.int64)
        # 2. the pivots, one after another
        for i in range(min(GROUP, K - col)):
            cand = torch.where(act[:, None],
                               gw[:, i] & (MASK32 ^ used) & valid, 0)
            h = (cand != 0).any(1)
            q = (cand != 0).to(torch.int64).argmax(1)    # ballot + ffs
            c = cand[bidx, q]
            pbit = c & -c
            r = ((pbit[:, None] >> LANE) & 1).argmax(1)
            own = torch.zeros_like(used)
            own[bidx, q] = pbit
            gw[:, i] &= MASK32 ^ own                      # elim_i
            ps = (sres[bidx, q] >> r) & 1
            sres = sres ^ torch.where(((ps == 1) & h)[:, None], gw[:, i], 0)
            used = used | own
            cf[bidx[h], (32 * q + r)[h]] = col + i
            for j in range(GROUP):
                if j == i:
                    continue
                bit = ((gw[bidx, j, q] >> r) & 1) * h
                if j < i:   # a pivot column (a unit): keep elim_j's bit
                    corr[:, i] |= torch.where(has[:, j], bit << j, 0)
                    upd = (bit == 1) & ~has[:, j]
                else:
                    upd = bit == 1
                gw[:, j] ^= torch.where(upd[:, None], gw[:, i], 0)
            has[:, i], pq[:, i], pr[:, i], pb[:, i] = h, q, r, pbit
            npiv += h.to(torch.int64)
        # 3. tail masks against the pre-group state, corrected in pivot order
        lo = 0 if full_jordan else 32 * (col // 32)
        mk = []
        for i in range(GROUP):
            bits = (cols[bidx, :, pq[:, i]] >> pr[:, i, None]) & 1   # (B, C)
            bits = torch.where(has[:, i, None], bits, 0)
            bits[:, :lo] = 0
            bits[:, col:col + GROUP] = 0   # the group's own: in registers
            for l in range(i):
                bits ^= torch.where(((corr[:, i] >> l) & 1)[:, None] == 1,
                                    mk[l], 0)
            mk.append(bits)
        # 4. one fused pass: each tail column XORed once
        e = torch.zeros((B, C, NR), dtype=torch.int64)
        for i in range(GROUP):
            e ^= torch.where(mk[i][:, :, None] == 1, gw[:, i][:, None, :], 0)
        cols[..., :NR] ^= e
        # 5. after the barrier: the group columns from registers
        for i in range(GROUP):
            unit = torch.zeros((B, NR), dtype=torch.int64)
            unit[bidx, pq[:, i]] = pb[:, i]
            new = torch.where(has[:, i, None], unit, gw[:, i])
            cols[:, col + i, :NR] = torch.where(act[:, None], new,
                                                cols[:, col + i, :NR])
        stop = npiv >= rank
        if exit_on_valid:
            stop |= ((sres & (MASK32 ^ used) & valid) == 0).all(1)
        done = done | (act & stop)
    assert C >= K
    s_out = ((sres[:, :, None] >> LANE) & 1).reshape(B, -1)[:, :M]
    return (from_columns(cols, M), s_out.to(torch.int32),
            prow_of_col_from(cf, K), cf >= 0, cf, steps)


def _check(Hp, s, K, m, **kw):
    got = eliminate_fused_columns(Hp, s, K, m, **kw)
    want = eliminate_blocks_fused_plain(Hp, s, K, m, return_steps=True, **kw)
    for name, x, y in zip(NAMES, got, want):
        assert torch.equal(x, y), name
    return got


@pytest.mark.parametrize("full_jordan", [False, True])
@pytest.mark.parametrize("exit_on_valid", [False, True])
@pytest.mark.parametrize("width", ["stage1", "prefix"])
def test_groups_match_plain(c72, width, exit_on_valid, full_jordan):
    """256 columns (stage 1) and the whole K (prefix), at the code's rank."""
    K = 256 if width == "stage1" else c72["K"]
    m = c72["H"].shape[0]
    got = _check(c72["Hp"][K], c72["syn"], K, m, rank=c72["rank"],
                 full_jordan=full_jordan, exit_on_valid=exit_on_valid)
    if exit_on_valid:
        assert got[5][3] == 0 and (got[5] > 0).any()


@pytest.mark.parametrize("K", [254, 253, 97])
def test_groups_K_not_a_multiple_of_4(c72, K):
    """The last group holds 2, 1 or 3 columns below K: the columns at or
    beyond K are carried and updated but never pivot."""
    m = c72["H"].shape[0]
    Hp = c72["Hp"][256]
    for exit_on_valid in (False, True):
        got = _check(Hp, c72["syn"], K, m, rank=c72["rank"],
                     exit_on_valid=exit_on_valid)
        assert int(got[5].max()) <= K
        assert not (got[4] >= K).any()


def test_groups_rank_exit(c72):
    """The rank is tested once per group: a shot may pass it by up to 3."""
    m = c72["H"].shape[0]
    got = _check(c72["Hp"][256], c72["syn"], 256, m, rank=41,
                 exit_on_valid=False)
    npiv = got[3].sum(1)
    assert (npiv >= 41).all() and (npiv <= 44).all() and (npiv > 41).any()


def test_groups_ragged_rows_past_m(c72):
    """M > m and no whole number of words: rows at or past m carry bits
    and residuals, are XORed and never pivot."""
    rng = np.random.default_rng(5)
    Hp, s = c72["Hp"][256], c72["syn"]
    B, W, m = Hp.shape
    extra = 45
    Hp = torch.cat([Hp, torch.as_tensor(
        rng.integers(-2**31, 2**31, (B, W, extra)), dtype=torch.int32)], 2)
    s = torch.cat([s, torch.as_tensor(rng.integers(0, 2, (B, extra)),
                                      dtype=torch.int32)], 1)
    for exit_on_valid in (False, True):
        got = _check(Hp, s, 254, m, rank=c72["rank"],
                     exit_on_valid=exit_on_valid)
        assert not got[3][:, m:].any()


@pytest.mark.parametrize("full_jordan", [False, True])
def test_groups_three_words_a_lane(full_jordan):
    """A dense synthetic 2100-row matrix (R = 3 words a lane, as at
    [[288,12,18]]): later pivot rows are often hit by earlier pivots of
    the same group, so every correction path of the masks runs."""
    rng = np.random.default_rng(13)
    B, W, M, m = 4, 2, 2100, 2090
    bits = rng.random((B, 32 * W, M)) < 0.05
    words = (bits.reshape(B, W, 32, M).astype(np.int64)
             << np.arange(32)[None, None, :, None]).sum(2)
    Hp = to_int32(torch.as_tensor(words))
    s = torch.as_tensor(rng.integers(0, 2, (B, M)), dtype=torch.int32)
    for exit_on_valid in (False, True):
        got = _check(Hp, s, 62, m, full_jordan=full_jordan,
                     exit_on_valid=exit_on_valid)
        assert (got[5] > 0).all() and got[3].any()
