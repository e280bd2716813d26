"""Kernel K5's design, held on the CPU.

K5 (qldpc_tpu_torch/csrc/gf2_elim_pair.cu) runs K2's column-bitset layout
with one team of warps carrying two adjacent shots of the batch. Both shots
sit at the same column while both run, so the team's loop runs one double
step a column (both columns read, both pivots found, both pivot rows' bits
read, one XOR pass drawing from either shot, one barrier); once one shot
stops, the other goes on alone through K2's column step. The last team of
an odd batch carries one shot, stopped from the start. Here the team's
loop, written out in PyTorch on the column layout over all pairs at once,
is held against the plain version (``eliminate_blocks_plain``) on every
output, ``steps`` included: the pair phases (double steps, then one shot
alone, then the team's exit), each shot's step count, the phantom shot of
an odd batch and shots that stop hundreds of columns apart.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from qldpc_tpu_torch.ops.osd_cuda import (eliminate_blocks_plain,
                                          prow_of_col_from)
from test_torch_gf2_elim_design import (LANE, MASK32, NAMES, c72,  # noqa: F401
                                        from_columns, pack_rows, to_columns,
                                        to_int32)

torch.set_num_threads(1)


def eliminate_pairs(Hp, s, K: int, m: int, rank: int = None,
                    full_jordan: bool = False, exit_on_valid: bool = True):
    """K5's double steps (csrc/gf2_elim_pair.cu), every team at once; team
    p carries shots 2p and 2p + 1 (a phantom for an odd batch). Returns
    eliminate_blocks' outputs with steps for the B real shots."""
    B, W, M = Hp.shape
    rank = m if rank is None else rank
    P = -(-B // 2)
    N = 2 * P
    NR = -(-M // 32)
    cols = to_columns(F.pad(Hp, (0, 0, 0, 0, 0, N - B)))
    s = F.pad(s, (0, 0, 0, N - B))
    rows = torch.arange(32 * NR)
    valid = pack_rows((rows < m).expand(N, -1))
    sres = pack_rows(F.pad(s != 0, (0, 32 * NR - M)))
    used = torch.zeros((N, NR), dtype=torch.int64)
    cf = torch.full((N, M), -1, dtype=torch.int32)
    npiv = torch.zeros(N, dtype=torch.int64)
    nstep = torch.zeros(N, dtype=torch.int32)
    done = torch.arange(N) >= B                 # the phantom never runs
    if exit_on_valid:
        done |= ((sres & valid) == 0).all(1)
    bidx = torch.arange(N)
    phase = torch.zeros(P, dtype=torch.int64)   # 0 both run, 1 one, 2 none
    for col in range(K):
        runs = (~done).view(P, 2).sum(1)
        new_phase = 2 - runs
        assert (new_phase >= phase).all()       # a team never goes back
        phase = new_phase
        if bool((phase == 2).all()):
            break                               # every team left its loop
        # phase 0: a double step on both shots; phase 1: K2's column step on
        # the shot still running; a stopped shot takes no step
        live = ~done
        nstep += live.to(torch.int32)
        cw = torch.where(live[:, None], cols[:, col, :NR], 0)
        cand = cw & (MASK32 ^ used) & valid
        has = (cand != 0).any(1)
        pq = (cand != 0).to(torch.int64).argmax(1)
        c = cand[bidx, pq]
        pbit = c & -c
        pr = ((pbit[:, None] >> LANE) & 1).argmax(1)
        own = torch.zeros_like(used)
        own[bidx, pq] = pbit
        elim = cw & (MASK32 ^ own)
        ps = (sres[bidx, pq] >> pr) & 1
        sres = sres ^ torch.where(((ps == 1) & has)[:, None], elim, 0)
        used = used | own
        cf[bidx[has], (32 * pq + pr)[has]] = col
        # both shots' pivot-row bits: a shot without a pivot gets no mask
        prow = ((cols[bidx, :, pq] >> pr[:, None]) & 1) * has[:, None]
        prow[:, :0 if full_jordan else 32 * (col // 32)] = 0
        prow[:, col] = 0
        cols[..., :NR] ^= torch.where(prow[:, :, None] == 1,
                                      elim[:, None, :], 0)
        cols[has, col, :NR] = own[has]           # the owner's unit writes
        npiv += has.to(torch.int64)
        stop = npiv >= rank
        if exit_on_valid:
            stop |= ((sres & (MASK32 ^ used) & valid) == 0).all(1)
        done = done | stop
    s_out = ((sres[:, :, None] >> LANE) & 1).reshape(N, -1)[:, :M]
    out = (from_columns(cols, M), s_out.to(torch.int32),
           prow_of_col_from(cf, K), cf >= 0, cf, nstep)
    return tuple(x[:B] for x in out)


def _check(Hp, s, K, m, **kw):
    got = eliminate_pairs(Hp, s, K, m, **kw)
    want = eliminate_blocks_plain(Hp, s, K, m, return_steps=True, **kw)
    for name, x, y in zip(NAMES, got, want):
        assert torch.equal(x, y), name
    return got


@pytest.mark.parametrize("full_jordan", [False, True])
@pytest.mark.parametrize("exit_on_valid", [False, True])
@pytest.mark.parametrize("B", [12, 11])
def test_pairs_match_plain(c72, B, exit_on_valid, full_jordan):
    """The whole K at the code's rank; an odd batch's last team carries one
    shot."""
    K, m = c72["K"], c72["H"].shape[0]
    _check(c72["Hp"][K][:B], c72["syn"][:B], K, m, rank=c72["rank"],
           full_jordan=full_jordan, exit_on_valid=exit_on_valid)


def test_pairs_exit_hundreds_of_columns_apart(c72):
    """Each pair holds a shot that stops at once (zero residual) beside one
    with a random syndrome, which runs hundreds of columns, to the rank or
    the last column: the running shot's steps go on alone."""
    K, m = c72["K"], c72["H"].shape[0]
    rng = np.random.default_rng(21)
    s = c72["syn"].clone()
    s[1::2] = torch.as_tensor(rng.integers(0, 2, s[1::2].shape),
                              dtype=torch.int32)
    s[0::2] = 0
    got = _check(c72["Hp"][K], s, K, m, rank=c72["rank"])
    steps = got[5].view(-1, 2)
    assert not steps[:, 0].any() and int(steps[:, 1].min()) >= 100


def test_pairs_ragged_rows_past_m(c72):
    """M > m and no whole number of words; an odd batch."""
    rng = np.random.default_rng(4)
    Hp, s = c72["Hp"][256][:7], c72["syn"][:7]
    B, W, m = Hp.shape
    extra = 45
    Hp = torch.cat([Hp, torch.as_tensor(
        rng.integers(-2**31, 2**31, (B, W, extra)), dtype=torch.int32)], 2)
    s = torch.cat([s, torch.as_tensor(rng.integers(0, 2, (B, extra)),
                                      dtype=torch.int32)], 1)
    for exit_on_valid in (False, True):
        got = _check(Hp, s, 256, m, rank=c72["rank"],
                     exit_on_valid=exit_on_valid)
        assert not got[3][:, m:].any()


def test_pairs_three_words_a_lane():
    """A synthetic 2100-row matrix (R = 3 words a lane, as at
    [[288,12,18]]), an odd batch of 5."""
    rng = np.random.default_rng(17)
    B, W, M, m = 5, 2, 2100, 2090
    bits = rng.random((B, 32 * W, M)) < 0.01
    words = (bits.reshape(B, W, 32, M).astype(np.int64)
             << np.arange(32)[None, None, :, None]).sum(2)
    Hp = to_int32(torch.as_tensor(words))
    s = torch.as_tensor(rng.integers(0, 2, (B, M)), dtype=torch.int32)
    for exit_on_valid in (False, True):
        got = _check(Hp, s, 64, m, exit_on_valid=exit_on_valid)
        assert (got[5] > 0).all() and got[3].any()
