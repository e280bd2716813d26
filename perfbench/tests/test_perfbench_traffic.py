"""The draws: the same (seed, dispatch) gives the same inputs, any large
seed works, and the noise rate is the traffic's."""
import torch

from perfbench.traffic import Draws, dispatch_seed


def test_same_seed_same_draws():
    a, b = Draws(2**31 + 5, 0.01, 64, 2, 500, "cpu"), \
        Draws(2**31 + 5, 0.01, 64, 2, 500, "cpu")
    for x, y in zip(a(3), b(3)):
        assert all(torch.equal(u, v) for u, v in zip(x, y))
    assert not torch.equal(a(3)[0][0], a(4)[0][0])
    assert not torch.equal(a(3)[0][0], a(3)[1][0])


def test_seeds_any_integer():
    seeds = {dispatch_seed(s, 0) for s in (0, 1, 2**31 + 1, 2**40, -7)}
    assert len(seeds) == 5 and all(0 <= s < 2**64 for s in seeds)


def test_rates():
    err, pauli, cat2 = Draws(9, 0.02, 256, 1, 4000, "cpu")(0)[0]
    assert abs(err.float().mean().item() - 0.02) < 0.002
    assert set(pauli.unique().tolist()) == {0, 1, 2}
    assert set(cat2.unique().tolist()) == set(range(15))


def test_code_zero_draws_the_stream_of_one_code():
    """Code 0's draws are those of (seed, dispatch) alone, as a
    configuration of one code drew them before codes were counted; a
    further code draws another stream, again the same for the same
    (seed, dispatch, code)."""
    from perfbench.traffic import _MASK, _mix
    seed, index = 2**33 + 17, 5
    one = Draws(seed, 0.01, 64, 2, 500, "cpu")
    zero = Draws(seed, 0.01, 64, 2, 500, "cpu", code=0)
    g = torch.Generator().manual_seed(_mix((seed & _MASK) ^ _mix(index)))
    err = torch.rand((64, 500), generator=g) < 0.01
    assert torch.equal(one(index)[0][0], err)
    for x, y in zip(one(index), zero(index)):
        assert all(torch.equal(u, v) for u, v in zip(x, y))
    other = Draws(seed, 0.01, 64, 2, 500, "cpu", code=1)
    assert not torch.equal(other(index)[0][0], err)
    assert torch.equal(other(index)[0][0],
                       Draws(seed, 0.01, 64, 2, 500, "cpu", code=1)(index)
                       [0][0])
    assert len({dispatch_seed(seed, index, c) for c in range(4)}
               | {dispatch_seed(seed, i) for i in range(4)}) == 8
