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
