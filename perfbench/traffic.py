"""The one traffic generator: each dispatch's per-round draws from the seed.

A traffic mix (``traffic/<name>.json``) states the noise rate ``p`` of the
circuit-level depolarizing channel. Every gate location of every trial
errs with probability ``p``; an erring idle takes X, Y or Z, and an erring
CNOT one of the 15 non-identity two-qubit Paulis, uniformly. Code ``c``
of a configuration (0 for a configuration of one code) draws dispatch
``i``'s rounds from a generator on the device seeded by (seed, i, c) alone
(:func:`dispatch_seed`; code 0's seed is that of (seed, i), so a
configuration of one code and the first code of several draw one stream),
so any dispatch can be drawn again, to replay it or to judge it, and a
change to the program's own random numbers cannot change what is decoded.
"""
from __future__ import annotations

import torch

_MASK = (1 << 64) - 1


def _mix(x: int) -> int:
    """SplitMix64's finaliser."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def dispatch_seed(seed: int, index: int, code: int = 0) -> int:
    """The generator seed of code ``code``'s draws for dispatch ``index``
    of a run seeded ``seed`` (any integer): code 0's is (seed, index)'s,
    each further code's that mixed again with the code."""
    s = _mix((seed & _MASK) ^ _mix(index))
    return _mix(s ^ _mix(code)) if code else s


class Draws:
    """``draws(i)`` -> code ``code``'s rounds of dispatch i, a list of
    (err (B, L) bool, pauli (B, L) int32 in [0, 3), cat2 (B, L) int32 in
    [0, 15)) on ``device``, L the code's circuit's gate locations."""

    def __init__(self, seed: int, p: float, batch: int, rounds: int,
                 n_locs: int, device, code: int = 0):
        self.seed, self.p, self.code = int(seed), float(p), int(code)
        self.shape = (batch, n_locs)
        self.rounds = rounds
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)

    def __call__(self, index: int) -> list:
        g = self.gen
        g.manual_seed(dispatch_seed(self.seed, index, self.code))
        out = []
        for _ in range(self.rounds):
            err = torch.rand(self.shape, generator=g,
                             device=self.device) < self.p
            c = torch.randint(0, 45, self.shape, generator=g,
                              device=self.device, dtype=torch.int32)
            out.append((err, c % 3, c // 3))
        return out
