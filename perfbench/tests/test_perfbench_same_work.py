"""A configuration of one code decodes the same work as before
configurations could hold several: the small [[72]] cell's draws and the
flags its program returns through the loop, for a fixed seed, hash to the
digests recorded on the harness of one code (the parent of the multi-code
harness), so the single-code cells decode the same shots bit for bit."""
import hashlib

import numpy as np
import torch

from perfbench import harness, matrices

from helpers import CELL, manifest

SEED = 2**31 + 12345
DRAWS = "9f3d449e832e5209da3dd0224fd8c969"
FLAGS = "991311c02413d0b2ef5d698c7dd46f45"


def test_draws_and_flags_equal_the_recorded_digest():
    torch.set_num_threads(1)
    _, config, traffic = harness.cell_of(manifest(), CELL)
    p = float(traffic["p"])
    cms = [matrices.load(part, p) for part in matrices.parts(config)]
    pooled, n_locs, _ = harness.program(config, cms, p, "cpu")
    draws = harness.draws_of(config, SEED, p, n_locs, "cpu")
    assert len(draws) == 1
    h = hashlib.sha256()
    for i in range(3):
        for rnd in draws[0](i):
            for t in rnd:
                h.update(t.numpy().tobytes())
    assert h.hexdigest()[:32] == DRAWS
    loop = harness.Loop(pooled, draws, config["dispatch"]["pipeline_depth"],
                        False)
    h = hashlib.sha256()
    for _ in range(3):
        _, flags, _ = loop.step()
        h.update(np.packbits(flags).tobytes())
    assert h.hexdigest()[:32] == FLAGS
