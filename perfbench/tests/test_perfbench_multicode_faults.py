"""A run of the small cell of several codes with an answer altered where
the second code's round produces it comes out not correct: the check
judges every code, not the first alone."""
import functools

import torch

from qldpc_tpu_torch.parallel import engine

from helpers import MULTI, run


def test_answer_altered_in_the_second_code(monkeypatch):
    """The second code's round returns one logical-error flag flipped."""
    torch.set_num_threads(1)
    real, made = engine.make_pooled_round_fn, []

    @functools.wraps(real)
    def make(*args, **kwargs):
        fn = real(*args, **kwargs)
        made.append(fn)
        if len(made) != 2:
            return fn

        def altered(*a, **k):
            out = dict(fn(*a, **k))
            out["z_err"] = out["z_err"].clone()
            out["z_err"][0] ^= True
            return out
        return altered

    monkeypatch.setattr(engine, "make_pooled_round_fn", make)
    result = run(seed=2**33 + 5, cell=MULTI)
    assert len(made) == 2
    assert result["correct"] is False
    assert result["checks"]["decode_mismatch"]["value"] > 0
    assert result["checks"]["conv_mismatch"]["value"] == 0
