"""The comparison that decides ``correct``.

Once the window has closed, a sample of the dispatches it consumed, drawn
from the seed, is drawn again (``traffic.Draws``) and decoded by the plain
reference (``reference/``); the flags the program's round returned for
those dispatches are judged against the reference's, shot by shot, in both
bases. The reference reproduces the program's float32 arithmetic in the
order the configuration's decoder states (its posterior sums follow the
code's lifted layout), so on sound runs the two agree on every flag; the
control (the reference with bfloat16 messages, ``readings.py``) disagrees
on hundreds of shots a dispatch. Each number
compared is an exact count, with the limit 0.
"""
from __future__ import annotations

import random

import numpy as np

# the flags of a dispatch as the harness reads them to the host, in order
FLAGS = ("z_err", "x_err", "z_conv", "x_conv", "z_rankdef", "x_rankdef",
         "osd_overflow")
LIMITS = {"conv_mismatch": 0, "decode_mismatch": 0}


def sample(seed: int, n: int, k: int) -> list:
    """``k`` of the positions 0..n-1, drawn from ``seed``, in order."""
    return sorted(random.Random(f"check:{seed}").sample(range(n), min(k, n)))


def compare(flags: np.ndarray, ref: dict) -> dict:
    """The numbers compared for one dispatch: shot-bases whose BP
    convergence differs (``conv_mismatch``), and whose logical-error or
    rank-deficiency flag differs (``decode_mismatch``). ``flags`` (7, N)
    bool in :data:`FLAGS` order; ``ref`` the reference's flags."""
    row = {k: flags[i] for i, k in enumerate(FLAGS)}
    out = {"conv_mismatch": 0, "decode_mismatch": 0}
    for b in "zx":
        r = {k: np.asarray(ref[f"{b}_{k}"]) for k in ("conv", "err",
                                                      "rankdef")}
        out["conv_mismatch"] += int((row[f"{b}_conv"] != r["conv"]).sum())
        out["decode_mismatch"] += int(((row[f"{b}_err"] != r["err"])
                                       | (row[f"{b}_rankdef"]
                                          != r["rankdef"])).sum())
    return out


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
