"""A configuration of several codes (``data/bbmulti_small.json``: [[72]]
and [[90]] at 3 cycles) through the program's multi-code pooled round on
the CPU: its parts, every code judged against the reference in a traced
run, and what the multi-code round does not run refused at set-up."""
import copy
import json
from pathlib import Path
from types import SimpleNamespace

import torch

from perfbench import harness, matrices

from helpers import MULTI, run

CONFIG = json.loads((Path(__file__).parent / "data" /
                     "bbmulti_small.json").read_text())


def test_parts():
    parts = matrices.parts(CONFIG)
    assert [p["name"] for p in parts] == ["bbmulti_small.0",
                                          "bbmulti_small.1"]
    assert [p["code"]["name"] for p in parts] == ["[[72, 12, 6]]",
                                                  "[[90, 8, 10]]"]
    assert all(p["decoder"] is CONFIG["decoder"] and "codes" not in p
               for p in parts)
    one = {k: v for k, v in parts[0].items()}
    assert matrices.parts(one) == [one]


def test_every_code_is_judged():
    torch.set_num_threads(1)
    result = run(seed=2**31 + 21, traced=True, seconds=600, cell=MULTI)
    assert result["correct"] is True
    assert {k: c["value"] for k, c in result["checks"].items()} == {
        "conv_mismatch": 0, "decode_mismatch": 0}
    shape = CONFIG["dispatch"]
    # the traced window: trace_dispatches dispatches of every code
    assert result["attempted"] == (CONFIG["measure"]["trace_dispatches"]
                                   * len(CONFIG["codes"]) * shape["batch"]
                                   * shape["rounds"])


def test_what_the_multi_code_round_does_not_run_is_refused():
    lifted = [(SimpleNamespace(lifted=object()),
               SimpleNamespace(lifted=object()))] * 2
    assert harness.multi_code_refusals(CONFIG, lifted) == []
    for key, value in (("clip_llr", 10.0), ("bp", "layered min-sum"),
                       ("msg_dtype", "bfloat16")):
        conf = copy.deepcopy(CONFIG)
        conf["decoder"][key] = value
        assert len(harness.multi_code_refusals(conf, lifted)) == 1, key
    conf = copy.deepcopy(CONFIG)
    conf["dispatch"]["osd_chunk"] = 64
    assert len(harness.multi_code_refusals(conf, lifted)) == 1
    unlifted = [lifted[0], (SimpleNamespace(lifted=None), lifted[0][1])]
    assert len(harness.multi_code_refusals(CONFIG, unlifted)) == 1
