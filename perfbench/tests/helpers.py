"""What the benchmark's CPU tests share: a manifest with a small [[72]]
cell added (``data/bb72_small.json``), and a run of it on the CPU."""
import copy
import time

from perfbench import harness

CELL = "bb72-test"


def manifest():
    man = copy.deepcopy(harness.manifest())
    man["configs"].append({"name": "bb72_small", "source": "test",
                           "file": "perfbench/tests/data/bb72_small.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": CELL, "config": "bb72_small",
                             "traffic": "p0.004", "chips": 1, "why": "test"})
    return man


def run(seed=2**31 + 7, traced=False, seconds=0.5):
    return harness.run_cell(CELL, seed, seconds, traced, "cpu", time.time(),
                            manifest(), log=lambda *a, **k: None)
