"""What the benchmark's CPU tests share: a manifest with three small cells
added, one of the [[72]] code (``data/bb72_small.json``), the same under
the layered schedule (``data/bb72_layered_small.json``) and one of [[72]]
and [[90]] in one dispatch (``data/bbmulti_small.json``), and a run of any
of them on the CPU."""
import copy
import time

from perfbench import harness

CELL = "bb72-test"
LAYERED = "bb72-layered-test"
MULTI = "bbmulti-test"


def manifest():
    man = copy.deepcopy(harness.manifest())
    for name, cell in (("bb72_small", CELL), ("bb72_layered_small", LAYERED),
                       ("bbmulti_small", MULTI)):
        man["configs"].append({"name": name, "source": "test",
                               "file": f"perfbench/tests/data/{name}.json",
                               "reduced": [], "why": "test"})
        man["workloads"].append({"name": cell, "config": name,
                                 "traffic": "p0.004", "chips": 1,
                                 "why": "test"})
    return man


def run(seed=2**31 + 7, traced=False, seconds=0.5, cell=CELL):
    return harness.run_cell(cell, seed, seconds, traced, "cpu", time.time(),
                            manifest(), log=lambda *a, **k: None)
