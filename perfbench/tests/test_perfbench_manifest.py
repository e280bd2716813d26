"""BENCHMARK.json against the benchmark's contract: names, units and
limits, and every configuration, traffic mix and metric reader found by
name."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert 1 <= len(MAN["command"]) <= 32
    assert all(LINE.match(w) for w in MAN["command"])
    assert isinstance(MAN["run_seconds"], int) and \
        1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["configs"]) <= 24
    assert 1 <= len(MAN["workloads"]) <= 24
    assert 1 <= len(MAN["end_to_end"]) <= 16
    assert 1 <= len(MAN["per_layer"]) <= 128


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda e: e["name"])
def test_configs(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert LINE.match(entry["source"]) and LINE.match(entry["why"])
    assert len(entry["reduced"]) <= 16
    assert all(NAME.match(k) for k in entry["reduced"])
    path = ROOT / entry["file"]
    assert entry["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
    conf = json.loads(path.read_text())
    assert conf["name"] == entry["name"]
    assert conf["reduced"] == entry["reduced"]
    for key in ("source", "assumed", "decoder", "dispatch", "measure"):
        assert key in conf, key
    # one code (code, num_cycles) or several (codes: a list of them)
    if "codes" in conf:
        assert "code" not in conf and "num_cycles" not in conf
        assert len(conf["codes"]) >= 2
    for code in conf.get("codes", [conf]):
        for key in ("code", "num_cycles"):
            assert key in code, key


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda c: c["name"])
def test_workloads(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    for k in ("name", "config", "traffic"):
        assert NAME.match(cell[k])
    assert LINE.match(cell["why"])
    assert cell["chips"] in (1, 4)
    assert cell["config"] in {c["name"] for c in MAN["configs"]}
    traffic = json.loads(
        (ROOT / "perfbench" / "traffic" / f"{cell['traffic']}.json")
        .read_text())
    assert 0 < traffic["p"] < 0.5
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    def reports(m):
        return "workloads" not in m or cell["name"] in m["workloads"]
    e2e = [m["name"] for m in MAN["end_to_end"] if reports(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reports(m) for m in MAN["per_layer"])


def test_unique_names_and_pairs():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(c["config"], c["traffic"]) for c in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {c["config"] for c in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    four = sum(c["chips"] == 4 for c in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metrics(metric):
    per_layer = metric in MAN["per_layer"]
    keys = {"name", "unit", "better", "source"} | (
        {"layer", "moves"} if per_layer else {"bound"})
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {c["name"] for c in MAN["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if per_layer:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert LINE.match(metric["layer"])
        assert metric["moves"] in {m["name"] for m in MAN["end_to_end"]}
    else:
        assert metric["source"] in ("device_trace", "host_clock")
        assert 0.01 <= metric["bound"] <= 0.25
    # found by name: metrics/<name>.py with a read(run)
    src = (ROOT / "perfbench" / "metrics" / f"{metric['name']}.py")
    assert "def read(run)" in src.read_text()


def test_setup_metric():
    assert "setup_s" in {m["name"] for m in MAN["end_to_end"]}
