"""The port's LER validation sweep against the JAX package's script.

``qldpc_tpu_torch.scripts.validate_ler`` is held against
``scripts/validate_ler.py``: the same point table, and, with both
packages' ``run_simulation`` replaced by one stub, the same rows, the same
calls and the same closing line under one argv. One real CPU run on
[[72,12,6]]; the committed H100 sweep (``validation_torch_h100_*.json``)
held against the JAX package's TPU records of the same 18 points at
|z| <= 3; the device guards; ``merge_validation``.
"""
import ast
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qldpc_tpu_torch.examples import toy_422, toy_example
from qldpc_tpu_torch.scripts import merge_validation, validate_ler

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JAX_SCRIPT = ROOT / "scripts" / "validate_ler.py"

# the port's sweep file of each run, and the JAX package's records of the
# same points (code, p, mode, maxIter 50, schedule)
SWEEPS = {
    "validation_torch_h100_dynamical.json":
        ["validation_dynamical_mi50.json"],
    "validation_torch_h100_autoregressive.json":
        ["validation_rest_mi50.json", "validation_144_mi50.json"],
    "validation_torch_h100_layered.json":
        ["validation_layered_mi50.json"],
}


def _jax_points():
    """BASELINE_POINTS of the JAX script, read from its source so that its
    module-level environment defaults never run here."""
    tree = ast.parse(JAX_SCRIPT.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "BASELINE_POINTS"
                for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("BASELINE_POINTS not found")


def test_point_table_equals_jax():
    assert validate_ler.BASELINE_POINTS == _jax_points()


@pytest.fixture
def jax_script(monkeypatch):
    """JAX's scripts/validate_ler.py as a module; its sys.path insert and
    environment defaults are undone afterwards."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    for var in ("JAX_COMPILATION_CACHE_DIR",
                "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"):
        monkeypatch.delenv(var, raising=False)
    spec = importlib.util.spec_from_file_location("_jax_validate_ler",
                                                  JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fake_matrices(circ, Lx, Lz, p):
    """A tiny stand-in for a code's decoding matrices (no [[288]] build)."""
    return {"k": int(np.asarray(Lx).shape[0]),
            "HdecZ": np.full((2, 3), int(round(p * 1e4)), np.uint8)}


def _same_value(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_value(a[k], b[k])
                                            for k in a)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


@pytest.mark.parametrize("argv", [
    ["--alpha-mode", "alvarado-autoregressive", "--max-iter", "50",
     "--target-errors", "7", "--max-trials", "300", "--batch-size", "64"],
    ["--alpha-mode", "alvarado-autoregressive", "--bp-variant", "layered",
     "--codes", "[[144, 12, 12]]", "[[288, 12, 18]]", "--out", "v.json"],
    [],
])
def test_main_equals_jax_under_one_stub(jax_script, monkeypatch, tmp_path,
                                        capsys, argv):
    """Both scripts' main under one argv, with run_simulation and the matrix
    builder stubbed: equal rows (wall_sec aside), equal calls (the port's
    device aside) and equal closing lines. The JAX run writes the matrix
    cache and the port's run reads it."""
    monkeypatch.chdir(tmp_path)
    out_name = argv[argv.index("--out") + 1] if "--out" in argv \
        else "validation_results.json"
    runs = {}
    for name, mod in (("jax", jax_script), ("port", validate_ler)):
        calls = []

        def stub(*args, **kw):
            calls.append((args, kw))
            n = len(calls)
            return dict(logical_error_rate=n / 40, logical_errors=n,
                        num_trials=40, shots_per_sec=1000.0 / n)

        monkeypatch.setattr(mod, "run_simulation", stub)
        monkeypatch.setattr(mod, "build_decoding_matrices", _fake_matrices)
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["validate_ler.py"] + argv)
            mod.main()
        else:
            mod.main(argv + ["--device", "cpu"])
        lines = capsys.readouterr().out.strip().splitlines()
        rows = json.loads((tmp_path / out_name).read_text())
        runs[name] = dict(calls=calls, rows=rows, last=lines[-1])
    jax_run, port = runs["jax"], runs["port"]
    assert len(port["rows"]) == len(jax_run["rows"]) > 0
    for a, b in zip(port["rows"], jax_run["rows"]):
        a.pop("wall_sec"), b.pop("wall_sec")
        assert a == b
    assert port["last"] == jax_run["last"]
    assert len(port["calls"]) == len(jax_run["calls"])
    for (pa, pk), (ja, jk) in zip(port["calls"], jax_run["calls"]):
        assert pk.pop("device") == torch.device("cpu")
        assert len(pa) == len(ja)
        assert all(np.array_equal(x, y) for x, y in zip(pa, ja))
        assert pk.keys() == jk.keys()
        for key in pk:
            assert _same_value(pk[key], jk[key]), key


def test_real_cpu_run(monkeypatch, tmp_path, capsys):
    """One real CPU point: [[72,12,6]] p=0.006, dynamical, to 5 errors."""
    monkeypatch.chdir(tmp_path)
    point = validate_ler.BASELINE_POINTS["dynamical"][0]
    assert point[:2] == ("[[72, 12, 6]]", 0.006)
    monkeypatch.setattr(validate_ler, "BASELINE_POINTS",
                        {"dynamical": [point]})
    rows = validate_ler.main(["--device", "cpu", "--target-errors", "5",
                              "--max-trials", "256"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device: cpu (plain versions; no device metric)"
    assert out[-1].startswith("max |z| = ")
    written = json.loads((tmp_path / "validation_results.json").read_text())
    assert written == rows and len(rows) == 1
    jax_keys = json.loads(
        (ROOT / "validation_layered_mi50.json").read_text())[0].keys()
    row = rows[0]
    assert row.keys() == jax_keys
    assert row["errors"] == 5 and 5 <= row["trials"] <= 256
    assert row["ler"] == row["errors"] / row["trials"]
    assert (row["code"], row["p"], row["maxIter"]) == ("[[72, 12, 6]]",
                                                       0.006, 20)


def _records():
    """(sweep file, code, p) of every JAX record the port's sweep is held
    against, with the record."""
    out = []
    for sweep, sources in SWEEPS.items():
        for src in sources:
            for rec in json.loads((ROOT / src).read_text()):
                out.append(pytest.param(sweep, rec,
                                        id=f"{rec['code']}-{rec['p']}-"
                                           f"{sweep.split('_')[-1][:-5]}"))
    return out


def test_committed_sweep_covers_the_records():
    """The three sweep files hold exactly the 18 points of the records."""
    assert len(_records()) == 18
    for sweep, sources in SWEEPS.items():
        rows = json.loads((ROOT / sweep).read_text())
        recs = [r for s in sources for r in json.loads((ROOT / s).read_text())]
        assert sorted((r["code"], r["p"]) for r in rows) == \
            sorted((r["code"], r["p"]) for r in recs), sweep


@pytest.mark.parametrize("sweep,rec", _records())
def test_committed_sweep_within_3_sigma_of_jax(sweep, rec):
    """Each H100 point against the JAX package's TPU record of the same
    code, p, alpha mode, maxIter and schedule: |z| <= 3."""
    rows = [r for r in json.loads((ROOT / sweep).read_text())
            if (r["code"], r["p"]) == (rec["code"], rec["p"])]
    assert len(rows) == 1
    row = rows[0]
    assert (row["alpha_mode"], row["maxIter"]) == (rec["alpha_mode"],
                                                   rec["maxIter"]) \
        == (row["alpha_mode"], 50)
    assert row["bp_variant"] == rec.get("bp_variant", "minsum")
    assert row["ler"] == row["errors"] / row["trials"]
    a, na = row["ler"], row["trials"]
    b, nb = rec["ler"], rec["trials"]
    z = (a - b) / np.sqrt(a * (1 - a) / na + b * (1 - b) / nb)
    assert abs(z) <= 3, (row, rec, z)


@pytest.mark.parametrize("main", [validate_ler.main, toy_example.main,
                                  toy_422.main],
                         ids=["validate_ler", "toy_example", "toy_422"])
def test_default_device_raises_without_gpu(monkeypatch, tmp_path, main):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        main([])
    assert not list(tmp_path.iterdir())


def test_merge_validation(tmp_path, capsys):
    """Rows of the sweep files that exist, in SOURCES order, each with its
    source label; a missing file is skipped."""
    files = [name for name, _ in merge_validation.SOURCES]
    (tmp_path / files[2]).write_text(json.dumps([{"code": "c", "p": 0.1}]))
    (tmp_path / files[0]).write_text(json.dumps(
        [{"code": "a", "p": 0.3}, {"code": "b", "p": 0.2}]))
    rows = merge_validation.main(root=str(tmp_path))
    labels = [label for _, label in merge_validation.SOURCES]
    assert rows == [{"code": "a", "p": 0.3, "source": labels[0]},
                    {"code": "b", "p": 0.2, "source": labels[0]},
                    {"code": "c", "p": 0.1, "source": labels[2]}]
    assert json.loads((tmp_path / "validation_results_torch.json")
                      .read_text()) == rows
    assert f"skip (missing): {files[1]}" in capsys.readouterr().out
