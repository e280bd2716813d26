"""The port's bench: timed_windows, the unpooled dispatch, bench_cuda.py.

JAX's tests/test_benchloop.py re-run on a torch round; the unpooled
multi-round dispatch (make_scanned_round_fn, what BENCH_POOLED=0 runs)
against the pooled one on the same draws; bench_cuda.py on a tiny
configuration on the CPU, and its exit without a GPU.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.ops.bp import alpha_schedule
from qldpc_tpu_torch.ops.sampler import sample_gate_randoms
from qldpc_tpu_torch.parallel import engine
from qldpc_tpu_torch.utils.benchloop import timed_windows

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def test_timed_windows_counts_and_rate():
    calls = []

    def round_fn(i):
        return {"x": torch.full((4,), i, dtype=torch.int32)}

    rates = []
    rate, fetched = timed_windows(
        round_fn, shots_per_round=4, windows=2, seconds=0.0, min_rounds=2,
        on_round=lambda out: calls.append(int(out["x"][0])), rates=rates)
    assert rate > 0 and rate == max(rates) and len(rates) == 2
    # 1 warm-up fetch + per window (1 align + >=2 timed)
    assert fetched >= 1 + 2 * 3
    assert fetched == len(calls)
    # rounds are fetched in launch order (the pipeline preserves ordering)
    assert calls == sorted(calls)


def test_timed_windows_keeps_depth_in_flight():
    """Round i+depth is launched before round i is fetched, and every
    fetched value is on the host."""
    events = []

    def launch(i):
        events.append(("launch", i))
        return {"x": torch.tensor([i])}

    def on_round(out):
        assert out["x"].device.type == "cpu"
        events.append(("fetch", int(out["x"][0])))

    timed_windows(launch, 1, windows=1, seconds=0.0, min_rounds=1, depth=3,
                  on_round=on_round)
    for i in range(3):
        assert events.index(("launch", i + 2)) < events.index(("fetch", i))


def test_scanned_round_matches_pooled():
    """Two unpooled rounds a dispatch (each with its own OSD phase) give the
    pooled dispatch's per-shot flags on the same draws."""
    p, batch, rounds, maxIter = 0.01, 24, 2, 10
    code = qt.get_code("[[72, 12, 6]]")
    circ = qt.SyndromeCircuit(code, num_cycles=3)
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, p)
    seq = alpha_schedule("dynamical", maxIter)
    dz, dx = (engine._make_basis(circ, M, b, seq, osd_order=2, device="cpu")
              for b in "ZX")
    n_locs = circ.num_error_locs
    gen = torch.Generator().manual_seed(4)
    randoms = [sample_gate_randoms(gen, batch, n_locs, p)
               for _ in range(rounds)]
    pooled = engine.make_pooled_round_fn(dz, dx, n_locs, p, batch, maxIter,
                                         2, rounds)(None, randoms)
    scanned = engine.make_scanned_round_fn(
        engine.make_round_fn(dz, dx, n_locs, p, batch, maxIter, 2),
        rounds)(None, randoms)
    assert set(scanned) == set(pooled)
    for key in pooled:
        assert scanned[key].shape == (rounds * batch,)
        assert torch.equal(scanned[key], pooled[key]), key
    assert 0 < int(pooled["z_conv"].sum()) < rounds * batch
    assert engine.tot_errs_target(30, 12) == 18
    assert engine.tot_errs_target(30, 31) == 0


def _bench(tmp_path, *args, **env):
    full = dict(os.environ, OMP_NUM_THREADS="1", **env)
    return subprocess.run(
        [sys.executable, str(ROOT / "bench_cuda.py"), *args],
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=full)


def test_bench_cuda_on_the_cpu(tmp_path):
    """A tiny configuration on the CPU: two JSON lines on stdout, the
    headline first and the full line with ``extra`` last."""
    out = _bench(tmp_path, "--device", "cpu", "--seconds", "0", "--windows",
                 "2", "--code", "[[72, 12, 6]]", "--p", "0.006",
                 "--baseline-cache", str(tmp_path / "baseline.json"),
                 BENCH_BATCH="32", BENCH_RPD="2", BENCH_MAXITER="10",
                 BENCH_288="0")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 2
    head, full = json.loads(lines[0]), json.loads(lines[-1])
    assert head["metric"] == "decoded_shots_per_sec_per_chip_[[72,12,6]]"
    assert "extra" not in head
    assert {k: full[k] for k in head} == head
    assert head["value"] > 0 and head["vs_baseline"] > 0
    assert head["unit"] == "shots/s"
    win = full["extra"]["windows_shots_per_sec"]
    assert len(win["all"]) == 2
    assert win["min"] <= win["median"] <= win["max"]
    assert round(win["max"], 1) == head["value"]
    assert (tmp_path / "baseline.json").exists()
    assert list((tmp_path / "matrix_cache").glob("matrices_*.npz"))


def test_bench_cuda_needs_a_gpu(tmp_path):
    """Without a GPU and without --device cpu it exits non-zero and prints
    no result."""
    out = _bench(tmp_path, "--seconds", "0", CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0
    assert out.stdout == ""
    assert "device='cpu'" in out.stderr


def test_bench_cuda_imports_no_jax():
    tree = ast.parse((ROOT / "bench_cuda.py").read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.add(node.module.split(".")[0])
    assert "qldpc_tpu_torch" in imported
    assert not imported & {"jax", "jaxlib", "qldpc_tpu"}, imported
