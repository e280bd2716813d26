"""The port's host utilities and drivers vs the JAX package's.

Results files: the port's save_results read by JAX's load_results and the
other way round. The plots, the CLI (``python -m qldpc_tpu_torch --device
cpu``, with --resume), the gallery, the generate-codes and info scripts
write their files on the CPU. The port's gate-walk oracle equals JAX's on
the same draws.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import qldpc_tpu
from qldpc_tpu.models.reference_sim import run_trial_oracle as jax_oracle
from qldpc_tpu.utils import results as jresults

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.models.reference_sim import run_trial_oracle
from qldpc_tpu_torch.scripts import generate_codes, info
from qldpc_tpu_torch.utils import results
from qldpc_tpu_torch.utils.plotting import (plot_alpha_comparison,
                                            plot_alpha_linearity,
                                            plot_simulation_results)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
RESULTS = {
    "72": {
        0.006: {"logical_error_rate": 0.5, "num_trials": 60,
                "logical_errors": 30,
                "alpha_values_z": [0.5, 0.7, 0.8],
                "alpha_values_x": [0.55, 0.72, 0.81],
                "alpha_r2_values_z": [0.9, 0.92, 0.93],
                "alpha_r2_values_x": [0.9, 0.9, 0.9],
                "beta_z": -0.4, "beta_x": -0.5},
        0.004: {"logical_error_rate": 0.17, "num_trials": 1000,
                "logical_errors": 170},
    }
}


@pytest.mark.parametrize("writer,reader", [(results, jresults),
                                           (jresults, results)])
def test_results_files_cross_load(tmp_path, writer, reader):
    run_dir, est_dir = writer.make_run_dir(str(tmp_path / "out"))
    assert os.path.isdir(est_dir)
    path = writer.save_results(run_dir, RESULTS, {"72": {0.006: 0.9}})
    loaded = reader.load_results(path)
    assert set(loaded) == {"results", "alpha_values", "beta_values",
                           "alpha_r2_values", "estimation_r2_values"}
    assert loaded["results"] == RESULTS
    assert loaded["alpha_r2_values"] == {"72": {0.006: 0.9}}
    assert loaded["beta_values"]["72"][0.006] == {"z": -0.4, "x": -0.5}
    assert (results.collect_calibration(RESULTS)
            == jresults.collect_calibration(RESULTS))


def test_plots_written(tmp_path):
    p1 = plot_simulation_results(RESULTS, str(tmp_path / "ler.png"))
    p2 = plot_alpha_comparison(RESULTS, str(tmp_path / "cmp.png"))
    r2 = plot_alpha_linearity(RESULTS, str(tmp_path / "lin.png"))
    assert os.path.getsize(p1) > 0 and os.path.getsize(p2) > 0
    assert os.path.getsize(tmp_path / "lin.png") > 0
    assert "72" in r2 and 0.006 in r2["72"]


def _cli(tmp_path, *args, path=()):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([*map(str, path), str(ROOT),
                                           os.environ.get("PYTHONPATH", "")]))
    return subprocess.run(
        [sys.executable, "-m", "qldpc_tpu_torch", "--device", "cpu",
         "--codes", "[[72, 12, 6]]", "--num-cycles", "2", "--max-iter", "10",
         "--target-logical-errors", "5", "--max-trials", "256",
         "--batch-size", "64", "--base-seed", "3", "--output-dir", "out",
         "--cache-dir", "cache", *args],
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)


def test_cli_writes_results_and_resumes(tmp_path):
    out = _cli(tmp_path, "--error-rates", "0.01")
    assert out.returncode == 0, out.stderr
    (run_dir,) = (tmp_path / "out").glob("run_*")
    res = results.load_results(str(run_dir / "results.npz"))["results"]
    r = res["72"][0.01]
    assert r["logical_errors"] == 5 and 5 <= r["num_trials"] <= 256
    assert (run_dir / "simulation_results.png").exists()
    summary = json.loads((run_dir / "summary.json").read_text())
    assert summary["72"]["0.01"]["trials"] == r["num_trials"]
    assert list((tmp_path / "cache").glob("matrices_*.npz"))
    # a second rate resumes the run: the first point is skipped, not redone
    out = _cli(tmp_path, "--error-rates", "0.01", "0.012", "--resume",
               str(run_dir))
    assert out.returncode == 0, out.stderr
    assert "already completed" in out.stderr
    res2 = jresults.load_results(str(run_dir / "results.npz"))["results"]
    assert res2["72"][0.01] == r and 0.012 in res2["72"]


def test_cli_without_matplotlib(tmp_path):
    """Where matplotlib is missing the CLI still writes results.npz and
    summary.json, and says that it writes no plot."""
    blocked = tmp_path / "blocked" / "matplotlib"
    blocked.mkdir(parents=True)
    (blocked / "__init__.py").write_text("raise ImportError('blocked')\n")
    out = _cli(tmp_path, "--error-rates", "0.01", path=[blocked.parent])
    assert out.returncode == 0, out.stderr
    assert "matplotlib is not installed" in out.stderr
    (run_dir,) = (tmp_path / "out").glob("run_*")
    assert (run_dir / "results.npz").exists()
    assert (run_dir / "summary.json").exists()
    assert not list(run_dir.glob("*.png"))


def test_cli_needs_a_gpu(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-m", "qldpc_tpu_torch",
                          "--error-rates", "0.01"], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path, env=env)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
    assert not (tmp_path / "output").exists()


def test_gallery_on_the_cpu(tmp_path):
    from qldpc_tpu_torch.utils.gallery import generate_gallery
    paths = generate_gallery(str(tmp_path), code_name="[[72, 12, 6]]",
                             num_cycles=2, p=0.006, verbose=False,
                             device="cpu")
    assert len(paths) == 15
    for p in paths:
        assert os.path.exists(p) and os.path.getsize(p) > 5000, p
    names = {os.path.basename(p) for p in paths}
    for req in ("01c_logical_error_flow.png", "06_simulation_trace.png",
                "10_llr_evolution.png", "12_decoder_performance.png"):
        assert req in names


def test_generate_codes_matches_jax(tmp_path):
    paths = generate_codes.main(["--out-dir", str(tmp_path), "--codes",
                                 "[[72, 12, 6]]", "[[144, 12, 12]]"])
    assert len(paths) == 2
    for name, path in zip(("[[72, 12, 6]]", "[[144, 12, 12]]"), paths):
        jpath = tmp_path / f"jax_{name}.npz"
        qldpc_tpu.get_code(name).save_npz(str(jpath))
        got, want = np.load(path), np.load(jpath)
        assert set(got.files) == set(want.files)
        for key in want.files:
            assert np.array_equal(got[key], want[key]), key
        loaded = qt.models.bb.BBCode.load_npz(path, name=name)
        assert np.array_equal(loaded.Hx, qt.get_code(name).Hx)


def test_info_histograms(tmp_path):
    code = qt.get_code("[[72, 12, 6]]")
    circ = qt.SyndromeCircuit(code, num_cycles=2)
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, 0.01)
    from qldpc_tpu_torch.utils.caching import compute_cache_key, save_matrices
    save_matrices(str(tmp_path / "cache"), compute_cache_key(
        code.Hx, code.Hz, code.Lx, code.Lz, 2, 0.01), M)
    paths = info.main(["--cache-dir", str(tmp_path / "cache"), "--out-dir",
                       str(tmp_path / "vis")])
    assert len(paths) == 2 and all(os.path.getsize(p) > 0 for p in paths)


def test_oracle_matches_jax():
    """The port's copy of the gate-walk oracle equals the JAX package's on
    the same explicit draws, trial by trial."""
    code = qt.get_code("[[72, 12, 6]]")
    circ = qt.SyndromeCircuit(code, num_cycles=2)
    jcode = qldpc_tpu.get_code("[[72, 12, 6]]")
    jcirc = qldpc_tpu.SyndromeCircuit(jcode, num_cycles=2)
    rng = np.random.default_rng(21)
    n = circ.num_error_locs
    for _ in range(6):
        err = rng.random(n) < 0.02
        pauli = rng.integers(0, 3, n, dtype=np.int32)
        cat2 = rng.integers(0, 15, n, dtype=np.int32)
        got = run_trial_oracle(circ, code.Lx, code.Lz, err, pauli, cat2)
        want = jax_oracle(jcirc, jcode.Lx, jcode.Lz, err, pauli, cat2)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    assert any(g.any() for g in got)
