"""Port sampler batch, matrix cache and kernel-study entry points vs the
JAX package.

``trial_batch`` must give JAX's ``trial_batch`` bit for bit on the same gate
randoms; the port's cache must share JAX's key and file format both ways;
and the entry points of ``qldpc_tpu_torch.scripts`` must run to their end
on the CPU (plain versions) at [[72,12,6]] and tiny sizes, and refuse to
run without a GPU unless asked for the CPU.
"""
import numpy as np
import pytest
import torch

import jax

import qldpc_tpu
from qldpc_tpu.ops import sampler as jsampler
from qldpc_tpu.utils import caching as jcaching

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.ops import sampler
from qldpc_tpu_torch.scripts import (bench288_sweep, bp_breakdown,
                                     bp_lift_bench, gather_bench,
                                     gather_probe, maxiter_sweep,
                                     multicode_bench, osd144_stage_ab,
                                     osd288_ab, osd288_probe,
                                     osd_margin_probe, osd_microbench,
                                     pooled_ab, scaling_bench)
from qldpc_tpu_torch.utils import caching

torch.set_num_threads(1)

CODE, CYCLES, P = "[[72, 12, 6]]", 6, 0.006


@pytest.fixture(scope="module")
def built():
    code = qt.get_code(CODE)
    circ = qt.SyndromeCircuit(code, num_cycles=CYCLES)
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, P)
    jcode = qldpc_tpu.get_code(CODE)
    jcirc = qldpc_tpu.SyndromeCircuit(jcode, num_cycles=CYCLES)
    jM = qldpc_tpu.build_decoding_matrices(jcirc, jcode.Lx, jcode.Lz, P)
    return code, circ, M, jcirc, jM


def test_trial_batch_bit_exact_against_jax(built):
    code, circ, M, jcirc, jM = built
    B, p, n_locs = 64, 0.02, circ.num_error_locs
    key = jax.random.key(7)
    jmaps = [jsampler.make_trial_maps(jcirc, jM, b) for b in "ZX"]
    jout = jsampler.trial_batch(key, p, *jmaps, n_locs=n_locs, batch=B)
    # the draws JAX's trial_batch makes from that key
    randoms = tuple(torch.as_tensor(np.array(r)) for r in
                    jsampler.sample_gate_randoms(key, B, n_locs, p))
    maps = [sampler.make_trial_maps(circ, M, b, device="cpu") for b in "ZX"]
    out = sampler.trial_batch(None, p, *maps, n_locs, B, randoms=randoms)
    assert set(out) == set(jout)
    for k, v in out.items():
        assert v.dtype == torch.int8, k
        assert np.array_equal(v.numpy(), np.asarray(jout[k])), k
    assert out["syndrome_z"].any() and out["true_x"].shape == (B, M["k"])


def test_trial_batch_draws_from_the_generator(built):
    _, circ, M, _, _ = built
    maps = [sampler.make_trial_maps(circ, M, b, device="cpu") for b in "ZX"]
    n_locs = circ.num_error_locs
    out = sampler.trial_batch(torch.Generator().manual_seed(3), 0.01, *maps,
                              n_locs, 32)
    randoms = sampler.sample_gate_randoms(torch.Generator().manual_seed(3),
                                          32, n_locs, 0.01)
    again = sampler.trial_batch(None, 0.01, *maps, n_locs, 32,
                                randoms=randoms)
    assert all(torch.equal(out[k], again[k]) for k in out)


@pytest.mark.parametrize("cycles, p", [(6, 0.006), (3, 0.0123456)])
def test_cache_key_equals_jax(built, cycles, p):
    code = built[0]
    args = (code.Hx, code.Hz, code.Lx, code.Lz, cycles, p)
    key = caching.compute_cache_key(*args)
    assert len(key) == 16 and key == jcaching.compute_cache_key(*args)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_files_cross_load(built, tmp_path, writer):
    code, _, M = built[:3]
    key = caching.compute_cache_key(code.Hx, code.Hz, code.Lx, code.Lz,
                                    CYCLES, P)
    save, load = ((caching.save_matrices, jcaching.load_matrices)
                  if writer == "port" else
                  (jcaching.save_matrices, caching.load_matrices))
    path = save(str(tmp_path), key, M)
    assert path.endswith(f"matrices_{key}.npz")
    got = load(str(tmp_path), key)
    assert set(got) == set(M)
    for k, v in M.items():
        if isinstance(v, (int, np.integer)):
            assert type(got[k]) is int and got[k] == v, k
        else:
            a, b = np.asarray(v), got[k]
            assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert caching.load_matrices(str(tmp_path), "0" * 16) is None


def test_cache_ignores_a_torn_file(tmp_path):
    (tmp_path / "matrices_abc.npz").write_bytes(b"not a zip")
    assert caching.load_matrices(str(tmp_path), "abc") is None


def test_bp_breakdown_runs_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--code", CODE, "--batch", "16", "--reps", "1"]
    rep = bp_breakdown.main(argv)
    for k in ("null_ms", "prep_ms", "kernel1_ms", "kernel20_ms", "full1_ms",
              "full20_ms", "kernel_per_iter_ms", "postprocess_ms"):
        assert np.isfinite(rep[k]), k
    assert rep["batch"] == 16 and 0 < rep["converged20"] <= 16
    assert 1 <= rep["mean_iters20"] <= bp_breakdown.MAX_ITER
    assert len(list(tmp_path.glob("matrix_cache/matrices_*.npz"))) == 1

    def no_build(*a, **kw):
        raise AssertionError("matrices rebuilt despite the cache")
    monkeypatch.setattr(bp_breakdown, "build_decoding_matrices", no_build)
    again = bp_breakdown.main(argv)
    assert again["converged20"] == rep["converged20"]


def test_gather_bench_runs_on_cpu(capsys):
    rows = gather_bench.main(["--device", "cpu", "--shapes", "64x8,32x4",
                              "--iters", "3", "--reps", "1"])
    assert [(r["dtype"], r["rows"], r["lanes"]) for r in rows] == [
        ("float32", 64, 8), ("float32", 32, 4), ("bfloat16", 64, 8),
        ("bfloat16", 32, 4)]
    assert all(r["P1_ms"] > 0 and r["gather_ms"] > 0 for r in rows)
    assert capsys.readouterr().out.count("GB/s-equiv") == 8


def test_gather_probe_runs_on_cpu(capsys):
    results = gather_probe.main(["--device", "cpu"])
    assert len(results) == 2 * len(gather_probe.SHAPES) * 2
    assert all(r["match"] for r in results)
    assert capsys.readouterr().out.count("OK  match=True") == len(results)


@pytest.mark.parametrize("entry", [
    bp_breakdown, gather_bench, gather_probe, multicode_bench, pooled_ab,
    maxiter_sweep, bench288_sweep, scaling_bench, osd144_stage_ab, osd288_ab,
    osd288_probe, osd_margin_probe, osd_microbench, bp_lift_bench])
def test_entry_points_default_to_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.main([])
