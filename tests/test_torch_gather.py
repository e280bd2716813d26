"""Port gathers P1 and P2 vs the JAX package's kernel studies.

The plain versions of ``qldpc_tpu_torch.ops.gather`` are held against the
Pallas kernels of ``scripts/pallas_gather_bench.py`` (P1) and
``scripts/pallas_gather_probe.py`` (P2), loaded from their files and run in
interpret mode on the CPU, on the same inputs. Tolerances: the tiles and
every take-along output are exact (a gather copies, and each add of 1 is
rounded once in the tile's dtype by both); P1's column sums differ only in
summation order, rtol 1e-5 in float32 and 1e-2 (about two bf16 ulps) in
bfloat16. The kernels themselves are held against these plain versions on
the GPU (tests/test_torch_cuda.py, chip_smoke.py).
"""
import importlib.util
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from qldpc_tpu_torch.ops import gather
from qldpc_tpu_torch.scripts import gather_bench, gather_probe

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
RTOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench_script():
    return _load_script("pallas_gather_bench")


@pytest.fixture(scope="module")
def probe_script():
    return _load_script("pallas_gather_probe")


def _p1_inputs(rows: int, lanes: int, seed: int):
    """float32 x, the row-index vector, and idx broadcast over the lanes, as
    the JAX script draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, lanes)).astype(np.float32)
    idx_vec = rng.integers(0, rows, size=rows).astype(np.int32)
    idx = np.ascontiguousarray(np.broadcast_to(idx_vec[:, None],
                                               (rows, lanes)))
    return x, idx_vec, idx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows, lanes", [(64, 128), (256, 8)])
def test_gather_iterate_plain_matches_pallas_kernel(bench_script, rows,
                                                    lanes, dtype):
    iters = 5
    x, idx_vec, idx = _p1_inputs(rows, lanes, rows + lanes)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = jnp.asarray(x, jdt)
    jsum = pl.pallas_call(
        partial(bench_script.gather_kernel, iters),
        out_shape=jax.ShapeDtypeStruct((1, lanes), jdt),
        interpret=True)(jx, jnp.asarray(idx))
    jxla = bench_script.xla_gather(jx, jnp.asarray(idx_vec), iters)
    # the script's xla_gather loop with the sum left out
    jtile = jax.lax.fori_loop(
        0, iters, lambda _, a: jnp.take(a, jnp.asarray(idx_vec), axis=0) + 1.0,
        jx)
    tx = torch.as_tensor(x).to(tdt)
    total, tile = gather.gather_iterate_plain(tx, torch.as_tensor(idx), iters)
    assert tile.dtype == tdt and total.dtype == tdt
    assert tile.shape == (rows, lanes) and total.shape == (1, lanes)
    assert np.array_equal(tile.float().numpy(),
                          np.asarray(jtile.astype(jnp.float32)))
    for ref in (jsum, jxla):
        np.testing.assert_allclose(total.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   rtol=RTOL[dtype], atol=0)
    # on CPU tensors the wrapper is the plain version and launches nothing
    before = gather.gather_iterate.launches
    w_total, w_tile = gather.gather_iterate(tx, torch.as_tensor(idx), iters)
    assert torch.equal(w_total, total) and torch.equal(w_tile, tile)
    assert gather.gather_iterate.launches == before


def test_gather_iterate_per_lane_indices():
    """Indices that differ between lanes gather each lane on its own."""
    rng = np.random.default_rng(3)
    rows, lanes, iters = 40, 6, 4
    x = torch.as_tensor(rng.standard_normal((rows, lanes)), dtype=torch.float32)
    idx = torch.as_tensor(rng.integers(0, rows, (rows, lanes)),
                          dtype=torch.int32)
    total, tile = gather.gather_iterate_plain(x, idx, iters)
    ref = x.numpy().copy()
    for _ in range(iters):
        ref = np.take_along_axis(ref, idx.numpy().astype(np.int64), 0) \
            + np.float32(1)
    assert np.array_equal(tile.numpy(), ref)
    np.testing.assert_allclose(total.numpy()[0], ref.sum(0), rtol=1e-5)


def test_lanes_per_block_fits_the_ladder_and_refuses_more():
    """P1's launch plan: L lanes a block that fit its shared memory and its
    element cap, C blocks a cluster covering a 32-byte row segment (or 8),
    and threads enough for the tile at 24 (1024 threads) or 72 (512)
    elements a thread."""
    for rows, lanes in gather_bench.LADDER + ((1000, 400), (37, 5),
                                              (35280, 130)):
        for itemsize in (4, 2):
            L, C, threads = gather.launch_plan(rows, lanes, itemsize, 132)
            assert 1 <= L <= lanes
            assert rows * L * (itemsize + 2) <= gather._SMEM_LIMIT
            assert rows * L <= gather._MAX_ELEMS
            assert C * L * itemsize >= 32 or C == gather._MAX_CLUSTER
            assert C == 1 or (C // 2) * L * itemsize < 32
            stage = -(-rows * L // threads)
            assert threads % 32 == 0
            assert stage <= (24 if threads == 1024 else 72)
            assert threads in (512, 1024) or stage == 1
    # [[144]]'s edge-slot grid: one float32 column of 141 KB per block, in
    # clusters of 8 (32-byte rows), 69 elements a thread on 512 threads
    assert gather.launch_plan(35280, 128, 4, 132) == (1, 8, 512)
    assert gather.launch_plan(35280, 128, 2, 132) == (1, 8, 512)
    assert gather.launch_plan(8192, 512, 4, 132) == (3, 4, 1024)
    assert gather.launch_plan(1024, 4096, 4, 132) == (31, 1, 512)
    assert gather.launch_plan(37, 5, 4, 132) == (1, 8, 64)
    # an H100 holds 15 clusters of 8 such blocks, 30 of 4, 66 of 2: 128
    # lanes run in one wave only in clusters of 2 (or 1)
    held = {8: 15, 4: 30, 2: 66, 1: 132}.get
    assert gather.launch_plan(35280, 128, 4, 132, held) == (1, 2, 512)
    assert gather.launch_plan(35280, 256, 4, 132, held) == (1, 2, 512)
    assert gather.launch_plan(35280, 120, 4, 132, held) == (1, 8, 512)
    assert gather.launch_plan(8192, 512, 4, 132, held) == (3, 4, 1024)
    with pytest.raises(ValueError, match="exceeds"):
        gather.launch_plan(40000, 128, 4, 132)   # shared memory
    with pytest.raises(ValueError, match="exceeds"):
        gather.launch_plan(37000, 128, 2, 132)   # elements (uint16 offsets)


def test_wrappers_reject_bad_inputs():
    x = torch.zeros((8, 4))
    idx = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gather.gather_iterate(x.to(torch.int32), idx, 1)
    with pytest.raises(ValueError, match="shape"):
        gather.gather_iterate(x, idx[:4], 1)
    with pytest.raises(ValueError, match="float32 or int32"):
        gather.take_along(x.to(torch.float64), idx, 0)
    with pytest.raises(ValueError, match="axis"):
        gather.take_along(x, idx, 2)


class _InterpretPallas:
    """Stands in for a script's ``pl``: runs ``pallas_call`` in interpret
    mode and records each call's inputs and output."""

    def __init__(self):
        self.calls = []

    def pallas_call(self, kernel, **kw):
        fn = pl.pallas_call(kernel, interpret=True, **kw)

        def run(*args):
            out = fn(*args)
            self.calls.append((args, out))
            return out
        return run


@pytest.mark.parametrize("shape", gather_probe.SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("axis", [0, 1])
def test_take_along_matches_probe_kernel(probe_script, monkeypatch, capsys,
                                         axis, dtype, shape):
    rec = _InterpretPallas()
    monkeypatch.setattr(probe_script, "pl", rec)
    probe_script.probe("case", shape, getattr(jnp, dtype), axis)
    assert "OK  match=True" in capsys.readouterr().out
    (jx, jidx), jout = rec.calls[0]
    x, idx = torch.as_tensor(np.array(jx)), torch.as_tensor(np.array(jidx))
    out = gather.take_along_plain(x, idx, axis)
    assert out.dtype == getattr(torch, dtype)
    assert np.array_equal(out.numpy(), np.asarray(jout))
    # the port's probe draws the JAX probe's inputs
    px, pidx = gather_probe.probe_inputs(shape, getattr(torch, dtype), axis)
    assert torch.equal(px, x) and torch.equal(pidx, idx)
    before = gather.take_along.launches
    assert torch.equal(gather.take_along(px, pidx, axis), out)
    assert gather.take_along.launches == before
