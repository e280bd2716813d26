"""Port host layer vs the JAX package: builder, lifted graph, bundles.

The PyTorch port (qldpc_tpu_torch) keeps its own NumPy copy of the host
layer; here it must reproduce the JAX package's arrays byte for byte, and a
JAX decode bundle carried across with ``basis_from_jax`` must equal the
port's own.
"""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import qldpc_tpu
from qldpc_tpu.ops.bp import alpha_schedule
from qldpc_tpu.parallel import engine as jengine

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.convert import LIFT_STATICS, basis_from_jax
from qldpc_tpu_torch.models import gf2
from qldpc_tpu_torch.ops.bp_lift import LiftedGraph
from qldpc_tpu_torch.parallel import engine as tengine

torch.set_num_threads(1)

CODE, CYCLES, P = "[[72, 12, 6]]", 6, 0.006


@pytest.fixture(scope="module")
def built():
    jcode = qldpc_tpu.get_code(CODE)
    jcirc = qldpc_tpu.SyndromeCircuit(jcode, num_cycles=CYCLES)
    jM = qldpc_tpu.build_decoding_matrices(jcirc, jcode.Lx, jcode.Lz, P)
    tcode = qt.get_code(CODE)
    tcirc = qt.SyndromeCircuit(tcode, num_cycles=CYCLES)
    tM = qt.build_decoding_matrices(tcirc, tcode.Lx, tcode.Lz, P)
    return jcode, jcirc, jM, tcode, tcirc, tM


def test_builder_byte_identical(built):
    jcode, jcirc, jM, tcode, tcirc, tM = built
    assert np.array_equal(jcode.Lx, tcode.Lx)
    assert np.array_equal(jcode.Lz, tcode.Lz)
    assert set(jM) == set(tM)
    for key in jM:
        a, b = np.asarray(jM[key]), np.asarray(tM[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key
    assert jcirc.num_error_locs == tcirc.num_error_locs


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_gf2_rank_and_basis_match(built, basis):
    from qldpc_tpu.models import gf2 as jgf2
    jM = built[2]
    H = (np.asarray(jM[f"Hdec{basis}"]) != 0).astype(np.uint8)
    assert gf2.rank_fast(H) == jgf2.rank_fast(H)
    assert np.array_equal(gf2.column_basis(H), jgf2.column_basis(H))


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_lifted_graph_identical(built, basis):
    from qldpc_tpu.ops.bp_lift import LiftedGraph as JLiftedGraph
    jcode, _, jM = built[:3]
    H = (np.asarray(jM[f"Hdec{basis}"]) != 0).astype(np.uint8)
    prior = qldpc_tpu.channel_llrs(jM[f"channel_probs{basis}"])
    jg = JLiftedGraph.try_from_dense(H, jcode.ell, jcode.m, prior)
    tg = LiftedGraph.try_from_dense(H, jcode.ell, jcode.m, prior,
                                    device="cpu")
    assert jg is not None and tg is not None
    for name in ("prior_grid", "slot_mask", "cmask", "out_gather",
                 "residual"):
        assert np.array_equal(np.asarray(getattr(jg, name)),
                              getattr(tg, name).numpy()), name
    for name in LIFT_STATICS:
        assert getattr(jg, name) == getattr(tg, name), name
    # a graph that is not a lift is refused, as in the JAX package
    assert LiftedGraph.try_from_dense(H[:, ::-1][:-1], jcode.ell, jcode.m,
                                      prior, device="cpu") is None


def _jax_leaves(dec) -> tuple:
    """The leaves of a JAX BasisDecoder as numpy arrays + metadata."""
    g, mp, tg = dec.lifted, dec.maps, dec.graph
    arrays = dict(
        sel=mp.sel, gate_loc=mp.gate_loc,
        A_loc=np.asarray(mp.A_loc.astype(jnp.float32)),
        prior_grid=g.prior_grid, slot_mask=g.slot_mask, cmask=g.cmask,
        out_gather=g.out_gather, residual=g.residual,
        row_cols=tg.row_cols, row_mask=tg.row_mask, col_edges=tg.col_edges,
        col_mask=tg.col_mask, H=dec.H,
        H_logical=np.asarray(dec.H_logical.astype(jnp.float32)),
        logical_pack=dec.logical_pack, prior=dec.prior,
        alpha_seq=dec.alpha_seq, basis_cols=dec.basis_cols)
    meta = dict(num_syn=mp.num_syn, k=mp.k, K=dec.K, num_test=dec.num_test,
                rank=dec.rank, **{k: getattr(g, k) for k in LIFT_STATICS})
    return {k: np.asarray(v) for k, v in arrays.items()}, meta


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_basis_from_jax_round_trip(built, basis):
    _, jcirc, jM, _, tcirc, tM = built
    seq = alpha_schedule("dynamical", 20)
    jdec = jengine._make_basis(jcirc, jM, basis, seq, osd_order=2)
    arrays, meta = _jax_leaves(jdec)
    conv = basis_from_jax(arrays, meta, device="cpu")
    own = tengine._make_basis(tcirc, tM, basis, seq, osd_order=2,
                              device="cpu")
    for name in ("K", "num_test", "rank"):
        assert getattr(conv, name) == getattr(own, name), name
    for name in ("H", "HT", "H_logical", "logical_pack", "prior",
                 "alpha_seq", "basis_cols"):
        a, b = getattr(conv, name), getattr(own, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    for name in ("sel", "gate_loc", "sig_ptr", "sig_row"):
        assert torch.equal(getattr(conv.maps, name),
                           getattr(own.maps, name)), name
    assert (conv.maps.num_syn, conv.maps.k) == (own.maps.num_syn, own.maps.k)
    for name in ("prior_grid", "slot_mask", "cmask", "out_gather",
                 "residual"):
        assert torch.equal(getattr(conv.lifted, name),
                           getattr(own.lifted, name)), name
    for name in LIFT_STATICS:
        assert getattr(conv.lifted, name) == getattr(own.lifted, name), name
    for name in ("row_cols", "row_mask", "col_edges", "col_mask"):
        a, b = getattr(conv.graph, name), getattr(own.graph, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
        assert np.array_equal(np.asarray(getattr(jdec.graph, name)),
                              a.numpy()), name
    for name in ("m", "n", "dr", "dc"):
        assert getattr(conv.graph, name) == getattr(own.graph, name) == \
            getattr(jdec.graph, name), name


def test_port_imports_without_jax():
    """Every module of qldpc_tpu_torch imports with jax and the JAX package
    blocked, ``scripts.ler_oracle`` reads the committed trials and codes
    so, and chip_smoke.py imports neither."""
    root = Path(__file__).resolve().parent.parent
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['qldpc_tpu'] = None\n"
        "import qldpc_tpu_torch\n"
        "def fail(name):\n"
        "    raise ImportError(name)\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    qldpc_tpu_torch.__path__, 'qldpc_tpu_torch.', onerror=fail)]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert qldpc_tpu_torch.run_simulation is not None\n"
        "assert qldpc_tpu_torch.run_multi_code_simulation is not None\n"
        "from qldpc_tpu_torch.scripts import ler_oracle\n"
        "import numpy as np\n"
        "c = ler_oracle.load_code('[[90, 8, 10]]')\n"
        "t = np.load(ler_oracle.data_path('[[90, 8, 10]]', 10, 0.004))\n"
        "r = np.load(ler_oracle.record_path('[[90, 8, 10]]', 10, 0.004, 20))\n"
        "assert t['syn_z'].shape[1] == 540 and c.Lx.shape == (8, 90)\n"
        "assert r['z_err'].shape == (4000,)\n"
        "print(' '.join(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    for name in ("parallel.engine", "parallel.mesh",
                 "scripts.multihost_smoke", "ops.osd_cuda", "ops.gather",
                 "ops.bp", "ops.calibrate",
                 "models.builder", "profile_round", "utils.caching",
                 "scripts.bp_breakdown", "scripts.gather_bench",
                 "scripts.gather_probe", "_kernels", "convert",
                 "scripts.validate_ler", "scripts.merge_validation",
                 "examples", "examples.toy_example", "examples.toy_422",
                 "ops.osd", "ops.sampler", "parallel.decoder",
                 "parallel.code_capacity", "utils.benchloop",
                 "utils.telemetry",
                 "scripts.multicode_bench", "scripts.pooled_ab",
                 "scripts.maxiter_sweep", "scripts.bench288_sweep",
                 "scripts.scaling_bench", "scripts.osd144_stage_ab",
                 "scripts.osd288_ab", "scripts.osd288_probe",
                 "scripts.osd_margin_probe", "scripts.osd_microbench",
                 "scripts.bp_lift_bench", "scripts.ler_oracle",
                 "scripts.osd_post_micro", "scripts.bp_microbench",
                 "scripts.osd_blockshots_sweep",
                 "scripts.osd288_tailblock_ab", "scripts.osd_panel_probe",
                 "scripts.bp_grid_experiment"):
        assert f"qldpc_tpu_torch.{name}" in names, name
    tree = ast.parse((root / "chip_smoke.py").read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.add(node.module.split(".")[0])
    assert "qldpc_tpu_torch" in imported
    assert not imported & {"jax", "jaxlib", "qldpc_tpu"}, imported


def test_device_rule():
    """Entry points default to CUDA and raise without it; the CPU runs only
    when asked for."""
    assert qt.resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert qt.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            qt.resolve_device(None)
