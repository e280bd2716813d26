"""The port's BatchDecoder and _decode_logicals vs the JAX package's.

The same [[72,12,6]] (3 cycles) syndromes, drawn with numpy from the
builder's channel, go through JAX's ``BatchDecoder(use_pallas=True)`` with
its Pallas kernels in interpret mode and through the port's BatchDecoder on
the CPU (the plain versions of K1 and K2): ``logicals``, ``converged`` and
``rank_deficient`` must match exactly, in both bases, through the padding
path (N=21, batch_size=8). JAX's basis carried across by
``convert.basis_from_jax`` must decode as the port's own. The layered
schedule (K3's plain version) is held in test_torch_decoder_layered*.py:
compiling JAX's layered kernel in interpret mode takes ~35 s a basis.
"""
import numpy as np
import pytest
import torch

import jax

import qldpc_tpu
from qldpc_tpu.ops import osd_pallas as jax_osd_pallas
from qldpc_tpu.parallel import engine as jengine
from qldpc_tpu.parallel.decoder import BatchDecoder as JBatchDecoder

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.convert import LIFT_STATICS, basis_from_jax
from qldpc_tpu_torch.parallel import engine as tengine

torch.set_num_threads(1)

CODE, CYCLES, P = "[[72, 12, 6]]", 3, 0.004
MAXITER, OSD_ORDER = 10, 2


@pytest.fixture(scope="module")
def jax_kernels_interpreted():
    """Both JAX Pallas kernels in interpret mode, as the JAX package's own
    tests run them on the CPU; module-scoped, so one compile of a decoder
    serves every test of the file."""
    bp = jengine.decode_batch_lift_pallas
    elim = jax_osd_pallas.eliminate_blocks
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "decode_batch_lift_pallas",
                   lambda *a, **k: bp(*a, **k, interpret=True))
        mp.setattr(jax_osd_pallas, "eliminate_blocks",
                   lambda *a, **k: elim(*a, **k, interpret=True))
        jax.clear_caches()
        yield
    jax.clear_caches()


def _bb_kwargs(code):
    return dict(ell=code.ell, m=code.m, a_x_powers=code.a_x_powers,
                a_y_powers=code.a_y_powers, b_y_powers=code.b_y_powers,
                b_x_powers=code.b_x_powers)


@pytest.fixture(scope="module")
def setup72():
    code = qt.get_code(CODE)
    circ = qt.SyndromeCircuit(code, num_cycles=CYCLES)
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, P)
    return code, M


def _syndromes(M, basis, N, seed, scale=2.0):
    """(N, m) syndromes and true logical effects of class-level errors at
    ``scale`` times the builder's channel (enough to fail BP on some)."""
    rng = np.random.default_rng(seed)
    probs = np.minimum(M[f"channel_probs{basis}"] * scale, 0.5)
    e = (rng.random((N, len(probs))) < probs).astype(np.uint8)
    H = (np.asarray(M[f"Hdec{basis}"]) != 0).astype(np.uint8)
    first, k = M[f"first_logical_row{basis}"], M["k"]
    L = (np.asarray(M[f"H{basis}_full"])[first:first + k] != 0).astype(
        np.uint8)
    return (e @ H.T) % 2, (e @ L.T) % 2


def make_decoders(code, M, bp_variant):
    """(JAX BatchDecoder(use_pallas=True), the port's on the CPU)."""
    kw = dict(num_cycles=CYCLES, maxIter=MAXITER, osd_order=OSD_ORDER,
              precomputed_matrices=M, bp_variant=bp_variant,
              **_bb_kwargs(code))
    jdec = JBatchDecoder(code.Hx, code.Hz, code.Lx, code.Lz, P,
                         use_pallas=True, **kw)
    tdec = qt.BatchDecoder(code.Hx, code.Hz, code.Lx, code.Lz, P,
                           device="cpu", **kw)
    return jdec, tdec


@pytest.fixture(scope="module")
def decoders(jax_kernels_interpreted, setup72):
    return make_decoders(*setup72, "minsum")


def check_batch_decoder(jdec, tdec, M, basis):
    """The port's BatchDecoder.decode against JAX's on 21 syndromes of
    ``basis`` (batch_size 8: two full calls and a padded one)."""
    syn, _ = _syndromes(M, basis, 21, seed=8 if basis == "Z" else 9)
    want = jdec.decode(syn, basis=basis, batch_size=8)
    got = tdec.decode(syn, basis=basis, batch_size=8)
    assert set(got) == set(want) == {"logicals", "converged",
                                     "rank_deficient"}
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        assert np.array_equal(got[key], want[key]), key
    assert 0 < want["converged"].sum() < 21  # some shots went to OSD


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_batch_decoder_matches_jax(decoders, setup72, basis):
    check_batch_decoder(*decoders, setup72[1], basis)


def test_decode_logicals_matches_jax(decoders, setup72):
    """The engine function under BatchDecoder on one 72-shot batch (its OSD
    in chunks of 64 and 8), through the port's own basis and through JAX's
    carried across by basis_from_jax, against JAX's engine function on
    8-shot batches (per-shot outputs do not depend on the grouping)."""
    jdec, tdec = decoders
    syn, _ = _syndromes(setup72[1], "Z", 72, seed=3)
    want = [[np.asarray(v) for v in jdec._jitted(
        jax.numpy.asarray(syn[c:c + 8]), jdec.bases["Z"])]
        for c in range(0, 72, 8)]
    want = [np.concatenate(v) for v in zip(*want)]
    carried = basis_from_jax(*_jax_leaves(jdec.bases["Z"]), device="cpu")
    for dec in (tdec.bases["Z"], carried):
        got = tengine._decode_logicals(torch.as_tensor(syn.astype(np.int8)),
                                       dec, MAXITER, OSD_ORDER)
        for w, g in zip(want, got):
            assert np.array_equal(w, g.numpy())
    assert 0 < int(want[1].sum()) < 72


def _jax_leaves(dec) -> tuple:
    """The leaves of a JAX BasisDecoder as numpy arrays + metadata, as
    convert.basis_from_jax takes them."""
    g, mp, tg = dec.lifted, dec.maps, dec.graph
    f32 = jax.numpy.float32
    arrays = dict(
        sel=mp.sel, gate_loc=mp.gate_loc, A_loc=mp.A_loc.astype(f32),
        prior_grid=g.prior_grid, slot_mask=g.slot_mask, cmask=g.cmask,
        out_gather=g.out_gather, residual=g.residual,
        row_cols=tg.row_cols, row_mask=tg.row_mask, col_edges=tg.col_edges,
        col_mask=tg.col_mask, H=dec.H, H_logical=dec.H_logical.astype(f32),
        logical_pack=dec.logical_pack, prior=dec.prior,
        alpha_seq=dec.alpha_seq, basis_cols=dec.basis_cols)
    meta = dict(num_syn=mp.num_syn, k=mp.k, K=dec.K, num_test=dec.num_test,
                rank=dec.rank, **{k: getattr(g, k) for k in LIFT_STATICS})
    return {k: np.asarray(v) for k, v in arrays.items()}, meta


def test_decode_recovers_true_logicals_at_low_p(setup72):
    """JAX's test of the same name on the port: at the builder's own
    channel the decoded logical action matches the injected errors' for
    the vast majority of shots."""
    code, M = setup72
    syn, true_log = _syndromes(M, "Z", 64, seed=5, scale=1.0)
    dec = qt.BatchDecoder(code.Hx, code.Hz, code.Lx, code.Lz, P,
                          num_cycles=CYCLES, maxIter=20, osd_order=2,
                          precomputed_matrices=M, device="cpu",
                          **_bb_kwargs(code))
    out = dec.decode(syn, basis="Z", batch_size=64)
    assert (out["logicals"] == true_log).all(1).mean() > 0.9


def test_decode_validates_shape_and_empty(setup72):
    code, M = setup72
    tdec = qt.BatchDecoder(code.Hx, code.Hz, code.Lx, code.Lz, P,
                           num_cycles=CYCLES, maxIter=5, osd_order=0,
                           precomputed_matrices=M, device="cpu",
                           **_bb_kwargs(code))
    with pytest.raises(ValueError, match="syndromes"):
        tdec.decode(np.zeros((4, 7), np.uint8), basis="Z")
    out = tdec.decode(np.zeros((0, tdec.num_syn["X"]), np.uint8), basis="x")
    assert out["logicals"].shape == (0, M["k"])
    assert out["logicals"].dtype == np.int32
    assert out["converged"].shape == out["rank_deficient"].shape == (0,)


def test_device_rule(setup72, monkeypatch):
    """Without a GPU the default device raises; nothing falls back."""
    code, M = setup72
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        qt.BatchDecoder(code.Hx, code.Hz, code.Lx, code.Lz, P,
                        num_cycles=CYCLES, precomputed_matrices=M,
                        **_bb_kwargs(code))
