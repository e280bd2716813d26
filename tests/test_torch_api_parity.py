"""Public arguments of the JAX package that the port keeps, and the OSD
reprocess replay of ``engine._decode_one_basis``, held against the JAX
package on the CPU.

* ``ops.bp.harvest_messages`` takes ``damping`` in JAX's position (between
  ``advance_iters`` and ``clip_llr``); damped messages equal JAX's bit for
  bit in float32.
* ``ops.calibrate.estimate_scopt_beta`` takes ``chunk``: both packages
  draw and decode in chunks of that size (the samplers are replaced by one
  numpy stream, as in test_torch_calibrate.py) and fit the same beta.
* ``ops.sampler.TrialMaps.num_locations`` equals JAX's.
* ``engine._decode_one_basis`` never answers from a truncated reprocess:
  random syndromes outside H's column span fail OSD-0 on every shot, so a
  64-shot chunk overflows the 32-shot reprocess slice; without the replay
  the port differs from JAX per shot, with it the port equals JAX. Both
  decoders run on the padded-CSR graph (no lift), where float32 min-sum
  and the OSD equal JAX's exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import qldpc_tpu
from qldpc_tpu.ops import bp as jbp
from qldpc_tpu.ops import calibrate as jcal
from qldpc_tpu.ops.sampler import make_trial_maps as jmaps
from qldpc_tpu.parallel import engine as jengine

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.ops import bp as tbp
from qldpc_tpu_torch.ops import calibrate as tcal
from qldpc_tpu_torch.ops import osd as tosd
from qldpc_tpu_torch.ops.sampler import make_trial_maps as tmaps
from qldpc_tpu_torch.parallel import engine as tengine

from test_torch_calibrate import numpy_sampler

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def m72():
    """[[72,12,6]], 3 cycles, p=0.01: the JAX package's matrices, circuit
    and code, and the port's circuit."""
    code = qldpc_tpu.get_code("[[72, 12, 6]]")
    circ = qldpc_tpu.SyndromeCircuit(code, num_cycles=3)
    M = qldpc_tpu.build_decoding_matrices(circ, code.Lx, code.Lz, 0.01)
    tcirc = qt.SyndromeCircuit(qt.get_code("[[72, 12, 6]]"), num_cycles=3)
    return circ, M, tcirc


def _harvest_inputs(M):
    H = (M["HdecZ"] != 0).astype(np.uint8)
    prior = qldpc_tpu.channel_llrs(M["channel_probsZ"])
    rng = np.random.default_rng(2)
    errors = rng.random((48, H.shape[1])) < M["channel_probsZ"]
    syn = ((errors.astype(np.int8) @ H.T) % 2).astype(np.int8)
    seq = jbp.alpha_schedule("alvarado-autoregressive", 8,
                             [0.6, 0.7, 0.75, 0.8, 0.85])
    j = (jbp.TannerGraph.from_dense(H), jnp.asarray(syn),
         jnp.asarray(prior, jnp.float32), jnp.asarray(seq))
    t = (tbp.TannerGraph.from_dense(H, device="cpu"), torch.as_tensor(syn),
         torch.as_tensor(prior, dtype=torch.float32), torch.as_tensor(seq))
    return j, t


@pytest.mark.parametrize("call", ["damping=0.8", "positional 0.8, clip 6",
                                  "positional 1.0, clip 6"])
def test_harvest_messages_damping_bit_exact(m72, call):
    """Five advanced iterations, damped or with a tighter clip: every row
    edge's message equals JAX's bit for bit."""
    j, t = _harvest_inputs(m72[1])
    if call == "damping=0.8":
        jR, jcols = jbp.harvest_messages(*j, 5, damping=0.8)
        tR, tcols = tbp.harvest_messages(*t, 5, damping=0.8)
    else:
        d = 0.8 if "0.8" in call else 1.0
        jR, jcols = jbp.harvest_messages(*j, 5, d, 6.0)
        tR, tcols = tbp.harvest_messages(*t, 5, d, 6.0)
    assert np.array_equal(np.asarray(jcols), tcols.numpy())
    mask = t[0].row_mask.numpy()
    jR, tR = np.asarray(jR)[mask], tR.numpy()[mask]
    assert tR.dtype == np.float32 and np.array_equal(tR, jR)
    # each call changes the messages of the default call
    default = tbp.harvest_messages(*t, 5)[0].numpy()[mask]
    assert not np.array_equal(tR, default)


def _recording_sampler(seed, package, log):
    draw = numpy_sampler(seed, package)

    def sample(key, HT, n, p, trials):
        log.append(trials)
        return draw(key, HT, n, p, trials)
    return sample


@pytest.mark.parametrize("chunk", [128, 512])
def test_scopt_beta_chunk_matches_jax(m72, monkeypatch, chunk):
    """Both packages decode ``chunk`` trials a call (the draws recorded)
    and fit the same beta."""
    M = m72[1]
    H, llrs = M["HdecZ"], qldpc_tpu.channel_llrs(M["channel_probsZ"])
    jlog, tlog = [], []
    monkeypatch.setattr(jcal, "_sample_errors_and_syndromes",
                        _recording_sampler(11, "jax", jlog))
    monkeypatch.setattr(tcal, "_sample_errors_and_syndromes",
                        _recording_sampler(11, "torch", tlog))
    want = jcal.estimate_scopt_beta(H, 0.01, trials=300, maxIter=8,
                                    llrs=llrs, chunk=chunk)
    got = tcal.estimate_scopt_beta(H, 0.01, trials=300, maxIter=8,
                                   llrs=llrs, chunk=chunk, device="cpu")
    assert jlog == tlog == [min(chunk, 300 - c) for c in range(0, 300, chunk)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[0] < 0


def test_scopt_chunk_sets_the_ports_draws(m72):
    """On the port's own sampler each chunk draws from a generator seeded
    by its first trial, so the chunk size changes the draws and the fit."""
    M = m72[1]
    H, llrs = M["HdecZ"], qldpc_tpu.channel_llrs(M["channel_probsZ"])
    a = tcal.estimate_scopt_beta(H, 0.01, trials=200, maxIter=8, llrs=llrs,
                                 chunk=64, device="cpu")
    b = tcal.estimate_scopt_beta(H, 0.01, trials=200, maxIter=8, llrs=llrs,
                                 device="cpu")
    assert a[0] != b[0] and np.isfinite(a).all() and np.isfinite(b).all()


def test_trial_maps_num_locations(m72):
    """[[72,12,6]] at 6 cycles, both bases."""
    code = qldpc_tpu.get_code("[[72, 12, 6]]")
    circ = qldpc_tpu.SyndromeCircuit(code, num_cycles=6)
    M = qldpc_tpu.build_decoding_matrices(circ, code.Lx, code.Lz, 0.006)
    tcirc = qt.SyndromeCircuit(qt.get_code("[[72, 12, 6]]"), num_cycles=6)
    for b in "ZX":
        want = jmaps(circ, M, b).num_locations
        got = tmaps(tcirc, M, b, device="cpu").num_locations
        assert isinstance(got, int) and got == want > 0


def test_decode_one_basis_replays_an_overflowed_reprocess(m72):
    circ, M, tcirc = m72
    maxIter, order, B = 8, 2, 128
    seq = jbp.alpha_schedule("dynamical", maxIter)
    jdec = dataclasses.replace(
        jengine._make_basis(circ, M, "Z", seq, osd_order=order), lifted=None)
    tdec = dataclasses.replace(
        tengine._make_basis(tcirc, M, "Z", seq, osd_order=order,
                            device="cpu"), lifted=None)
    rng = np.random.default_rng(5)
    syn = (rng.random((B, M["HdecZ"].shape[0])) < 0.5).astype(np.int8)
    jlog, jconv, jrdef = (np.asarray(x) for x in jengine._decode_logicals(
        jnp.asarray(syn), jdec, maxIter, order, 1.0, 20.0, False,
        jnp.float32))
    assert not jconv.any() and jrdef.all()       # OSD-0 failed everywhere
    syn_t, tru_t = torch.as_tensor(syn), torch.as_tensor(jlog.copy())
    # the call without the replay (the reprocess holds 32 of each chunk's
    # 64 failed shots) differs from JAX on shots past the slice
    log, conv, rdef, overflow = tengine._decode_logicals(
        syn_t, tdec, maxIter, order, return_overflow=True)
    assert tosd.REPROCESS_SLICE == 32 and int(overflow.sum()) == B // 2
    wrong = (log.numpy() != jlog).any(1)
    assert wrong.any() and not wrong[~overflow.numpy()].any()
    # the repaired call replays and equals JAX per shot
    jerr, jc, jr = (np.asarray(x) for x in jengine._decode_one_basis(
        jnp.asarray(syn), jnp.asarray(jlog), jdec, maxIter, order, 1.0,
        20.0, False, jnp.float32))
    err, conv, rdef, first_pass = tengine._decode_one_basis(
        syn_t, tru_t, tdec, maxIter, order, return_overflow=True)
    assert not jerr.any()
    assert np.array_equal(err.numpy(), jerr)
    assert np.array_equal(conv.numpy(), jc)
    assert np.array_equal(rdef.numpy(), jr)
    assert np.array_equal(first_pass.numpy(), overflow.numpy())
