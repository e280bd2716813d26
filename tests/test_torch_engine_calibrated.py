"""The port's pooled dispatch vs the JAX engine with a calibrated alpha
sequence.

A gated autoregressive sequence per basis, fitted by the port, replaces the
dynamical schedule; one pooled dispatch of the port, fed the gate randoms
JAX draws, must give the per-shot flags of the JAX pooled round with both
Pallas kernels in interpret mode (the JAX flooding kernel against the
port's K1 plain version, the main path's kernels under a fitted sequence).
The harness is tests/test_torch_engine_generic.py's.
"""
import numpy as np
import pytest
import torch

import jax

from qldpc_tpu.ops import osd_pallas as jax_osd_pallas
from qldpc_tpu.parallel import engine as jengine

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.ops import calibrate as tcal
from qldpc_tpu_torch.ops.bp import alpha_schedule

from test_torch_engine_generic import MAXITER, P, _assert_flags_equal, \
    _flags, _setup

torch.set_num_threads(1)


@pytest.fixture
def pallas_interpreted(monkeypatch):
    """Both JAX Pallas kernels in interpret mode, as the JAX package's own
    tests run them on the CPU."""
    bp = jengine.decode_batch_lift_pallas
    elim = jax_osd_pallas.eliminate_blocks
    monkeypatch.setattr(jengine, "decode_batch_lift_pallas",
                        lambda *a, **k: bp(*a, **k, interpret=True))
    monkeypatch.setattr(jax_osd_pallas, "eliminate_blocks",
                        lambda *a, **k: elim(*a, **k, interpret=True))
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_calibrated_sequence(pallas_interpreted):
    """A gated autoregressive sequence fitted by the port on each basis
    (calibration errors from the port's own generator) runs through K1's
    plain version and JAX's Pallas flooding kernel alike."""
    setups = {True: _setup(True)}
    tM = setups[True][3]
    seqs = []
    for b, seed in (("Z", 1), ("X", 2)):
        alphas, _ = tcal.estimate_alpha_alvarado_autoregressive(
            tM[f"Hdec{b}"], P, 4, trials=150, seed=seed,
            llrs=qt.channel_llrs(tM[f"channel_probs{b}"]), device="cpu")
        seqs.append(alpha_schedule("alvarado-autoregressive", MAXITER,
                                   alphas))
    assert not np.array_equal(seqs[0], alpha_schedule("dynamical", MAXITER))
    want, got, _ = _flags(setups, True, seqs, use_pallas=True)
    _assert_flags_equal(want, got)
