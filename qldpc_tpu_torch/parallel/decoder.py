"""Public batched decode API for measured syndromes.

``run_simulation`` samples its own noise; a deployment has measured
syndromes. ``BatchDecoder`` runs the decode path of a Monte-Carlo round
(BP, OSD on the shots BP did not converge, logical readout:
``engine._decode_logicals``) on syndrome batches: build it once per
(code, p, cycles), then call ``decode`` on (N, num_syn) sparsified
syndromes of either basis.

Counterpart of the JAX package's ``parallel/decoder.py`` with ``device`` in
place of ``use_pallas``. On the card, flooding BP runs kernel K1 and
``bp_variant="layered"`` kernel K3 (on a lifted graph, damping 1); OSD runs
K2, or K4 / K5 under ``QLDPC_OSD_KERNEL``. ``device="cpu"`` runs their
plain versions; without a GPU the default device raises.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models.bb import make_code
from ..models.builder import build_decoding_matrices
from ..models.circuit import SyndromeCircuit
from ..ops.bp import alpha_schedule
from .engine import (_decode_logicals, _make_basis, _round_defaults,
                     ensure_sampler_metadata)


class BatchDecoder:
    """Batched BP+OSD decoder over a fixed code / error-rate configuration.

    Arguments as the JAX package's ``BatchDecoder``, with ``device`` (None
    = ``cuda``) in place of ``use_pallas``. ``alpha`` follows
    ``alpha_mode``: None for "dynamical", a scalar for "alvarado", a
    per-iteration sequence for "alvarado-autoregressive". ``msg_dtype``
    (messages of the damped and padded-CSR decoders) and the layered
    fallback resolve as in ``run_simulation``.
    """

    def __init__(self, Hx, Hz, Lx, Lz, error_rate, num_cycles=12,
                 maxIter=20, osd_order=2, alpha_mode="dynamical", alpha=None,
                 precomputed_matrices: Optional[Dict] = None,
                 damping: float = 1.0, clip_llr: float = 20.0,
                 device=None, msg_dtype=None, bp_variant: str = "minsum",
                 **bb_params):
        self.device = resolve_device(device)
        code = make_code(Hx, Hz, Lx, Lz, **bb_params)
        self.circ = SyndromeCircuit(code, num_cycles=num_cycles)
        matrices = precomputed_matrices or build_decoding_matrices(
            self.circ, code.Lx, code.Lz, error_rate)
        matrices = ensure_sampler_metadata(matrices, self.circ, code.Lx,
                                           code.Lz, error_rate)
        seq = alpha_schedule(alpha_mode, maxIter,
                             1.0 if alpha is None else alpha)
        self.maxIter = maxIter
        self.osd_order = osd_order
        self.damping = damping
        self.clip_llr = clip_llr
        self.bases = {b: _make_basis(self.circ, matrices, b, seq,
                                     osd_order=osd_order, device=self.device)
                      for b in "ZX"}
        self.msg_dtype, self.bp_variant = _round_defaults(
            self.bases["Z"], damping, msg_dtype, bp_variant)
        self.num_syn = {b: self.bases[b].H.shape[0] for b in "ZX"}

    def decode(self, syndrome, basis: str = "Z",
               batch_size: int = 256) -> Dict[str, np.ndarray]:
        """Decode (N, num_syn) sparsified syndromes, ``batch_size`` shots a
        call (the last call padded with zero syndromes).

        Returns numpy arrays: ``logicals`` (N, k) int32, the decoded
        correction's logical action (compare with the true logical effect
        to score a logical error); ``converged`` (N,) bool (BP converged;
        False means OSD gave the answer); ``rank_deficient`` (N,) bool."""
        b = basis.upper()
        dec = self.bases[b]
        syn = np.asarray(syndrome, dtype=np.uint8)
        if syn.ndim != 2 or syn.shape[1] != self.num_syn[b]:
            raise ValueError(
                f"expected (N, {self.num_syn[b]}) {b}-basis syndromes, "
                f"got {syn.shape}")
        N = syn.shape[0]
        if N == 0:
            k = dec.H_logical.shape[1]
            return dict(logicals=np.zeros((0, k), np.int32),
                        converged=np.zeros(0, bool),
                        rank_deficient=np.zeros(0, bool))
        B = min(batch_size, N)
        pad = (-N) % B
        if pad:
            syn = np.concatenate([syn, np.zeros((pad, syn.shape[1]),
                                                np.uint8)])
        syn_t = torch.as_tensor(syn.astype(np.int8), device=self.device)

        def call(c0, replay=False):
            return _decode_logicals(
                syn_t[c0:c0 + B], dec, self.maxIter, self.osd_order,
                self.damping, self.clip_llr, self.msg_dtype, self.bp_variant,
                replay=replay, return_overflow=True)

        starts = range(0, len(syn), B)
        outs = [call(c0) for c0 in starts]
        # a call whose OSD reprocess slice overflowed decodes again with
        # whole chunks (one host read for all calls, as the results are
        # read back here anyway)
        for i, over in enumerate(torch.stack(
                [o[3].any() for o in outs]).tolist()):
            if over:
                outs[i] = call(starts[i], replay=True)
        logs, convs, rdefs = ([o[j] for o in outs] for j in range(3))
        return dict(logicals=torch.cat(logs)[:N].cpu().numpy(),
                    converged=torch.cat(convs)[:N].cpu().numpy(),
                    rank_deficient=torch.cat(rdefs)[:N].cpu().numpy())
