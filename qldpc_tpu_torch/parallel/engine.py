"""Monte-Carlo logical-error-rate engine on CUDA devices.

Port of the JAX package's ``run_simulation`` and
``run_multi_code_simulation``: per-basis alpha sequences (dynamical, or
calibrated on the device: Alvarado, autoregressive Alvarado; optional
SCOPT beta, reported), BP, pooled, residual-sorted OSD with the staged
eliminator, logical readout, and exact sequential stopping.
One decode round = ``batch`` shots: sample gate faults -> their syndromes
(kernel S1, ops/sampler.py) -> BP -> OSD on the shots BP did not converge
(the BP residual by kernel R1, then K2, or K4 / K5 under
``QLDPC_OSD_KERNEL=2`` / ``3``, see ops/osd_cuda.py) -> logical comparison.
BP is dispatched as in the JAX package: on a lifted graph with damping 1,
kernel K1 (flooding, ``bp_variant="minsum"``) or K3 (``"layered"``);
damped on a lifted graph, the roll decoder (ops/bp_lift.py); tanh BP and
graphs without a lift, the padded-CSR decoder (ops/bp.py). Stopping
reproduces the reference's sequential rule exactly: per-shot error flags
are read in shot order and the run truncates at the trial where the target
error count is reached. A multi-code run decodes every code's batch in
each dispatch and stops each code at its own crossing trial.

Both entry points run over a shot mesh (``parallel/mesh.py``): the shards
of a ``torch.distributed`` process group, one process per GPU, or several
shards in one process. Steady rounds read only all-reduced counts; the
per-shot flags are gathered only in a crossing (or truncated final) round.

The round contract is the JAX package's: a dispatch issues its work and
reads nothing back. Its OSD chunks, the staged scan's tail, the basis rerun
and the reprocess are gated on device counts (ops/osd.py), and its counts
stay device tensors; the stopping loop keeps ``pipeline_depth`` dispatches
in flight and reads the counts of the oldest, one round late. A round
whose reprocess slice overflowed (``osd_overflow``; no recorded run has
needed it) is replayed from its saved generator state with the whole chunk
as the slice, on every rank together, so the tallies equal a run at depth 1.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models import gf2
from ..models.bb import make_code
from ..models.builder import build_decoding_matrices, channel_llrs
from ..models.circuit import SyndromeCircuit
from ..ops import calibrate
from ..ops.bp import (TannerGraph, alpha_schedule, decode_batch,
                      decode_batch_tanh)
from ..ops.bp_lift import LiftedGraph, decode_batch_lift
from ..ops.bp_lift_cuda import decode_batch_lift_cuda
from ..ops.bp_lift_layered_cuda import decode_batch_lift_layered_cuda
from ..ops import osd
from ..ops.osd import choose_K, osd_batch
from ..ops.osd_cuda import (ColumnIndex, bp_residual, column_index,
                            column_stride)
from ..ops.sampler import TrialMaps, make_trial_maps, trial_batch
from ..utils import telemetry
from .mesh import (ShotMesh, broadcast_from_rank0, gather_flags, generator,
                   read_counts, shard_rounds, shot_mesh)

logger = logging.getLogger(__name__)

# the counted flags of a decode round that the stopping loop reads
_STOP_KEYS = ("any_err", "z_err", "x_err", "z_rankdef", "x_rankdef")

_SAMPLER_KEYS = ("z_loc_gate_loc", "z_loc_role", "z_loc_class",
                 "x_loc_gate_loc", "x_loc_role", "x_loc_class")

# The pooled round's OSD chunk budget (pooled_osd_chunk): the bytes the
# largest allocation of one chunk may take, 1/OSD_CHUNK_MEMORY_SHARE of the
# card's memory (~10 GB on an 80 GB H100), or OSD_CHUNK_CPU_BYTES on the CPU
OSD_CHUNK_MEMORY_SHARE = 8
OSD_CHUNK_CPU_BYTES = 1 << 30


def ensure_sampler_metadata(matrices: Dict, circ: SyndromeCircuit, Lx, Lz,
                            error_rate: float) -> Dict:
    """Reference-format matrix dicts lack the per-location sampler tables;
    rebuild them and cross-check the decoding matrices agree."""
    if all(k in matrices for k in _SAMPLER_KEYS):
        return matrices
    rebuilt = build_decoding_matrices(circ, Lx, Lz, error_rate)
    for key in ("HdecZ", "HdecX"):
        if key in matrices and not np.array_equal(
                np.asarray(matrices[key]) % 2, rebuilt[key] % 2):
            raise ValueError(
                f"precomputed {key} disagrees with this circuit's fault "
                "enumeration — wrong code/cycles/schedule for these "
                "matrices?")
    merged = dict(rebuilt)
    merged.update({k: v for k, v in matrices.items() if k not in merged})
    return merged


@dataclasses.dataclass(frozen=True)
class BasisDecoder:
    """Static per-basis decode bundle (tensors on one device)."""

    maps: TrialMaps
    graph: TannerGraph    # padded-CSR BP layout (ops/bp.py)
    lifted: Optional[LiftedGraph]  # circulant-structured BP layout
                                   # (ops/bp_lift.py); None without a lift
    H: torch.Tensor            # (m, n) uint8 decoding matrix
    HT: torch.Tensor           # (n, m) float32 (R1's plain version)
    H_logical: torch.Tensor    # (n, k) float32 — logical action per column
    logical_pack: torch.Tensor  # (n,) int32 — the same action bit-packed
    prior: torch.Tensor        # (n,) float32
    alpha_seq: torch.Tensor    # (maxIter,) float32
    basis_cols: torch.Tensor   # (rank,) int64 — fixed rank-completing basis
    K: int
    num_test: int
    rank: int                  # GF(2) rank of H (OSD early-exit target)
    col_index: ColumnIndex     # H's columns as G1 and R1 read them


def _make_basis(circ, matrices, basis: str, alpha_seq, clip_channel=50.0,
                osd_margin: int = 128, osd_order: int = 0,
                device=None) -> BasisDecoder:
    """osd_margin: reliability-ordered column budget beyond the row count
    for the OSD elimination (K = m + margin, rounded); rank deficiency is
    reported per shot (``rank_deficient``), never silent."""
    dev = resolve_device(device)
    b = basis.upper()
    H = (np.asarray(matrices[f"Hdec{b}"]) != 0).astype(np.uint8)
    full = np.asarray(matrices[f"H{b}_full"])
    k = matrices["k"]
    first = matrices[f"first_logical_row{b}"]
    H_logical = (full[first:first + k] != 0).astype(np.float32)  # (k, n)
    prior_np = channel_llrs(matrices[f"channel_probs{b}"], clip_channel)
    # circulant-lift BP layout (needs the BB polynomial dims; raw CSS codes
    # without them decode on the padded-CSR graph)
    ell = getattr(circ.code, "ell", None)
    mmm = getattr(circ.code, "m", None)
    lifted = (LiftedGraph.try_from_dense(H, ell, mmm, prior_np, device=dev)
              if ell and mmm else None)
    return BasisDecoder(
        maps=make_trial_maps(circ, matrices, b, device=dev),
        graph=TannerGraph.from_dense(H, device=dev),
        lifted=lifted,
        H=torch.as_tensor(H, device=dev),
        HT=torch.as_tensor(np.ascontiguousarray(H.T, np.float32),
                           device=dev),
        H_logical=torch.as_tensor(np.ascontiguousarray(H_logical.T),
                                  device=dev),
        logical_pack=torch.as_tensor(
            (H_logical.astype(np.int64)
             << np.arange(k, dtype=np.int64)[:, None]).sum(0)
            .astype(np.int32), device=dev),
        prior=torch.as_tensor(prior_np, dtype=torch.float32, device=dev),
        alpha_seq=torch.as_tensor(np.asarray(alpha_seq, np.float32),
                                  device=dev),
        basis_cols=torch.as_tensor(gf2.column_basis(H).astype(np.int64),
                                   device=dev),
        K=choose_K(*H.shape, margin=osd_margin),
        num_test=(osd_order + 10) if osd_order > 0 else 0,
        rank=gf2.rank_fast(H),
        col_index=column_index(H, dev),
    )


def _bp_one_basis(syndrome, dec: BasisDecoder, maxIter: int,
                  damping: float = 1.0, clip_llr: float = 20.0,
                  msg_dtype=torch.float32, bp_variant: str = "minsum"):
    """BP only, dispatched as the JAX package does. Returns the BP dict
    (values (B, n) f32, hard (B, n) int8, converged (B,) bool, iterations
    (B,) int32).

    - ``bp_variant="tanh"``: tanh true BP on the padded-CSR graph (alpha,
      damping and clip_llr do not apply, as in the reference);
    - a lifted graph with damping 1: kernel K1 (flooding) or, for
      ``"layered"``, kernel K3 (``maxIter`` counts sweeps) on CUDA tensors;
    - a lifted graph with damping != 1: the roll decoder;
    - otherwise: min-sum on the padded-CSR graph.

    ``msg_dtype`` is the message dtype of the last two (the kernels keep
    float32)."""
    if bp_variant == "tanh":
        return decode_batch_tanh(dec.graph, syndrome, dec.prior, maxIter)
    if dec.lifted is not None and damping == 1.0:
        decode = (decode_batch_lift_layered_cuda if bp_variant == "layered"
                  else decode_batch_lift_cuda)
        return decode(dec.lifted, syndrome, dec.prior, dec.alpha_seq,
                      maxIter, clip_llr=clip_llr)
    if dec.lifted is not None:
        return decode_batch_lift(dec.lifted, syndrome, dec.prior,
                                 dec.alpha_seq, maxIter, damping=damping,
                                 clip_llr=clip_llr, msg_dtype=msg_dtype)
    return decode_batch(dec.graph, syndrome, dec.prior, dec.alpha_seq,
                        maxIter, damping=damping, clip_llr=clip_llr,
                        msg_dtype=msg_dtype)


def _iterations_run(iterations) -> int:
    """BP's ``iterations`` (each shot's converging iteration, from 0, or
    maxIter - 1) as the iterations the shots ran."""
    return int(iterations.sum()) + iterations.numel()


def _bp_traced(syndrome, dec: BasisDecoder, maxIter: int, bp_args: tuple,
               basis: Optional[str] = None):
    """:func:`_bp_one_basis` inside the ``bp`` span, with the iterations
    its shots ran and its shots counted (utils/telemetry.py: the
    iterations tensor is held, not read)."""
    with telemetry.span("bp", basis=basis):
        bp = _bp_one_basis(syndrome, dec, maxIter, *bp_args)
        telemetry.count("bp.shot_iterations", bp["iterations"],
                        _iterations_run)
        telemetry.count("bp.shots", syndrome.shape[0])
    return bp


def _osd_fallback(syndrome, values, hard, conv, dec: BasisDecoder,
                  osd_order: int, chunk: int, replay: bool = False):
    """OSD for the BP-failed shots of a (possibly pooled) batch.

    Returns (delta (B,) int32 packed logical delta of the OSD correction
    relative to the BP hard decision, rank_deficient (B,) bool, overflow
    (B,) bool: OSD-0 failed and the chunk's reprocess slice did not hold
    the shot), each 0 on the converged shots, whose ``osd_batch`` outputs
    are unspecified (they are gated off).

    Shots are sorted unconverged-first and by BP-residual weight
    (syndrome ^ H@hard) within the unconverged, so shots of similar
    difficulty share an elimination launch. The residual is computed once
    for the batch (kernel R1 on the card, ``osd_cuda.bp_residual``) and each
    chunk's rows are handed to ``osd_batch``. Every chunk of ``chunk`` shots
    is issued, as the JAX package's unrolled ``lax.cond`` chunks are, with
    its count of unconverged shots, ``clamp(n_fail - c0, 0, chunk)``, on
    the device: a chunk of converged shots launches G1 and the eliminator
    gated to nothing. No host read. The reprocess slice is
    ``osd.REPROCESS_SLICE`` shots, or the whole chunk when ``replay``.
    Per-shot OSD outputs do not depend on how shots are grouped, so the
    flags equal the JAX package's.

    Telemetry (utils/telemetry.py): spans ``osd.order`` (with R1's
    ``osd.hard_ones``: the set columns of ``hard`` it scanned),
    ``osd.chunk`` (one a chunk, with its first shot ``c0`` and its live
    count ``osd.live``) and ``osd.merge``; the unconverged count
    ``osd.failed`` and ``osd.chunks_issued`` go to the span the caller
    opened (``osd``)."""
    B, m = syndrome.shape
    dev = syndrome.device
    with telemetry.span("osd.order"):
        residual, res_wt = bp_residual(syndrome, hard, dec.HT, dec.col_index)
        order = torch.sort(torch.where(conv, m + 1, res_wt),
                           stable=True).indices
        n_fail = (~conv).sum()
    telemetry.count("osd.failed", n_fail)
    delta = torch.zeros(B, dtype=torch.int32, device=dev)
    rdef = torch.zeros(B, dtype=torch.bool, device=dev)
    overflow = torch.zeros(B, dtype=torch.bool, device=dev)
    starts = range(0, B, chunk)
    telemetry.count("osd.chunks_issued", len(starts))
    for c0 in starts:
        with telemetry.span("osd.chunk", c0=c0):
            idx = order[c0:c0 + chunk]
            n_live = (n_fail - c0).clamp(0, len(idx))
            telemetry.count("osd.live", n_live)
            out = osd_batch(dec.H, dec.HT, None, values[idx],
                            hard[idx], K=dec.K, order=osd_order,
                            num_test=dec.num_test, rank=dec.rank,
                            basis_cols=dec.basis_cols,
                            logical_pack=dec.logical_pack,
                            return_solution=False, n_live=n_live,
                            reprocess_slice=None if replay
                            else osd.REPROCESS_SLICE,
                            col_index=dec.col_index, residual=residual[idx])
        with telemetry.span("osd.merge"):
            delta.index_copy_(0, idx, out["logical_delta_packed"])
            rdef.index_copy_(0, idx, out["rank_deficient"])
            overflow.index_copy_(0, idx, out["reprocess_overflow"])
    return torch.where(conv, 0, delta), rdef & ~conv, overflow & ~conv


def _logical_readout(hard, conv, delta, dec: BasisDecoder):
    """Decoded logical action (B, k) int32 from the BP hard decision and
    the packed OSD logical delta (osd_sol@L = hard@L ^ delta over GF(2))."""
    bp_log = (hard.to(torch.float32) @ dec.H_logical).to(torch.int32) & 1
    k = bp_log.shape[1]
    shifts = torch.arange(k, device=delta.device, dtype=torch.int32)
    delta_bits = (delta[:, None] >> shifts) & 1
    return bp_log ^ torch.where(conv[:, None], 0, delta_bits)


def _decode_logicals(syndrome, dec: BasisDecoder, maxIter: int,
                     osd_order: int, damping: float = 1.0,
                     clip_llr: float = 20.0, msg_dtype=torch.float32,
                     bp_variant: str = "minsum", replay: bool = False,
                     return_overflow: bool = False):
    """BP, OSD fallback for the unconverged shots, logical readout, for
    externally supplied syndromes (B, m). The OSD chunk is the JAX
    package's: the whole batch up to 64 shots, else max(64, B // 8).

    Returns (dec_log (B, k) int32, the decoded correction's logical action;
    converged (B,) bool; rank_deficient (B,) bool), and the OSD overflow
    flags (B,) bool when ``return_overflow`` (a caller that sees one
    decodes the batch again with ``replay``; see :func:`_osd_fallback`)."""
    B = syndrome.shape[0]
    bp = _bp_traced(syndrome, dec, maxIter,
                    (damping, clip_llr, msg_dtype, bp_variant))
    conv = bp["converged"]
    chunk = B if B <= 64 else max(64, B // 8)
    with telemetry.span("osd", chunk=chunk):
        delta, rdef, overflow = _osd_fallback(syndrome, bp["values"],
                                              bp["hard"], conv, dec,
                                              osd_order, chunk, replay)
    out = (_logical_readout(bp["hard"], conv, delta, dec), conv, rdef)
    return out + (overflow,) if return_overflow else out


def _decode_one_basis(syndrome, true_log, dec: BasisDecoder, maxIter: int,
                      osd_order: int, damping: float = 1.0,
                      clip_llr: float = 20.0, msg_dtype=torch.float32,
                      bp_variant: str = "minsum",
                      return_overflow: bool = False):
    """:func:`_decode_logicals` scored against the true logical effect:
    (err (B,) bool, converged, rank_deficient). A batch whose OSD reprocess
    slice overflowed is decoded again with whole chunks (one host read), so
    no answer comes from a truncated reprocess; ``return_overflow`` adds
    the first pass's overflow flags (the shots that made it replay)."""
    args = (syndrome, dec, maxIter, osd_order, damping, clip_llr, msg_dtype,
            bp_variant)
    dec_log, conv, rdef, overflow = _decode_logicals(*args,
                                                     return_overflow=True)
    if bool(overflow.any()):
        dec_log, conv, rdef = _decode_logicals(*args, replay=True)
    out = ((dec_log != true_log.to(torch.int32)).any(1), conv, rdef)
    return out + (overflow,) if return_overflow else out


def _sample_bp_phase(gen, dec_z, dec_x, n_locs, error_rate, batch, maxIter,
                     bp_args: tuple, randoms=None):
    """One round's sampling + both-basis BP; ``bp_args`` = (damping,
    clip_llr, msg_dtype, bp_variant) of :func:`_bp_one_basis`. ``randoms`` =
    (err, pauli, cat2) replaces the draw from ``gen`` (tests feed both
    packages the same draws). Returns the [z, x] per-basis state dicts."""
    with telemetry.span("sampling"):
        trials = trial_batch(gen, error_rate, dec_z.maps, dec_x.maps, n_locs,
                             batch, randoms)
    per_basis = []
    for name, dec in (("z", dec_z), ("x", dec_x)):
        syndrome = trials[f"syndrome_{name}"]
        bp = _bp_traced(syndrome, dec, maxIter, bp_args, name)
        per_basis.append(dict(
            syn=syndrome, true_log=trials[f"true_{name}"],
            values=bp["values"], hard=bp["hard"], conv=bp["converged"]))
    return per_basis


def osd_chunk_budget(device) -> int:
    """The bytes the largest allocation of one pooled OSD chunk may take
    on ``device``: 1/``OSD_CHUNK_MEMORY_SHARE`` of a card's memory, or
    ``OSD_CHUNK_CPU_BYTES`` on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return (torch.cuda.get_device_properties(dev).total_memory
                // OSD_CHUNK_MEMORY_SHARE)
    return OSD_CHUNK_CPU_BYTES


def osd_shot_bytes(dec: BasisDecoder, osd_order: int, device) -> int:
    """The bytes one shot adds to the largest allocation of an OSD chunk
    of ``dec`` (ops/osd.py::osd_batch): the larger of the basis rerun's G1
    output (KTp columns of ``column_stride`` words) and a replayed chunk's
    reprocess, whose slice is the whole chunk (its float32 parity table of
    m rows by the flip sets of up to ``osd_order`` test columns, and its
    full-width reduced matrix of KTp / 32 words by m rows)."""
    m, n = dec.H.shape
    KT = dec.K
    if dec.basis_cols is not None and dec.K < n:
        KT += dec.basis_cols.shape[0]
    W = -(-KT // 32)
    g1 = 32 * W * column_stride(W, m, device) * 4
    flips = sum(math.comb(dec.num_test, w) for w in range(1, osd_order + 1))
    reprocess = 4 * m * (flips + W) if flips else 0
    return max(g1, reprocess)


def pooled_osd_chunk(pool: int, decs, osd_order: int, device=None) -> int:
    """The pooled round's OSD chunk over a pool of ``pool`` shots decoded
    by the bases' decoders ``decs``: the whole pool where the largest
    allocation of one chunk (:func:`osd_shot_bytes` of the widest basis,
    times the chunk) fits :func:`osd_chunk_budget`, else the fewest equal
    chunks of a multiple of 32 shots that fit. A pool of at most 64 shots
    stays whole. ``device``: None, the decoders'."""
    if pool <= 64:
        return pool
    dev = decs[0].H.device if device is None else torch.device(device)
    shot = max(osd_shot_bytes(d, osd_order, dev) for d in decs)
    fit = max(32, osd_chunk_budget(dev) // shot // 32 * 32)
    if pool <= fit:
        return pool
    return -(-pool // (32 * -(-pool // fit))) * 32


def _pooled_osd_phase(flat, dec_z, dec_x, osd_order, chunk: int,
                      replay: bool = False):
    """Pooled OSD + readout over the flattened multi-round BP state, in
    OSD chunks of ``chunk`` shots (the pooled round's default is
    :func:`pooled_osd_chunk`'s: the whole pool wherever it fits the
    budget). The flags gain ``osd_overflow``: shots whose OSD-0 failed in
    either basis beyond their chunk's reprocess slice (the round must be
    replayed)."""
    out = {}
    overflow = []
    for name, dec, st in (("z", dec_z, flat[0]), ("x", dec_x, flat[1])):
        with telemetry.span("osd", basis=name, chunk=chunk):
            delta, rdef, ovf = _osd_fallback(st["syn"], st["values"],
                                             st["hard"], st["conv"], dec,
                                             osd_order, chunk, replay)
        with telemetry.span("readout"):
            dec_log = _logical_readout(st["hard"], st["conv"], delta, dec)
            out[f"{name}_err"] = (dec_log != st["true_log"].to(torch.int32)
                                  ).any(1)
            out[f"{name}_conv"] = st["conv"]
            out[f"{name}_rankdef"] = rdef
            overflow.append(ovf)
    out["any_err"] = out["z_err"] | out["x_err"]
    out["osd_overflow"] = overflow[0] | overflow[1]
    return out


def _round_defaults(dec_z: BasisDecoder, damping: float, msg_dtype,
                    bp_variant: str):
    """Resolve the device-dependent round defaults shared by make_round_fn
    and make_pooled_round_fn: the layered schedule needs a lifted graph and
    damping 1 (otherwise flooding, with a warning, as in the JAX package);
    messages of the roll and padded-CSR decoders default to bfloat16 on the
    card and float32 on the CPU."""
    if bp_variant == "layered" and (dec_z.lifted is None or damping != 1.0):
        logger.warning(
            "bp_variant='layered' needs a lifted decoding graph and "
            "damping == 1; falling back to the flooding schedule")
        bp_variant = "minsum"
    if msg_dtype is None:
        msg_dtype = (torch.bfloat16 if dec_z.prior.device.type == "cuda"
                     else torch.float32)
    return msg_dtype, bp_variant


def make_pooled_round_fn(dec_z: BasisDecoder, dec_x: BasisDecoder,
                         n_locs: int, error_rate: float, batch: int,
                         maxIter: int, osd_order: int, n_rounds: int,
                         damping: float = 1.0, clip_llr: float = 20.0,
                         bp_variant: str = "minsum", osd_chunk: int = None,
                         msg_dtype=None):
    """``n_rounds`` decode rounds with CROSS-ROUND OSD compaction:
    sampling + BP per round, then ONE pooled OSD phase over all
    ``n_rounds * batch`` shots. Returns ``pooled(gen, randoms=None,
    replay=False)`` -> flattened (n_rounds * batch,) per-shot flags, issued
    without a host read; ``randoms`` is a list of per-round (err, pauli,
    cat2) replacing the draws from ``gen``; ``replay`` gives each OSD chunk
    its whole size as the reprocess slice. The OSD chunk is ``osd_chunk``
    shots, or by default :func:`pooled_osd_chunk`'s, computed here once:
    the whole pool, one chunk a basis, wherever its largest allocation
    fits the budget."""
    msg_dtype, bp_variant = _round_defaults(dec_z, damping, msg_dtype,
                                            bp_variant)
    bp_args = (damping, clip_llr, msg_dtype, bp_variant)
    if osd_chunk is None:
        osd_chunk = pooled_osd_chunk(n_rounds * batch, (dec_z, dec_x),
                                     osd_order)

    def pooled(gen, randoms=None, replay: bool = False):
        with telemetry.span("round", rounds=n_rounds, batch=batch,
                            replay=replay):
            stacked = [_sample_bp_phase(
                gen, dec_z, dec_x, n_locs, error_rate, batch, maxIter,
                bp_args, None if randoms is None else randoms[i])
                for i in range(n_rounds)]
            with telemetry.span("pool"):
                flat = [{k: torch.cat([r[b][k] for r in stacked])
                         for k in stacked[0][b]} for b in (0, 1)]
            return _pooled_osd_phase(flat, dec_z, dec_x, osd_order,
                                     chunk=osd_chunk, replay=replay)

    return pooled


def make_round_fn(dec_z: BasisDecoder, dec_x: BasisDecoder, n_locs: int,
                  error_rate: float, batch: int, maxIter: int,
                  osd_order: int, damping: float = 1.0,
                  clip_llr: float = 20.0, bp_variant: str = "minsum",
                  msg_dtype=None):
    """One decode round: ``round_fn(gen, randoms=None)`` -> per-shot flags
    (the one-round pool of :func:`make_pooled_round_fn`)."""
    pooled = make_pooled_round_fn(dec_z, dec_x, n_locs, error_rate, batch,
                                  maxIter, osd_order, 1, damping, clip_llr,
                                  bp_variant, msg_dtype=msg_dtype)
    return lambda gen, randoms=None, replay=False: pooled(
        gen, None if randoms is None else [randoms], replay)


def make_scanned_round_fn(round_fn, n_rounds: int):
    """``n_rounds`` unpooled rounds a dispatch (the JAX package's
    ``lax.scan`` of rounds): ``scanned(gen, randoms=None)`` calls
    ``round_fn`` once per round, each with its own OSD phase, and
    concatenates the per-shot flags into one (n_rounds * batch,) round;
    ``randoms`` is a list of per-round draws."""
    def scanned(gen, randoms=None, replay=False):
        outs = [round_fn(gen, None if randoms is None else randoms[r],
                         replay=replay)
                for r in range(n_rounds)]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    return scanned


def tot_errs_target(target: int, already: int) -> int:
    """Remaining errors needed within the current round."""
    return max(0, target - already)


def _calib_trials(requested: Optional[int], n: int, p: float) -> int:
    """The reference's trial-count rule (engine.py:236-244): None selects
    max(500, min(50000, 2000/(n*p))); an explicit integer is honoured."""
    if requested is not None:
        return requested
    return max(500, min(50000, int(2000 / (n * p))))


def _fmt(rate: float) -> str:
    return f"{rate:.6g}".replace(".", "p")


def _plot_path(plot_dir: Optional[str], rate: float, kind: str,
               basis: str) -> Optional[str]:
    if plot_dir is None:
        return None
    os.makedirs(plot_dir, exist_ok=True)
    return os.path.join(plot_dir, f"{kind}_{_fmt(rate)}_{basis}_fit.png")


def _calibrate_basis_sequences(matrices, error_rate, alpha_mode,
                               alvarado_alpha, maxIter,
                               alpha_estimation_trials=None,
                               alpha_estimation_bins=50, base_seed=0,
                               estimation_plot_dir=None, plot_tag="",
                               device=None):
    """Per-basis min-sum alpha sequences for one code (the calibration
    dispatch of the reference engine, engine.py:228-344), fitted on
    ``device``. ``alvarado_alpha`` under ``alpha_mode="alvarado"``: None
    (fit each basis), a (z, x) pair, or one scalar for both. Returns
    (seq_z, seq_x, result_extra); result_extra holds the fit values and
    ``alpha_z`` / ``alpha_x``.

    Under a process group the fitted sequences are broadcast from rank 0 as
    float32, as the JAX package does from process 0: every rank must decode
    with the same sequences, and each rank's fit is not trusted to agree
    bit for bit. ``alpha_seq_*`` records the sequences after the
    broadcast."""
    llrs_z = channel_llrs(matrices["channel_probsZ"])
    llrs_x = channel_llrs(matrices["channel_probsX"])
    result_extra: Dict[str, Any] = {}
    tag = f"{plot_tag}_" if plot_tag else ""
    alpha_z = alpha_x = 1.0

    def trials(b):
        return _calib_trials(alpha_estimation_trials,
                             matrices[f"Hdec{b}"].shape[1], error_rate)

    if alpha_mode == "alvarado":
        if alvarado_alpha is None:
            alpha_z, r2z = calibrate.estimate_alpha_alvarado(
                matrices["HdecZ"], error_rate, trials=trials("Z"),
                bins=alpha_estimation_bins, llrs=llrs_z, seed=base_seed + 1,
                plot_path=_plot_path(estimation_plot_dir, error_rate,
                                     tag + "alvarado", "z"), device=device)
            alpha_x, r2x = calibrate.estimate_alpha_alvarado(
                matrices["HdecX"], error_rate, trials=trials("X"),
                bins=alpha_estimation_bins, llrs=llrs_x, seed=base_seed + 2,
                plot_path=_plot_path(estimation_plot_dir, error_rate,
                                     tag + "alvarado", "x"), device=device)
            result_extra.update(alpha_r2_z=r2z, alpha_r2_x=r2x)
        elif isinstance(alvarado_alpha, (list, tuple, np.ndarray)) and \
                len(alvarado_alpha) == 2:
            alpha_z, alpha_x = (float(alvarado_alpha[0]),
                                float(alvarado_alpha[1]))
            result_extra.update(alpha_r2_z=None, alpha_r2_x=None)
        else:
            alpha_z = alpha_x = float(alvarado_alpha)
            result_extra.update(alpha_r2_z=None, alpha_r2_x=None)
        seq_z = alpha_schedule("alvarado", maxIter, alpha_z)
        seq_x = alpha_schedule("alvarado", maxIter, alpha_x)
    elif alpha_mode == "alvarado-autoregressive":
        if alvarado_alpha is not None:
            raise ValueError(
                "alvarado_alpha must be None for alvarado-autoregressive")
        fits = {}
        for b, llrs, off in (("z", llrs_z, 1), ("x", llrs_x, 2)):
            fits[b] = calibrate.estimate_alpha_alvarado_autoregressive(
                matrices[f"Hdec{b.upper()}"], error_rate, maxIter,
                trials=trials(b.upper()), bins=alpha_estimation_bins,
                llrs=llrs, seed=base_seed + off,
                plot_dir=estimation_plot_dir,
                plot_prefix=f"{tag}autoregressive_{_fmt(error_rate)}_{b}",
                return_fallbacks=True, device=device)
        (av_z, r2v_z, fb_z), (av_x, r2v_x, fb_x) = fits["z"], fits["x"]
        result_extra.update(alpha_values_z=av_z, alpha_values_x=av_x,
                            alpha_r2_values_z=r2v_z, alpha_r2_values_x=r2v_x,
                            n_alpha_fallbacks_z=fb_z, n_alpha_fallbacks_x=fb_x,
                            n_alpha_fallbacks=fb_z + fb_x)
        seq_z = alpha_schedule("alvarado-autoregressive", maxIter, av_z)
        seq_x = alpha_schedule("alvarado-autoregressive", maxIter, av_x)
    elif alpha_mode == "dynamical":
        seq_z = seq_x = alpha_schedule("dynamical", maxIter)
    else:
        raise ValueError(f"Unsupported alpha_mode: {alpha_mode}")

    if alpha_mode != "dynamical":
        seq_z, seq_x = broadcast_from_rank0(
            np.stack([np.asarray(seq_z, np.float32),
                      np.asarray(seq_x, np.float32)]))
        # the per-iteration sequences the decoder consumes
        result_extra["alpha_seq_z"] = np.asarray(seq_z, np.float32).tolist()
        result_extra["alpha_seq_x"] = np.asarray(seq_x, np.float32).tolist()
    result_extra["alpha_z"] = alpha_z
    result_extra["alpha_x"] = alpha_x
    return seq_z, seq_x, result_extra


def _scopt_betas(matrices, error_rate, alpha_mode, alpha_z, alpha_x,
                 result_extra, maxIter, bins, base_seed, plot_dir, device):
    """SCOPT beta per basis (the scopt branch of the reference engine):
    estimated and reported, not consumed by the decoder, as in the
    reference (engine.py:389 TODO) and the JAX package."""
    out = {}
    for b, alpha, off in (("z", alpha_z, 3), ("x", alpha_x, 4)):
        H = matrices[f"Hdec{b.upper()}"]
        if alpha_mode == "alvarado-autoregressive":
            alpha = result_extra.get(f"alpha_values_{b}", alpha)
        out[f"beta_{b}"], out[f"beta_r2_{b}"] = calibrate.estimate_scopt_beta(
            H, error_rate, trials=_calib_trials(None, H.shape[1], error_rate),
            bins=bins, alpha=alpha, alpha_mode=alpha_mode, maxIter=maxIter,
            llrs=channel_llrs(matrices[f"channel_probs{b.upper()}"]),
            seed=base_seed + off,
            plot_path=_plot_path(plot_dir, error_rate, "scopt", b),
            device=device)
    return out


def _crossing_take(a: np.ndarray, remaining: int) -> int:
    """The reference's exact sequential stopping rule within one round:
    number of trials up to AND including the one where the
    ``remaining``-th logical error occurs."""
    return int(np.searchsorted(np.cumsum(a), remaining)) + 1


def _drive_stopping_rounds(dispatch, gather, n_streams: int,
                           round_shots: int, max_trials: int,
                           target_logical_errors, verbose: bool, names,
                           on_progress=None, pipeline_depth: int = 2,
                           generators=()):
    """The sequential-stopping round loop, shared by ``run_simulation`` (one
    stream) and ``run_multi_code_simulation`` (one stream per code).
    ``dispatch(round_idx, replay=False)`` -> list of per-stream flag dicts
    from :func:`~qldpc_tpu_torch.parallel.mesh.shard_rounds` (this
    process's per-shot flags and its ``<flag>_count`` device counts),
    issued without a host read. Up to ``pipeline_depth`` dispatches stay in
    flight, as in the JAX package; the loop consumes the oldest by reading
    every stream's counts at once (:func:`~qldpc_tpu_torch.parallel.mesh
    .read_counts`: one all_reduce, one host read). Trials are accounted in
    global shot order; each stream truncates at the exact trial where its
    ``target_logical_errors``-th error occurs, and the run ends when every
    stream is done (a finished code keeps being decoded and its share
    discarded until the slowest finishes; dispatches issued past the last
    consumed round are discarded). Steady rounds read only the counts; the
    per-shot flags go through ``gather`` (every shard's, in shard order)
    only in a crossing (or truncated final) round, which every rank reaches
    together.

    ``generators``: every generator the dispatches draw from. Their states
    are saved before each dispatch; a consumed round whose reduced
    ``osd_overflow`` count is non-zero (an OSD chunk's reprocess slice
    overflowed) is replayed from its saved states with ``replay=True`` and
    accounted instead, and the generators are put back where the later
    dispatches left them. So the tallies do not depend on
    ``pipeline_depth``.

    Returns dict with lists ``trials``, ``z_errs``, ``x_errs``,
    ``tot_errs``, ``rankdef``, ``steady_trials`` and scalars ``elapsed``,
    ``steady_elapsed``, ``replays``."""
    stop_on_errors = (target_logical_errors is not None
                      and target_logical_errors > 0)
    trials = [0] * n_streams
    z_errs, x_errs, tot = [0] * n_streams, [0] * n_streams, [0] * n_streams
    rankdef = [0] * n_streams
    done = [False] * n_streams
    t_start = time.time()
    t_steady = None
    steady = [0] * n_streams
    round_idx = 0
    replays = 0
    inflight: deque = deque()
    while not all(done):
        while len(inflight) < pipeline_depth:
            states = [g.get_state() for g in generators]
            with telemetry.dispatch(round_idx):
                inflight.append((round_idx, states, dispatch(round_idx)))
            round_idx += 1
        ri, states, outs = inflight.popleft()
        with telemetry.dispatch(ri), telemetry.span("consume"):
            counts = read_counts(outs)
        if any(c.get("osd_overflow_count", 0) for c in counts):
            now = [g.get_state() for g in generators]
            for g, st in zip(generators, states):
                g.set_state(st)
            with telemetry.dispatch(ri, replay=True), \
                    telemetry.span("replay"):
                telemetry.count("replays", 1)
                outs = dispatch(ri, replay=True)
                with telemetry.span("consume"):
                    counts = read_counts(outs)
            for g, st in zip(generators, now):
                g.set_state(st)
            replays += 1
            logger.info("round %d: an OSD reprocess slice overflowed; "
                        "replayed with whole chunks", ri + 1)
        for i, (o, c) in enumerate(zip(outs, counts)):
            if done[i]:
                continue
            take = min(round_shots, max_trials - trials[i])
            a_cnt, z_inc, x_inc, rz, rx = (c[f"{k}_count"]
                                           for k in _STOP_KEYS)
            rd = rz + rx
            crossing = (stop_on_errors
                        and tot[i] + a_cnt >= target_logical_errors)
            if crossing or take < round_shots:
                g = gather({k: o[k] for k in _STOP_KEYS})
                g = {k: v[:take] for k, v in g.items()}
                a = g["any_err"]
                if stop_on_errors and a.size and \
                        tot[i] + int(a.sum()) >= target_logical_errors:
                    take = _crossing_take(
                        a, max(0, target_logical_errors - tot[i]))
                    g = {k: v[:take] for k, v in g.items()}
                a_cnt = int(g["any_err"].sum())
                z_inc, x_inc = int(g["z_err"].sum()), int(g["x_err"].sum())
                rd = int(g["z_rankdef"].sum()) + int(g["x_rankdef"].sum())
            trials[i] += take
            z_errs[i] += z_inc
            x_errs[i] += x_inc
            tot[i] += a_cnt
            if rd:
                rankdef[i] += rd
                logger.warning(
                    "OSD rank deficiency on %d shot-bases this round — the "
                    "K=m+margin column truncation fell short of full rank; "
                    "re-run with a larger osd_margin for these settings", rd)
            if (stop_on_errors and tot[i] >= target_logical_errors) or \
                    trials[i] >= max_trials:
                done[i] = True
                if verbose and n_streams > 1 and not all(done):
                    logger.info(
                        "multi-code: %s reached its target after %d trials; "
                        "its share of each remaining launch is discarded "
                        "until the slowest code finishes",
                        names[i], trials[i])
            if on_progress is not None:
                on_progress(i, trials[i], tot[i])
        if t_steady is None:  # the first round carries the kernel builds
            t_steady = time.time()
            steady = list(trials)
        if verbose:
            logger.info("round %d: %s", ri + 1,
                        {nm: (trials[i], tot[i])
                         for i, nm in enumerate(names)})
    elapsed = time.time() - t_start
    steady_elapsed = (time.time() - t_steady) if t_steady else elapsed
    return dict(trials=trials, z_errs=z_errs, x_errs=x_errs, tot_errs=tot,
                rankdef=rankdef, steady_trials=steady, elapsed=elapsed,
                steady_elapsed=steady_elapsed, replays=replays)


def _pipeline_depth(depth: Optional[int], dev) -> int:
    """Dispatches the stopping loop keeps in flight: ``depth``, or by
    default 2 on a GPU (the JAX package's, so the host issues the next
    dispatch while the card runs this one) and 1 on the CPU, where a
    dispatch runs as it is issued and a second in flight would overlap
    nothing and be discarded at the end. The tallies do not depend on it."""
    if depth is None:
        return 2 if dev.type == "cuda" else 1
    if depth < 1:
        raise ValueError(f"pipeline_depth must be >= 1, got {depth}")
    return int(depth)


def _progress_bar(verbose: bool, stop_on_errors: bool, target, max_trials,
                  error_rate):
    """The JAX package's live ``tqdm`` bar of a run (errors toward the
    target, or trials toward ``max_trials``): (bar, on_progress), or None
    when not ``verbose`` or without tqdm."""
    if not verbose:
        return None
    try:
        from tqdm import tqdm
    except ImportError:
        return None
    bar = tqdm(total=target if stop_on_errors else max_trials,
               unit="err" if stop_on_errors else "trial",
               desc=f"p={error_rate:g}", leave=False)

    def on_progress(_i, trials_now, errs_now):
        bar.update((errs_now if stop_on_errors else trials_now) - bar.n)
        bar.set_postfix(trials=trials_now,
                        ler=f"{errs_now / max(1, trials_now):.3g}")

    return bar, on_progress


def _shared_seed(base_seed: Optional[int]) -> int:
    """The run's base seed, drawn when None and taken from rank 0 under a
    process group, so every rank samples the same streams."""
    if base_seed is None:
        base_seed = int(np.random.randint(0, 2**31))
    return int(broadcast_from_rank0(np.array([base_seed], np.int64))[0])


def make_multi_code_pooled_round_fn(specs, n_rounds: int):
    """Several codes' rounds in one dispatch: ``n_rounds`` rounds of every
    code, each code with cross-round OSD compaction over its own pool
    (codes have different shapes, so pools are per code, as in the JAX
    package).

    ``specs``: list of dicts with keys dec_z, dec_x, n_locs, error_rate,
    batch, maxIter, osd_order. Returns ``pooled(gens, randoms=None,
    replay=False)`` -> list of per-code flattened (n_rounds * batch,) flag
    dicts; ``gens`` has one generator per code, and ``randoms[i]``
    (code-major: a list per round of (err, pauli, cat2)) replaces code i's
    draws; ``replay`` as in :func:`make_pooled_round_fn`. Each code runs
    exactly :func:`make_pooled_round_fn` with the JAX multi-code defaults
    (flooding min-sum, damping 1), so its flags are those of its own
    single-code dispatch on the same draws."""
    fns = [make_pooled_round_fn(sp["dec_z"], sp["dec_x"], sp["n_locs"],
                                sp["error_rate"], sp["batch"], sp["maxIter"],
                                sp["osd_order"], n_rounds) for sp in specs]

    def pooled(gens, randoms=None, replay=False):
        return [fn(gen, None if randoms is None else randoms[i], replay)
                for i, (fn, gen) in enumerate(zip(fns, gens))]

    return pooled


def make_multi_code_round_fn(specs):
    """One round of every code: ``fn(gens, randoms=None)`` with
    ``randoms[i]`` one (err, pauli, cat2) per code (the one-round pool of
    :func:`make_multi_code_pooled_round_fn`)."""
    pooled = make_multi_code_pooled_round_fn(specs, 1)
    return lambda gens, randoms=None, replay=False: pooled(
        gens, None if randoms is None else [[r] for r in randoms], replay)


def _gens(base_seed: int, mesh: ShotMesh, dev, n_codes: Optional[int] = None):
    """This process's generators: one per shard, or (multi-code) a list of
    one per code per shard; shard s, code i seeded from (base_seed, s, i)."""
    if n_codes is None:
        return [generator(base_seed, s, device=dev) for s in mesh.shards]
    return [[generator(base_seed, s, i, device=dev) for i in range(n_codes)]
            for s in mesh.shards]


def run_multi_code_simulation(
    codes, error_rate, num_cycles=None, maxIter=50, osd_order=0,
    alpha_mode="dynamical", alvarado_alpha=None,
    target_logical_errors=None, max_trials=None,
    batch_size: Optional[int] = None,
    rounds_per_dispatch: Optional[int] = None,
    precomputed_matrices=None, base_seed=None, verbose: bool = True,
    mesh: Optional[ShotMesh] = None, alpha_estimation_trials=None,
    alpha_estimation_bins=50, estimation_plot_dir=None, device=None,
    pipeline_depth: Optional[int] = None,
) -> Dict[str, Dict[str, Any]]:
    """Several codes' Monte-Carlo LER estimates from one dispatch per round,
    with the JAX package's signature (plus ``device``: None = "cuda"; "cpu"
    runs the plain PyTorch versions) and result keys.

    Every dispatch decodes a batch (per shard) for every code; the run goes
    on until every code has reached ``target_logical_errors`` (or
    ``max_trials``), and each code's tally is cut at its own crossing
    trial. A code that finishes early keeps being decoded, its share
    discarded, until the slowest finishes (logged).

    Args:
      codes: list of code objects (e.g. ``get_code(name)``) or registry
        names.
      num_cycles: per-code cycles; None uses each code's distance.
      precomputed_matrices: optional list, aligned with ``codes``.
      alpha_mode: "dynamical", "alvarado" or "alvarado-autoregressive";
        calibration runs once per code with seed ``base_seed + 101*i``.
      mesh: a :class:`~qldpc_tpu_torch.parallel.mesh.ShotMesh`; None means
        ``shot_mesh()`` (one shard per rank of the process group, or one).
      pipeline_depth: dispatches in flight (:func:`_pipeline_depth`).

    Returns {code.name: result dict} with the run_simulation keys;
    ``shots_per_sec`` is that code's own steady rate, and
    ``combined_shots_per_sec`` the dispatch-level aggregate over codes."""
    from ..models.bb import get_code

    dev = resolve_device(device)
    base_seed = _shared_seed(base_seed)
    mesh = mesh if mesh is not None else shot_mesh()
    if max_trials is None:
        max_trials = 1_000_000 if target_logical_errors else 10_000
    stop_on_errors = (target_logical_errors is not None
                      and target_logical_errors > 0)
    on_gpu = dev.type == "cuda"
    if batch_size is None:
        batch_size = 512 if on_gpu else 64
    if rounds_per_dispatch is None:
        rounds_per_dispatch = 4 if on_gpu else 1

    resolved = [get_code(c) if isinstance(c, str) else c for c in codes]
    specs, names, extras = [], [], []
    for i, c in enumerate(resolved):
        cycles = num_cycles or c.distance or 12
        circ = SyndromeCircuit(c, num_cycles=cycles)
        M = (precomputed_matrices[i] if precomputed_matrices else
             build_decoding_matrices(circ, c.Lx, c.Lz, error_rate))
        M = ensure_sampler_metadata(M, circ, c.Lx, c.Lz, error_rate)
        name = getattr(c, "name", f"code{i}")
        seq_z, seq_x, extra = _calibrate_basis_sequences(
            M, error_rate, alpha_mode, alvarado_alpha, maxIter,
            alpha_estimation_trials, alpha_estimation_bins,
            base_seed + 101 * i, estimation_plot_dir,
            plot_tag=name.replace(" ", ""), device=dev)
        specs.append(dict(
            dec_z=_make_basis(circ, M, "Z", seq_z, osd_order=osd_order,
                              device=dev),
            dec_x=_make_basis(circ, M, "X", seq_x, osd_order=osd_order,
                              device=dev),
            n_locs=circ.num_error_locs, error_rate=error_rate,
            batch=batch_size, maxIter=maxIter, osd_order=osd_order))
        names.append(name)
        extras.append(extra)

    sharded = shard_rounds(
        make_multi_code_pooled_round_fn(specs, rounds_per_dispatch), mesh)
    gens = _gens(base_seed, mesh, dev, len(specs))
    round_shots = batch_size * mesh.n_shards * rounds_per_dispatch
    st = _drive_stopping_rounds(
        lambda ri, replay=False: sharded(gens, replay=replay), gather_flags,
        len(specs), round_shots, max_trials,
        target_logical_errors if stop_on_errors else None, verbose, names,
        pipeline_depth=_pipeline_depth(pipeline_depth, dev),
        generators=[g for per_shard in gens for g in per_shard])

    trials, steady = st["trials"], st["steady_trials"]
    elapsed, steady_elapsed = st["elapsed"], st["steady_elapsed"]
    steady_done = sum(trials) - sum(steady)
    combined_rate = (steady_done / steady_elapsed if steady_done
                     else sum(trials) / max(elapsed, 1e-9))
    results = {}
    for i, nm in enumerate(names):
        code_steady = trials[i] - steady[i]
        results[nm] = {
            "logical_error_rate": st["tot_errs"][i] / max(1, trials[i]),
            "z_logical_error_rate": st["z_errs"][i] / max(1, trials[i]),
            "x_logical_error_rate": st["x_errs"][i] / max(1, trials[i]),
            "num_trials": trials[i],
            "logical_errors": st["tot_errs"][i],
            "shots_per_sec": (code_steady / steady_elapsed if code_steady
                              else trials[i] / max(elapsed, 1e-9)),
            "combined_shots_per_sec": combined_rate,
            "elapsed_sec": elapsed,
            "num_devices": mesh.n_shards,
            "osd_rank_deficient_shots": st["rankdef"][i],
        }
        results[nm].update(extras[i])
    return results


def run_simulation(
    Hx, Hz, Lx, Lz, error_rate, num_trials=1000, num_cycles=12,
    maxIter=50, osd_order=0, use_dynamic_alpha=True,
    alpha_mode=None, alvarado_alpha=None,
    alpha_estimation_trials=None, alpha_estimation_bins=50,
    precomputed_matrices=None, num_workers=None, base_seed=None,
    use_jit=True,
    target_logical_errors=None, max_trials=None, scopt=False,
    estimation_plot_dir=None,
    batch_size: Optional[int] = None, mesh: Optional[ShotMesh] = None,
    damping: float = 1.0,
    rounds_per_dispatch: Optional[int] = None,
    verbose: bool = True, bp_variant: str = "minsum",
    osd_cross_round: Optional[bool] = None,
    osd_chunk: Optional[int] = None,
    device=None,
    pipeline_depth: Optional[int] = None,
    **bb_params,
) -> Dict[str, Any]:
    """Reference-compatible Monte-Carlo LER estimation with the JAX
    package's signature and result dict (``device``: None = "cuda"; pass
    "cpu" for the plain PyTorch versions). Calibration (``alpha_mode``
    "alvarado" / "alvarado-autoregressive", ``scopt``) runs on the same
    device. ``mesh``: a :class:`~qldpc_tpu_torch.parallel.mesh.ShotMesh`;
    None means ``shot_mesh()`` (one shard per rank of the process group,
    or a single shard); ``batch_size`` is per shard. ``pipeline_depth``:
    dispatches in flight (:func:`_pipeline_depth`). ``num_workers`` and
    ``use_jit`` are accepted for compatibility."""
    del num_workers, use_jit
    dev = resolve_device(device)
    if alpha_mode is None:
        alpha_mode = "dynamical" if use_dynamic_alpha else "alvarado"
    base_seed = _shared_seed(base_seed)
    mesh = mesh if mesh is not None else shot_mesh()
    n_shards = mesh.n_shards

    code = make_code(Hx, Hz, Lx, Lz, **bb_params)
    circ = SyndromeCircuit(code, num_cycles=num_cycles)
    matrices = precomputed_matrices or build_decoding_matrices(
        circ, code.Lx, code.Lz, error_rate)
    matrices = ensure_sampler_metadata(matrices, circ, code.Lx, code.Lz,
                                       error_rate)
    seq_z, seq_x, result_extra = _calibrate_basis_sequences(
        matrices, error_rate, alpha_mode, alvarado_alpha, maxIter,
        alpha_estimation_trials, alpha_estimation_bins, base_seed,
        estimation_plot_dir, device=dev)
    alpha_z = result_extra.pop("alpha_z")
    alpha_x = result_extra.pop("alpha_x")
    if scopt:
        result_extra.update(_scopt_betas(
            matrices, error_rate, alpha_mode, alpha_z, alpha_x, result_extra,
            maxIter, alpha_estimation_bins, base_seed, estimation_plot_dir,
            dev))
    dec_z = _make_basis(circ, matrices, "Z", seq_z, osd_order=osd_order,
                        device=dev)
    dec_x = _make_basis(circ, matrices, "X", seq_x, osd_order=osd_order,
                        device=dev)

    if max_trials is None:
        max_trials = num_trials if num_trials is not None else 1_000_000
    stop_on_errors = (target_logical_errors is not None
                      and target_logical_errors > 0)
    on_gpu = dev.type == "cuda"
    if batch_size is None:
        # larger batches amortize the per-round fixed cost on the GPU; the
        # CPU keeps smaller rounds for stopping granularity
        batch_size = min(1024 if on_gpu else 512,
                         max(128, -(-max_trials // n_shards)))
    if rounds_per_dispatch is None:
        rounds_per_dispatch = 4 if on_gpu else 1
        # don't overshoot small trial budgets with a huge pooled dispatch
        while (rounds_per_dispatch > 1 and batch_size * n_shards
               * rounds_per_dispatch > max_trials * 2):
            rounds_per_dispatch //= 2
    if osd_cross_round is None:
        osd_cross_round = rounds_per_dispatch > 1
    n_locs = circ.num_error_locs
    if osd_cross_round and rounds_per_dispatch > 1:
        round_fn = make_pooled_round_fn(
            dec_z, dec_x, n_locs, error_rate, batch_size, maxIter, osd_order,
            rounds_per_dispatch, damping, bp_variant=bp_variant,
            osd_chunk=osd_chunk)
    else:
        round_fn = make_scanned_round_fn(
            make_round_fn(dec_z, dec_x, n_locs, error_rate, batch_size,
                          maxIter, osd_order, damping, bp_variant=bp_variant),
            rounds_per_dispatch)
    sharded = shard_rounds(round_fn, mesh)
    gens = _gens(base_seed, mesh, dev)
    round_shots = batch_size * n_shards * rounds_per_dispatch

    progress = _progress_bar(verbose, stop_on_errors, target_logical_errors,
                             max_trials, error_rate)
    st = _drive_stopping_rounds(
        lambda ri, replay=False: [sharded(gens, replay=replay)],
        gather_flags, 1, round_shots, max_trials,
        target_logical_errors if stop_on_errors else None, verbose,
        [f"p={error_rate:g}"],
        on_progress=None if progress is None else progress[1],
        pipeline_depth=_pipeline_depth(pipeline_depth, dev), generators=gens)
    if progress is not None:
        progress[0].close()
    trials_run, tot_errs = st["trials"][0], st["tot_errs"][0]
    elapsed, steady_elapsed = st["elapsed"], st["steady_elapsed"]
    # steady-state throughput excludes the first round (kernel builds)
    steady_done = trials_run - st["steady_trials"][0]
    result = {
        "logical_error_rate": tot_errs / max(1, trials_run),
        "z_logical_error_rate": st["z_errs"][0] / max(1, trials_run),
        "x_logical_error_rate": st["x_errs"][0] / max(1, trials_run),
        "num_trials": trials_run,
        "logical_errors": tot_errs,
        "shots_per_sec": (steady_done / steady_elapsed if steady_done
                          else trials_run / max(elapsed, 1e-9)),
        "elapsed_sec": elapsed,
        "num_devices": n_shards,
        "osd_rank_deficient_shots": st["rankdef"][0],
    }
    result.update(result_extra)
    return result
