"""Code-capacity Monte-Carlo decoding: iid errors on a raw parity-check
matrix, no syndrome-extraction circuit.

Counterpart of the JAX package's ``parallel/code_capacity.py``: the
simplest benchmark tier (the Steane [[7,1,3]] code, or any CSS code's check
matrix, under iid bit flips), decoded by padded-CSR min-sum BP
(``ops/bp.py``, PyTorch ops, float32 messages) and OSD on the shots BP did
not converge (``ops/osd.py``: kernels G1 and K2 on the card, or K4 / K5
under ``QLDPC_OSD_KERNEL``). Rounds run over the shot mesh
(``parallel/mesh.py``): each shard draws its errors from its own
generator, full rounds read the group's ``fail`` / ``conv`` counts
(``mesh.read_counts``), and a truncated final round gathers the
per-shot flags and takes their prefix.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models import gf2
from ..ops.bp import TannerGraph, alpha_schedule, decode_batch
from ..ops.osd import choose_K, osd_batch
from ..ops.osd_cuda import ColumnIndex, column_index
from .mesh import (ShotMesh, gather_flags, generator, read_counts,
                   shard_rounds, shot_mesh)


@dataclasses.dataclass(frozen=True)
class CapacityDecoder:
    """What a code-capacity round needs, on one device."""

    graph: TannerGraph
    H: torch.Tensor            # (m, n) uint8
    HT: torch.Tensor           # (n, m) float32
    L_T: Optional[torch.Tensor]  # (n, k) float32, or None: block errors
    prior: torch.Tensor        # (n,) float32
    alpha_seq: torch.Tensor    # (maxIter,) float32
    basis_cols: torch.Tensor   # (rank,) int64
    maxIter: int
    osd_order: int
    K: int
    rank: int
    col_index: ColumnIndex     # H's columns as the gather-pack G1 reads them


def capacity_decoder(H, error_rate: float, L=None, maxIter: int = 50,
                     osd_order: int = 0, alpha_mode: str = "dynamical",
                     alpha=1.0, device=None) -> CapacityDecoder:
    """The decode bundle of a (m, n) check matrix at flip probability
    ``error_rate``; ``L`` (k, n) scores logical errors, None block
    errors."""
    dev = resolve_device(device)
    H = (np.asarray(H) % 2).astype(np.uint8)
    m, n = H.shape
    L_T = None if L is None else torch.as_tensor(
        np.ascontiguousarray((np.asarray(L) % 2).T, np.float32), device=dev)
    return CapacityDecoder(
        graph=TannerGraph.from_dense(H, device=dev),
        H=torch.as_tensor(H, device=dev),
        HT=torch.as_tensor(np.ascontiguousarray(H.T, np.float32), device=dev),
        L_T=L_T,
        prior=torch.full((n,), float(np.log((1 - error_rate) / error_rate)),
                         dtype=torch.float32, device=dev),
        alpha_seq=torch.as_tensor(
            np.asarray(alpha_schedule(alpha_mode, maxIter, alpha),
                       np.float32), device=dev),
        basis_cols=torch.as_tensor(gf2.column_basis(H).astype(np.int64),
                                   device=dev),
        maxIter=maxIter, osd_order=osd_order, K=choose_K(m, n),
        rank=gf2.rank_fast(H), col_index=column_index(H, dev))


def _code_capacity_round(e, cc: CapacityDecoder) -> Dict[str, torch.Tensor]:
    """Decode one round of error draws ``e`` (B, n) bool: the syndrome as an
    exact float32 matmul & 1, min-sum BP, OSD for every shot (its solution
    is used where BP did not converge), and the residual scored against
    ``L`` (or any residual, without ``L``). Returns per-shot ``fail`` and
    ``conv`` flags (B,) bool."""
    syn = ((e.to(torch.float32) @ cc.HT).to(torch.int32) & 1).to(torch.int8)
    bp = decode_batch(cc.graph, syn, cc.prior, cc.alpha_seq, cc.maxIter)
    osd = osd_batch(cc.H, cc.HT, syn, bp["values"], bp["hard"], K=cc.K,
                    order=cc.osd_order,
                    num_test=(cc.osd_order + 10) if cc.osd_order else 0,
                    rank=cc.rank, basis_cols=cc.basis_cols,
                    col_index=cc.col_index)
    conv = bp["converged"]
    sol = torch.where(conv[:, None], bp["hard"], osd["solution"])
    resid = sol.to(torch.int32) ^ e.to(torch.int32)
    if cc.L_T is None:
        fail = (resid != 0).any(1)
    else:
        act = (resid.to(torch.float32) @ cc.L_T).to(torch.int32) & 1
        fail = (act != 0).any(1)
    return dict(fail=fail, conv=conv)


def run_code_capacity(
    H,
    error_rate: float,
    num_shots: int = 10000,
    L: Optional[np.ndarray] = None,
    maxIter: int = 50,
    osd_order: int = 0,
    alpha_mode: str = "dynamical",
    alpha=1.0,
    batch_size: int = 1024,
    base_seed: int = 0,
    mesh: Optional[ShotMesh] = None,
    device=None,
) -> Dict:
    """Estimate the block or logical error rate of a code under iid errors,
    with the JAX package's signature (``device`` in place of
    ``use_pallas``: None = ``cuda``, "cpu" runs the plain versions).

    Args:
      H: (m, n) parity-check matrix (0/1).
      error_rate: iid flip probability per bit.
      L: optional (k, n) logical-operator matrix. With L, a failure is a
        residual error with a nontrivial logical action; without, any
        miscorrection counts (block error rate).
      batch_size: shots a shard decodes per round.
      mesh: a :class:`~qldpc_tpu_torch.parallel.mesh.ShotMesh`; None means
        ``shot_mesh()``. Shard ``s`` draws from ``generator(base_seed, s)``.

    Returns dict with logical_error_rate, converged_rate, num_shots,
    shots_per_sec."""
    dev = resolve_device(device)
    cc = capacity_decoder(H, error_rate, L, maxIter, osd_order, alpha_mode,
                          alpha, dev)
    n = cc.H.shape[1]
    mesh = mesh if mesh is not None else shot_mesh()
    gens = [generator(base_seed, s, device=dev) for s in mesh.shards]

    def round_fn(gen, randoms=None):
        e = randoms if randoms is not None else (
            torch.rand((batch_size, n), generator=gen, device=dev)
            < error_rate)
        return _code_capacity_round(e, cc)

    sharded = shard_rounds(round_fn, mesh)
    round_shots = batch_size * mesh.n_shards
    fails = conv = shots = 0
    t0 = time.time()
    while shots < num_shots:
        out = sharded(gens)
        take = min(round_shots, num_shots - shots)
        if take < round_shots:
            # truncated final round: the per-shot prefix, gathered on every
            # rank; full rounds use the group's counts
            g = gather_flags({k: out[k] for k in ("fail", "conv")})
            fails += int(g["fail"][:take].sum())
            conv += int(g["conv"][:take].sum())
        else:
            counts = read_counts([out])[0]
            fails += counts["fail_count"]
            conv += counts["conv_count"]
        shots += take
    dt = time.time() - t0
    return dict(logical_error_rate=fails / shots,
                converged_rate=conv / shots, num_shots=shots,
                shots_per_sec=shots / dt)


def steane_code():
    """The [[7,1,3]] Steane code (Hx = Hz = Hamming(7,4) checks)."""
    Hs = np.array([[0, 0, 0, 1, 1, 1, 1],
                   [0, 1, 1, 0, 0, 1, 1],
                   [1, 0, 1, 0, 1, 0, 1]], dtype=np.uint8)
    Lx, Lz = gf2.css_logical_ops(Hs, Hs)
    return Hs, Hs.copy(), Lx, Lz
