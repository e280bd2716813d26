"""Time-layered min-sum BP on a lifted graph: CUDA kernel K3 and its plain
twin.

``decode_batch_lift_layered_cuda`` has the contract of the JAX package's
``decode_batch_lift_pallas(schedule="layered")`` (damping 1): each
iteration is one sweep of two half-updates, the checks at even time slices
t = row // (ell*mm) first, then the odd ones, with the posteriors rebuilt
from all committed messages between the halves; convergence is tested once
per sweep and ``iterations`` counts sweeps. On a CUDA tensor it launches
``csrc/bp_lift_layered.cu`` or raises; on a CPU tensor it runs
``decode_batch_lift_layered_plain``, the same float32 arithmetic in PyTorch
over K1's neighbour tables (``bp_lift_cuda.flood_tables``).

The kernel is K1's design with the layered order of passes: one block of
512 threads per shot, two shots per SM; each check row's messages kept as
16 bytes (the products P1 = (alpha*sgn)*m1 and P2 = (alpha*sgn)*m2, the
q-sign bits, the syndrome bit and the argmin slot), 56,448 bytes a shot at
[[144,12,12]] and 161,280 at [[288,12,18]], both in shared memory;
neighbours computed from ``bp_lift_cuda.flood_geometry``. Thread p of half L
takes the rows (2*(i // Ls) + L)*Ls + i % Ls, Ls = ell*mm, of its layer
indices i = p, p + 512, ...; the first half also walks the odd rows for the
parity test of the sweep before, when every even row is satisfied. It is
bound by instruction issue and by its four block barriers a sweep
(``PERF.md``).

Output note: as with K1, each shot's ``values`` are frozen at its
converging sweep; the Pallas kernel keeps sweeping converged shots of a
block, so only ``hard``, ``converged``, ``iterations`` and the values of
unconverged shots are part of the cross-implementation contract.
"""
from __future__ import annotations

import torch

from .bp_lift import LiftedGraph
from .bp_lift_cuda import (_PlainGraph, _check_inputs, bp_launch_info,
                           prepare_bp_launch)


def decode_batch_lift_layered_cuda(g: LiftedGraph, syndrome, prior,
                                   alpha_seq, maxIter: int,
                                   clip_llr: float = 20.0):
    """Time-layered min-sum BP (damping 1). syndrome (B, m) 0/1 with rows
    t*ell*mm + x*mm + y; prior (n,) f32; alpha_seq (>= maxIter,) f32,
    indexed by sweep.

    Returns dict hard (B, n) int8, converged (B,) bool, values (B, n) f32,
    iterations (B,) int32 (sweeps). CUDA tensors launch kernel K3; CPU
    tensors run :func:`decode_batch_lift_layered_plain`.
    ``decode_batch_lift_layered_cuda.launches`` counts the kernel
    launches."""
    _check_inputs(g, syndrome, prior, alpha_seq, maxIter)
    if syndrome.device.type == "cpu":
        return decode_batch_lift_layered_plain(g, syndrome, prior, alpha_seq,
                                               maxIter, clip_llr)
    launch, out = prepare_layered_launch(g, syndrome, prior, alpha_seq,
                                         maxIter, clip_llr)
    launch()
    return out


decode_batch_lift_layered_cuda.launches = 0


def prepare_layered_launch(g: LiftedGraph, syndrome, prior, alpha_seq,
                           maxIter: int, clip_llr: float = 20.0):
    """K3 on CUDA tensors, prepared but not launched: input casts, geometry
    and tables, output and scratch allocation, library load. Returns
    (launch, outputs): each ``launch()`` runs the kernel once into
    ``outputs`` and counts it on ``decode_batch_lift_layered_cuda``, so a
    caller can also time the kernel alone."""
    return prepare_bp_launch("K3", decode_batch_lift_layered_cuda, g,
                             syndrome, prior, alpha_seq, maxIter, clip_llr)


def layered_launch_info(g: LiftedGraph, device) -> dict:
    """K3's shape on the card for graph ``g``: registers and spilled bytes
    a thread, threads a block (one shot), state bytes a shot and where they
    live, shared memory a block, and blocks (shots) resident per SM."""
    return bp_launch_info("K3", g, device)


def decode_batch_lift_layered_plain(g: LiftedGraph, syndrome, prior,
                                    alpha_seq, maxIter: int,
                                    clip_llr: float = 20.0):
    """Plain PyTorch version of kernel K3: the same per-element float32
    arithmetic over the same neighbour tables, vectorized over shots, with
    per-shot freezing at convergence. One host read per sweep."""
    _check_inputs(g, syndrome, prior, alpha_seq, maxIter)
    ctx = _PlainGraph(g, syndrome)
    B, m, dev = ctx.B, ctx.m, ctx.dev
    alpha_seq = alpha_seq.to(device=dev, dtype=torch.float32)
    layer = (torch.arange(m, device=dev) // (g.ell * g.mm)) % 2   # (m,)
    V = ctx.tabs["prior_grid"][None].expand(B, -1).clone()
    R = torch.zeros((B, g.EB, m), dtype=torch.float32, device=dev)
    vals = V.clone()
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.full((B,), maxIter - 1, dtype=torch.int32, device=dev)
    for it in range(maxIter):
        if bool(done.all()):
            break
        for L in (0, 1):
            # Q = clip(V - R) at every check, the first half included;
            # only the layer's checks commit their new R
            Q = torch.clamp(V[:, ctx.idx] - R, -clip_llr, clip_llr)
            Rl = ctx.messages(torch.where(ctx.live, Q, ctx.big),
                              alpha_seq[it])
            R = torch.where(layer == L, Rl, R)
            V = ctx.posteriors(R)
        ok = ctx.satisfied(V)
        vals = torch.where(done[:, None], vals, V)
        iters = torch.where(ok & ~done, torch.full_like(iters, it), iters)
        done = done | ok
    return ctx.output(vals, prior, done, iters)
