"""Time-layered normalized min-sum BP on the padded row layout of ``bp``.

H's rows are cycle-major, checks of cycle c at rows c*ell*mm ...
(c+1)*ell*mm - 1. Sweep t (alpha_t from the configuration's schedule) runs
two halves, L = 0 then L = 1:

* every edge's Q = posterior - R, clipped to +-clip in every half, the
  first half of sweep 0 included (so a prior beyond the clip is clipped:
  flooding sends it unclipped at t = 0);
* only the checks of the half's layer, (row // (ell*mm)) % 2 == L, answer
  and commit a new R = alpha_t * s * |Q|min_extrinsic (``bp.check_messages``,
  as in flooding); the other layer's R stay as committed;
* the posteriors are rebuilt from every committed R, each column summed
  from zero in its sum order (``bp.sum_keys``), then the prior.

A shot's hard decision (posterior < 0) is tested against its syndrome once
a sweep, after the second half; a shot that meets it stops: its decision,
posteriors and sweep count are kept from that sweep. The outputs are
``bp.decode``'s, with ``iterations`` the sweeps each shot ran (its
converging one counted; max_iter when it never converged).

``msg_dtype`` rounds Q and R to a narrower type (the control runs bfloat16
messages); the posteriors are float32 either way.
"""
from __future__ import annotations

import numpy as np
import torch

from .bp import Graph, check_messages, posteriors, satisfied


def decode(g: Graph, syndrome, alpha, max_iter: int, clip: float,
           msg_dtype=torch.float32) -> dict:
    """syndrome (B, m) 0/1; as ``bp.decode``, with iterations counting
    sweeps."""
    dev = syndrome.device
    B = syndrome.shape[0]
    dt = msg_dtype
    syn = syndrome.to(torch.int64)
    sgn_syn = (1 - 2 * syn).to(torch.float32)
    alpha = torch.as_tensor(np.asarray(alpha, np.float32), device=dev)
    layer = (torch.arange(g.m, device=dev) // g.layer_rows) % 2
    halves = []
    for L in (0, 1):
        rows = torch.nonzero(layer == L)[:, 0]
        halves.append((rows, g.row_cols[rows], g.mask[rows]))
    prior_pad = torch.cat([g.prior, torch.zeros(1, device=dev)])
    V = prior_pad[None].expand(B, -1).clone()           # (B, n + 1)
    R = torch.zeros((B, g.m, g.dr), dtype=dt, device=dev)
    values = V[:, :g.n].clone()
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.full((B,), max_iter, dtype=torch.int64, device=dev)
    for t in range(max_iter):
        for rows, row_cols, mask in halves:
            Q = torch.clamp(V[:, row_cols].to(dt) - R[:, rows], -clip, clip)
            R[:, rows] = check_messages(Q, mask, sgn_syn[:, rows], alpha[t],
                                        dt)
            V = posteriors(g, R)
        ok = satisfied(g, V, syn)
        new = ok & ~done
        values = torch.where(done[:, None], values, V[:, :g.n])
        iters = torch.where(new, t + 1, iters)
        done = done | ok
        if bool(done.all()):
            break
    return dict(values=values, hard=values < 0, converged=done,
                iterations=iters)
