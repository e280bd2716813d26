"""Batched normalized min-sum and tanh BP over padded-CSR Tanner graphs.

The port of the JAX package's generic decoder (``qldpc_tpu/ops/bp.py``):
one call decodes B shots at once, the shot axis innermost so that the
card's loads coalesce along it. Edge messages live in a padded row layout
(m, dr, B) — dr = max check degree — so the check update is a two-pass
min1/min2 + sign reduction over the dr axis; the variable update gathers R
into a padded column layout (n, dc, B) with static indices, sums it, and
gathers the posteriors back to the rows.

Algorithm (the JAX package's, and through it the reference's dense and
fused sparse decoders): flooding schedule, sign convention val >= 0 is +,
first-argmin min1/min2, damping with double clipping, per-iteration hard
decision and syndrome check, per-shot freezing of the posteriors at first
convergence, and a whole-batch exit once every shot has converged (one host
read per iteration). Each posterior is summed over its column slots in slot
order and then the prior added, and the extrinsic update and the damping
mix are computed as the JAX package's XLA program computes them, as fused
multiply-adds (:func:`_fused_sub`), so a float32 decode gives JAX's bits
and the same bits on the CPU and on the card.

These are PyTorch ops on every device: the JAX package runs them as XLA,
not as a Pallas kernel. The lifted graphs' hand kernels are in
``ops/bp_lift_cuda.py`` and ``ops/bp_lift_layered_cuda.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device

_BIG = 1e30  # padded-lane magnitude: sign +, never the row min


@dataclasses.dataclass(frozen=True)
class TannerGraph:
    """Padded-CSR structure of a parity-check matrix (tensors on one
    device)."""

    row_cols: torch.Tensor   # (m, dr) int64: column of each row edge (pad: n)
    row_mask: torch.Tensor   # (m, dr) bool: real-edge mask
    col_edges: torch.Tensor  # (n, dc) int64: flat row-edge slot per column
                             #   edge (pad: m * dr, a dummy slot)
    col_mask: torch.Tensor   # (n, dc) bool
    m: int
    n: int
    dr: int
    dc: int

    @staticmethod
    def from_dense(H: np.ndarray, device=None) -> "TannerGraph":
        """The padded CSR of ``H`` on ``device``: row edges in column order,
        each column's edges in row order (the JAX package's layout)."""
        dev = resolve_device(device)
        H = np.asarray(H) != 0
        m, n = H.shape
        deg_r, deg_c = H.sum(1), H.sum(0)
        dr = max(int(deg_r.max()), 1)
        dc = max(int(deg_c.max()), 1)
        rows, cols = np.nonzero(H)                   # row-major order
        e = np.arange(rows.size) - np.concatenate([[0], np.cumsum(deg_r)])[rows]
        row_cols = np.full((m, dr), n, np.int64)
        row_cols[rows, e] = cols
        row_mask = np.zeros((m, dr), bool)
        row_mask[rows, e] = True
        by_col = np.argsort(cols, kind="stable")     # rows ascending per col
        c = cols[by_col]
        f = np.arange(c.size) - np.concatenate([[0], np.cumsum(deg_c)])[c]
        col_edges = np.full((n, dc), m * dr, np.int64)
        col_edges[c, f] = (rows * dr + e)[by_col]

        def t(a):
            return torch.as_tensor(a, device=dev)

        return TannerGraph(row_cols=t(row_cols), row_mask=t(row_mask),
                           col_edges=t(col_edges),
                           col_mask=t(col_edges < m * dr),
                           m=m, n=n, dr=dr, dc=dc)


def alpha_schedule(mode: str, maxIter: int, alpha=1.0) -> np.ndarray:
    """Per-iteration normalization factors (reference dense.py:47-51)."""
    if mode == "dynamical":
        return (1.0 - 2.0 ** (-(np.arange(maxIter) + 1.0))).astype(np.float32)
    if mode == "alvarado":
        a = float(alpha)
        if a <= 0:
            raise ValueError("alpha must be > 0 when alpha_mode='alvarado'")
        return np.full(maxIter, a, dtype=np.float32)
    if mode == "alvarado-autoregressive":
        seq = np.asarray(alpha, dtype=np.float32).ravel()
        if seq.size == 0:
            raise ValueError("alpha sequence must be non-empty")
        if seq.size >= maxIter:
            return seq[:maxIter].copy()
        return np.concatenate([seq, np.full(maxIter - seq.size, seq[-1],
                                            dtype=np.float32)])
    raise ValueError(f"Unsupported alpha_mode: {mode}")


def _fused_sub(v, a, b):
    """v - a*b rounded once to v's dtype, the product unrounded: what the
    JAX package's XLA CPU programs compute when they contract a multiply
    and an add into one fused multiply-add. The float32 product is exact in
    float64, and float64 arithmetic is the same on the CPU and the card."""
    return torch.addcmul(v.double(), a.double(), b.double(),
                         value=-1.0).to(torch.float32).to(v.dtype)


def _fused_mix(d, q, e, q_old):
    """d*q + e*q_old with e*q_old unrounded: a fused multiply-add onto the
    rounded d*q, as XLA contracts the damping update."""
    return torch.addcmul((d * q).double(), e.double(), q_old.double()
                         ).to(torch.float32).to(q.dtype)


def _check_update(Q_rows, sgn_syn, alpha, parts: bool = False):
    """Two-pass min-sum check update. Q_rows (m, dr, B), padded lanes at
    +_BIG; sgn_syn (m, B). Returns R_rows with first-argmin min1/min2
    semantics, all arithmetic in Q_rows.dtype (float32 or bfloat16); with
    ``parts`` also (coef, mag), R = coef * mag, coef = +-alpha."""
    dt, dev = Q_rows.dtype, Q_rows.device
    absQ = Q_rows.abs()
    neg = Q_rows < 0.0
    row_neg = neg.sum(1) & 1                                  # (m, B)
    sgn_prod = (torch.where(row_neg == 1, -1.0, 1.0).to(dt)
                * sgn_syn.to(dt))                             # (m, B)
    min1 = absQ.amin(1, keepdim=True)                         # (m, 1, B)
    idx1 = absQ.argmin(1)                                     # first min
    lane = torch.arange(Q_rows.shape[1], device=dev)[None, :, None]
    is_min1 = lane == idx1[:, None, :]
    big = torch.tensor(_BIG, dtype=dt, device=dev)
    min2 = torch.where(is_min1, big, absQ).amin(1, keepdim=True)
    mag = torch.where(is_min1, min2, min1)
    sgn_q = torch.where(neg, -1.0, 1.0).to(dt)
    alpha = torch.as_tensor(alpha, device=dev).to(dt)
    coef = alpha * sgn_prod[:, None, :] * sgn_q
    R = coef * mag
    return (R, coef, mag) if parts else R


def _edge_index(graph: TannerGraph):
    """Flat gather indices of the two layouts, padding clamped into range
    (the padded lanes are masked after the gather): R row slots per column
    edge (n*dc,), posterior columns per row edge (m*dr,)."""
    ce = graph.col_edges.reshape(-1).clamp(max=graph.m * graph.dr - 1)
    rc = graph.row_cols.reshape(-1).clamp(max=graph.n - 1)
    return ce, rc


def _variable_update(R_rows, prior, graph: TannerGraph, index, parts=None):
    """Posteriors and extrinsic Q from R.

    Returns (values (n, B) f32, Q_rows, vals_rows): vals_rows is the row
    layout gather of the posteriors (in the message dtype), which the
    syndrome check reuses. Each posterior is R summed over the column's
    slots in slot order, in float32 whatever the message dtype, then the
    prior added. With ``parts`` = (coef, mag) of R, Q = vals_rows -
    coef*mag with one rounding (:func:`_fused_sub`), else vals_rows - R.
    Padded row lanes come back as garbage; callers mask them."""
    ce, rc = index
    B, dt = R_rows.shape[-1], R_rows.dtype
    R_cols = R_rows.reshape(graph.m * graph.dr, B).index_select(0, ce)
    R_cols = torch.where(graph.col_mask.reshape(-1, 1), R_cols,
                         torch.zeros((), dtype=dt, device=R_rows.device))
    R_cols = R_cols.reshape(graph.n, graph.dc, B)
    acc = R_cols[:, 0].float()
    for d in range(1, graph.dc):
        acc = acc + R_cols[:, d].float()
    values = prior[:, None] + acc
    vals_rows = values.to(dt).index_select(0, rc).reshape(graph.m, graph.dr,
                                                          B)
    Q = (vals_rows - R_rows if parts is None
         else _fused_sub(vals_rows, *parts))
    return values, Q, vals_rows


def _syndrome_of(hard, graph: TannerGraph):
    """(m, B) parity of hard decisions (n, B) over each check's support."""
    B = hard.shape[-1]
    hard_pad = torch.cat([hard, torch.zeros((1, B), dtype=hard.dtype,
                                            device=hard.device)])
    h_rows = hard_pad.index_select(0, graph.row_cols.reshape(-1))
    return h_rows.reshape(graph.m, graph.dr, B).to(torch.int32).sum(1) & 1


def _initial(graph: TannerGraph, syndrome, prior, dt):
    """Shared set-up: syndrome (m, B) int32 and its signs, the f32 prior,
    the row-edge mask (m, dr, 1), and Q0, the prior on every row edge in
    ``dt`` with padded lanes at +_BIG."""
    dev = syndrome.device
    B = syndrome.shape[0]
    syn = syndrome.T.to(torch.int32).contiguous()            # (m, B)
    sgn_syn = 1.0 - 2.0 * syn.to(torch.float32)
    prior = prior.to(device=dev, dtype=torch.float32)
    mask3 = graph.row_mask[:, :, None]
    prior_pad = torch.cat([prior, torch.zeros(1, device=dev)])
    Q0 = prior_pad.index_select(0, graph.row_cols.reshape(-1))
    Q0 = Q0.reshape(graph.m, graph.dr, 1).expand(graph.m, graph.dr, B)
    Q0 = torch.where(mask3, Q0.to(dt), torch.tensor(_BIG, dtype=dt,
                                                    device=dev))
    return syn, sgn_syn, prior, mask3, Q0


def _converged(vals_rows, graph: TannerGraph, syn):
    """(B,) whether the hard decision of the row-layout posteriors meets the
    syndrome (padded lanes masked)."""
    hard_rows = (vals_rows < 0.0) & graph.row_mask[:, :, None]
    parity = hard_rows.sum(1) & 1                             # (m, B)
    return (parity == syn).all(0)


def _check_inputs(graph: TannerGraph, syndrome, prior, maxIter: int):
    if syndrome.dim() != 2 or syndrome.shape[1] != graph.m:
        raise ValueError(f"syndrome must be (B, {graph.m}), got "
                         f"{tuple(syndrome.shape)}")
    if prior.shape != (graph.n,):
        raise ValueError(f"prior must be ({graph.n},), got "
                         f"{tuple(prior.shape)}")
    if maxIter < 1:
        raise ValueError("maxIter must be >= 1")


def _result(vals, done, iters):
    """The decode dict from the frozen posteriors (n, B)."""
    return dict(hard=(vals < 0.0).to(torch.int8).T.contiguous(),
                converged=done, values=vals.T.contiguous(), iterations=iters)


def decode_batch(graph: TannerGraph, syndrome, prior, alpha_seq,
                 maxIter: int, damping: float = 1.0, clip_llr: float = 20.0,
                 msg_dtype=torch.float32):
    """Decode a batch of syndromes with normalized min-sum.

    Args:
      graph: TannerGraph of the decoding matrix, on the syndrome's device.
      syndrome: (B, m) 0/1 syndromes.
      prior: (n,) f32 channel LLRs.
      alpha_seq: (>= maxIter,) f32 per-iteration normalization.
      maxIter, damping, clip_llr: as in the reference decoders.
      msg_dtype: dtype of the edge messages, torch.float32 or
        torch.bfloat16 (posteriors are accumulated in float32 either way).

    Returns dict: hard (B, n) int8, converged (B,) bool, values (B, n) f32
    posteriors, iterations (B,) int32 — frozen at each shot's first
    syndrome-satisfying iteration.
    """
    _check_inputs(graph, syndrome, prior, maxIter)
    dev, dt = syndrome.device, msg_dtype
    B = syndrome.shape[0]
    syn, sgn_syn, prior, mask3, Q = _initial(graph, syndrome, prior, dt)
    alpha_seq = torch.as_tensor(alpha_seq, device=dev).to(torch.float32)
    index = _edge_index(graph)
    big = torch.tensor(_BIG, dtype=dt, device=dev)
    d_new = torch.tensor(damping, dtype=dt, device=dev)
    d_old = torch.tensor(1.0 - damping, dtype=dt, device=dev)
    Qold = Q
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    vals = torch.zeros((graph.n, B), dtype=torch.float32, device=dev)
    iters = torch.full((B,), maxIter - 1, dtype=torch.int32, device=dev)
    for it in range(maxIter):
        if bool(done.all()):
            break
        R, *parts = _check_update(Q, sgn_syn, alpha_seq[it], parts=True)
        values, Q_new, vals_rows = _variable_update(R, prior, graph, index,
                                                    parts)
        Q_new = torch.clamp(Q_new, -clip_llr, clip_llr)
        if damping != 1.0:
            Q_new = torch.clamp(_fused_mix(d_new, Q_new, d_old, Qold),
                                -clip_llr, clip_llr)
        Q = torch.where(mask3, Q_new, big)
        ok = _converged(vals_rows, graph, syn)
        # freeze at first convergence; unconverged shots keep updating so
        # they report final-iteration state
        vals = torch.where(done[None, :], vals, values)
        iters = torch.where(ok & ~done, it, iters)
        done = done | ok
        if damping != 1.0:
            Qold = Q
    return _result(vals, done, iters)


def _tanh32(x):
    """float32 tanh, evaluated in float64 and rounded once."""
    return torch.tanh(x.double()).to(torch.float32)


def _atanh32(x):
    """float32 atanh, evaluated in float64 and rounded once."""
    return torch.atanh(x.double()).to(torch.float32)


def _tanh_check_update(Q_rows, sgn_syn, clip_val):
    """Tanh/arctanh true-BP check update (reference bp_core,
    src/decoding/kernels.py:171-193). Padded lanes hold +_BIG, whose tanh is
    exactly 1.0, the identity of the row product. The excluded-self product
    is row_prod / t_j, and near-zero tanh factors are floored at +-1e-15
    (t >= 0 -> +1e-15).

    Messages are float32; tanh and atanh are evaluated in float64 and
    rounded, and the row product is taken in slot order, so that the CPU and
    the card agree (their float32 transcendentals differ in the last bits,
    which atanh near the clip amplifies)."""
    t = _tanh32(Q_rows * 0.5)
    floor = torch.where(t >= 0.0, 1e-15, -1e-15).to(t.dtype)
    t = torch.where(t.abs() < 1e-15, floor, t)
    row_prod = t[:, 0]
    for d in range(1, t.shape[1]):
        row_prod = row_prod * t[:, d]                         # (m, B)
    prod_others = row_prod[:, None, :] / t
    prod_c = torch.clamp(prod_others * sgn_syn[:, None, :].to(t.dtype),
                         -clip_val, clip_val)
    return 2.0 * _atanh32(prod_c)


def decode_batch_tanh(graph: TannerGraph, syndrome, prior, maxIter: int,
                      clip_val: float = 0.9999999):
    """Batched tanh-based true belief propagation (the reference's
    performBeliefPropagationFast, src/decoding/dense.py:75-96): no alpha,
    no damping, no message clipping — messages are bounded by
    2*arctanh(clip_val). Same schedule, convergence test, freezing and exit
    as :func:`decode_batch`; returns the same dict. Messages are float32."""
    _check_inputs(graph, syndrome, prior, maxIter)
    dev = syndrome.device
    B = syndrome.shape[0]
    syn, sgn_syn, prior, mask3, Q = _initial(graph, syndrome, prior,
                                             torch.float32)
    index = _edge_index(graph)
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    vals = torch.zeros((graph.n, B), dtype=torch.float32, device=dev)
    iters = torch.full((B,), maxIter - 1, dtype=torch.int32, device=dev)
    for it in range(maxIter):
        if bool(done.all()):
            break
        R = _tanh_check_update(Q, sgn_syn, clip_val)
        values, Q_new, vals_rows = _variable_update(R, prior, graph, index)
        Q = torch.where(mask3, Q_new, big)
        ok = _converged(vals_rows, graph, syn)
        vals = torch.where(done[None, :], vals, values)
        iters = torch.where(ok & ~done, it, iters)
        done = done | ok
    return _result(vals, done, iters)


def harvest_messages(graph: TannerGraph, syndrome, prior, alpha_seq,
                     advance_iters: int, damping: float = 1.0,
                     clip_llr: float = 20.0):
    """Advance float32 min-sum ``advance_iters`` iterations with no
    convergence exit (calibration advances state unconditionally, reference
    alpha.py:219-244), then run one unscaled (alpha = 1) check pass.
    ``damping`` != 1 mixes each iteration's messages with the last ones as
    :func:`decode_batch` does.

    Returns (R_rows (m, dr, B) unscaled messages, row_cols (m, dr)): the
    Alvarado estimators bucket these messages by the true bit of each
    edge's column."""
    _check_inputs(graph, syndrome, prior, 1)
    dev = syndrome.device
    syn, sgn_syn, prior, mask3, Q = _initial(graph, syndrome, prior,
                                             torch.float32)
    alpha_seq = torch.as_tensor(alpha_seq, device=dev).to(torch.float32)
    index = _edge_index(graph)
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    d_new = torch.tensor(damping, dtype=torch.float32, device=dev)
    d_old = torch.tensor(1.0 - damping, dtype=torch.float32, device=dev)
    for it in range(int(advance_iters)):
        R, *parts = _check_update(Q, sgn_syn, alpha_seq[it], parts=True)
        _, Q_new, _ = _variable_update(R, prior, graph, index, parts)
        Q_new = torch.clamp(Q_new, -clip_llr, clip_llr)
        if damping != 1.0:
            Q_new = torch.clamp(_fused_mix(d_new, Q_new, d_old, Q),
                                -clip_llr, clip_llr)
        Q = torch.where(mask3, Q_new, big)
    R = _check_update(Q, sgn_syn, 1.0)
    return R, graph.row_cols
