"""Data-driven min-sum calibration: Alvarado alpha, autoregressive alpha,
and SCOPT beta.

The port of the JAX package's ``qldpc_tpu/ops/calibrate.py`` (reference
src/decoding/alpha.py:84-276, src/decoding/scopt.py:8-177): each
estimation point draws all its iid error samples, propagates them to
syndromes and harvests the BP messages (or decodes) as one batched
computation on the device, in chunks of 512 shots, and histograms the
samples there (:func:`_histogram`, numpy's own binning rule, so the counts
are numpy's); only the linear fit log(f0/f1) = alpha * lambda over the 50
bins runs on the host (scipy ``curve_fit``, as in the reference).

Randomness: every chunk draws from its own ``torch.Generator`` on the
device, seeded from a path of integers (the estimator's seed, the
autoregressive step's 7919*k, the chunk's first trial), as the JAX package
folds its keys. The streams are not JAX's; tests feed both packages the
same errors by replacing :func:`_sample_errors_and_syndromes`.
"""
from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from .bp import TannerGraph, alpha_schedule, decode_batch, harvest_messages

logger = logging.getLogger(__name__)

_CHUNK = 512                  # shots a harvest or decode chunk, as in JAX


def _dynamical_alpha(k: int) -> float:
    """The dynamical schedule value for iteration k (kernels.py:273)."""
    return 1.0 - 2.0 ** (-(k + 1))


def _gate_alpha(a: float, r2: float, k: int, r2_gate: float,
                alpha_range: Tuple[float, float]) -> Tuple[float, bool]:
    """Accept a fitted per-iteration alpha only if the fit is trustworthy:
    R^2 >= r2_gate and the value inside ``alpha_range``; otherwise the
    dynamical schedule value for this iteration (which the later advances
    then use). The reference ships the raw fit, which collapses decoding at
    [[288]] when one noisy early fit poisons every later advance
    (VALIDATION.md: LER 1.000). Returns (alpha, used_fallback)."""
    lo, hi = alpha_range
    if np.isfinite(a) and np.isfinite(r2) and r2 >= r2_gate and lo <= a <= hi:
        return a, False
    return _dynamical_alpha(k), True


def _histogram(x, lo: float, hi: float, bins: int):
    """``np.histogram(x, bins, range=(lo, hi), density=True)`` for a float64
    tensor x inside [lo, hi], binned where x lives by numpy's uniform-bin
    rule (index from (x - lo) / (hi - lo) * bins, then corrected against
    the linspace edges), so the counts are numpy's. Returns (density,
    edges) as numpy arrays."""
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    edges = np.linspace(lo, hi, bins + 1)
    dev = x.device
    # the span as a device tensor: a CPU scalar divisor is turned into a
    # reciprocal multiply on the card, which can move a value across an edge
    span = torch.tensor(hi - lo, dtype=torch.float64, device=dev)
    e = torch.as_tensor(edges, device=dev)
    idx = ((x - lo) / span * bins).to(torch.int64)
    idx = torch.where(idx == bins, idx - 1, idx)
    idx = idx - (x < e[idx]).to(torch.int64)
    idx = idx + ((x >= e[idx + 1]) & (idx != bins - 1)).to(torch.int64)
    n = torch.bincount(idx, minlength=bins).cpu().numpy()
    return n / np.diff(edges) / n.sum(), edges


class FitFailed(ValueError):
    """The fit itself failed: no finite samples, no bin both histograms
    fill, or scipy found no optimum. Only this is caught where a failed fit
    falls back to the dynamical schedule; an error of the device work that
    fed the fit propagates."""


def _fit_log_ratio(x0, x1, bins: int, flip: bool = False,
                   plot_path: Optional[str] = None, title: str = ""):
    """Histogram two sample sets (arrays or tensors, on any device), fit
    log(f0/f1) = a*x (or f1/f0 with flip=True), return (a, r2). Reference
    alpha.py:9-66 / scopt.py:141-160. Raises :class:`FitFailed` when the
    fit cannot be made. matplotlib is imported only when ``plot_path`` is
    given."""
    from scipy.optimize import curve_fit

    x0 = torch.as_tensor(x0).to(torch.float64)
    x1 = torch.as_tensor(x1).to(torch.float64)
    # degree-1 check rows emit messages of magnitude _BIG, the decoder's
    # finite stand-in for the reference's +-inf; the reference drops
    # infinite samples before fitting (alpha.py:23-24), so drop these too
    x0 = x0[torch.isfinite(x0) & (x0.abs() < 1e29)]
    x1 = x1[torch.isfinite(x1) & (x1.abs() < 1e29)]
    if x0.numel() == 0 or x1.numel() == 0:
        raise FitFailed("No finite samples for calibration fit")
    lo = min(float(x0.min()), float(x1.min()))
    hi = max(float(x0.max()), float(x1.max()))
    h0, edges = _histogram(x0, lo, hi, bins)
    h1, _ = _histogram(x1, lo, hi, bins)
    centers = (edges[:-1] + edges[1:]) / 2.0
    valid = (h0 > 0) & (h1 > 0)
    if not np.any(valid):
        raise FitFailed("No overlapping histogram bins for calibration fit")
    xs = centers[valid]
    ys = (np.log(h1[valid] / h0[valid]) if flip
          else np.log(h0[valid] / h1[valid]))
    try:
        popt, _ = curve_fit(lambda x, a: a * x, xs, ys)
    except RuntimeError as e:      # scipy: optimal parameters not found
        raise FitFailed(str(e)) from e
    a = float(popt[0])
    fit = a * xs
    ss_res = np.sum((ys - fit) ** 2)
    ss_tot = np.sum((ys - np.mean(ys)) ** 2)
    r2 = 1.0 - (ss_res / ss_tot if ss_tot > 0 else np.nan)
    if plot_path is not None:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.figure(figsize=(6, 4))
        plt.scatter(xs, ys, s=10, alpha=0.7, label="samples")
        plt.plot(xs, fit, color="#DBA142", label=f"fit (R^2={r2:.3f})")
        plt.xlabel("LLR" if flip else "Lambda")
        plt.ylabel("log(f1/f0)" if flip else "log(f0/f1)")
        plt.title(title)
        plt.grid(True, ls="-", alpha=0.4)
        plt.legend()
        plt.tight_layout()
        plt.savefig(plot_path, dpi=150)
        plt.close()
    return a, float(r2)


def _generator(device, *path: int) -> torch.Generator:
    """A generator on ``device`` seeded from a path of non-negative
    integers (the counterpart of nested ``jax.random.fold_in``)."""
    seed = np.random.SeedSequence([int(v) for v in path]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed >> np.uint64(1)))


def _sample_errors_and_syndromes(gen, HT, n, error_rate, trials):
    """iid Bernoulli(error_rate) errors per decoding-graph column and their
    syndromes (the reference calibrates on this simplified channel,
    alpha.py:127-128, not the circuit-level one). HT (n, m) float32 0/1 on
    the generator's device; the 0/1 product is exact in float32. Returns
    (errors (trials, n) bool, syndromes (trials, m) int8)."""
    e = torch.rand((trials, n), generator=gen, device=HT.device) < error_rate
    syn = (e.to(torch.float32) @ HT).to(torch.int32) & 1
    return e, syn.to(torch.int8)


def _setup(H, llrs, device):
    """Graph, HT (n, m) float32 and prior on the device."""
    dev = resolve_device(device)
    Hb = np.asarray(H) != 0
    graph = TannerGraph.from_dense(Hb, device=dev)
    HT = torch.as_tensor(np.ascontiguousarray(Hb.T, np.float32), device=dev)
    prior = torch.as_tensor(np.asarray(llrs, np.float32), device=dev)
    return dev, graph, HT, prior


def _harvest_buckets(graph, HT, prior, error_rate, trials, seed_path,
                     alpha_prefix, advance_iters, seq_len=None):
    """Unscaled check messages bucketed by the true bit value of the edge's
    variable, after advancing ``advance_iters`` BP iterations with
    ``alpha_prefix``. Chunk c draws from ``_generator(dev, *seed_path,
    c_start)``. Returns (messages of 0-bits, messages of 1-bits) as float32
    tensors on the device, in the JAX package's order (chunk, edge,
    shot)."""
    dev = HT.device
    maxI = seq_len if seq_len is not None else max(advance_iters, 1)
    seq = np.zeros(maxI, dtype=np.float32)
    seq[:len(alpha_prefix)] = alpha_prefix[:maxI]
    seq_t = torch.as_tensor(seq, device=dev)
    mask = graph.row_mask
    cols = graph.row_cols[mask]                       # (nnz,) column per edge
    out0, out1 = [], []
    done = 0
    while done < trials:
        t = min(_CHUNK, trials - done)
        e, syn = _sample_errors_and_syndromes(
            _generator(dev, *seed_path, done), HT, graph.n, error_rate, t)
        R, _ = harvest_messages(graph, syn, prior, seq_t, advance_iters)
        bits = e.T.index_select(0, cols)              # (nnz, t) true bits
        msgs = R[mask]                                # (nnz, t)
        out0.append(msgs[~bits])
        out1.append(msgs[bits])
        done += t
    return torch.cat(out0), torch.cat(out1)


def _check_rate(error_rate):
    if not (0 < error_rate < 0.5):
        raise ValueError("error_rate must be in (0, 0.5)")


def estimate_alpha_alvarado(H, error_rate, trials=5000, bins=50, llrs=None,
                            seed=0, plot_path: Optional[str] = None,
                            device=None) -> Tuple[float, float]:
    """Single-alpha Alvarado estimation from one unscaled min-sum pass on
    the prior (reference alpha.py:84-157). Returns (alpha, R^2)."""
    _check_rate(error_rate)
    dev, graph, HT, prior = _setup(H, llrs, device)
    t0, t1 = _harvest_buckets(graph, HT, prior, error_rate, trials, (seed,),
                              np.zeros(0, np.float32), 0)
    return _fit_log_ratio(t0, t1, bins, plot_path=plot_path,
                          title=f"Alvarado alpha fit (p={error_rate:.6g})")


def estimate_alpha_alvarado_autoregressive(
        H, error_rate, maxIter, trials=5000, bins=50, llrs=None, seed=0,
        plot_dir: Optional[str] = None, plot_prefix: Optional[str] = None,
        r2_gate: float = 0.85, alpha_range: Tuple[float, float] = (0.05, 1.5),
        return_fallbacks: bool = False, device=None):
    """Per-iteration alpha sequence: iteration k's alpha is fit from the
    unscaled messages after advancing k iterations with alpha_0..k-1
    (reference alpha.py:160-276), each fit gated by :func:`_gate_alpha`.
    Set r2_gate=-inf AND alpha_range=(-inf, inf) for the reference's
    ungated behaviour. Returns (alphas, r2s[, n_fallback])."""
    _check_rate(error_rate)
    if maxIter <= 0:
        raise ValueError("maxIter must be > 0")
    dev, graph, HT, prior = _setup(H, llrs, device)
    alphas, r2s = [], []
    n_fallback = 0
    for k in range(maxIter):
        plot_path = None
        if plot_dir is not None:
            prefix = plot_prefix or f"autoregressive_p{error_rate:.6g}"
            plot_path = f"{plot_dir}/{prefix}_iter{k + 1}_alpha_fit.png"
        t0, t1 = _harvest_buckets(
            graph, HT, prior, error_rate, trials, (seed, 7919 * k),
            np.asarray(alphas, dtype=np.float32), k, seq_len=maxIter)
        try:
            a, r2 = _fit_log_ratio(
                t0, t1, bins, plot_path=plot_path,
                title=f"Autoregressive alpha fit "
                      f"(p={error_rate:.6g}, iter={k+1})")
        except FitFailed as e:
            logger.warning("autoregressive alpha fit failed at iter %d "
                           "(%s); using dynamical value", k + 1, e)
            a, r2 = np.nan, np.nan
        a, fell_back = _gate_alpha(a, r2, k, r2_gate, alpha_range)
        n_fallback += fell_back
        alphas.append(a)
        r2s.append(r2)
    if n_fallback:
        logger.warning(
            "autoregressive alpha: %d/%d iterations failed the fit gate "
            "(R^2 < %.2f or alpha outside %s) and used the dynamical "
            "schedule value instead", n_fallback, maxIter, r2_gate,
            alpha_range)
    out = (np.asarray(alphas, dtype=np.float64),
           np.asarray(r2s, dtype=np.float64))
    return out + (n_fallback,) if return_fallbacks else out


def estimate_scopt_beta(H, error_rate, trials=10000, bins=50, alpha=1.0,
                        alpha_mode="dynamical", maxIter=50, llrs=None,
                        seed=0, plot_path: Optional[str] = None,
                        chunk=_CHUNK, device=None) -> Tuple[float, float]:
    """SCOPT beta: fit log(f1/f0) = beta * x on the final posterior LLRs of
    a full (early-exiting) float32 min-sum decode (reference
    scopt.py:8-177), ``chunk`` trials a decode. Returns (beta, R^2)."""
    _check_rate(error_rate)
    dev, graph, HT, prior = _setup(H, llrs, device)
    seq = torch.as_tensor(alpha_schedule(alpha_mode, maxIter, alpha),
                          device=dev)
    f0, f1 = [], []
    done = 0
    while done < trials:
        t = min(chunk, trials - done)
        e, syn = _sample_errors_and_syndromes(
            _generator(dev, seed, done), HT, graph.n, error_rate, t)
        vals = decode_batch(graph, syn, prior, seq, maxIter)["values"]
        f0.append(vals[~e])
        f1.append(vals[e])
        done += t
    return _fit_log_ratio(torch.cat(f0), torch.cat(f1), bins,
                          flip=True, plot_path=plot_path,
                          title=f"SCOPT beta fit (p={error_rate:.6g})")
