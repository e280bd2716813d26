"""Result plotting: LER curves, alpha-sequence comparison and linearity.

Capability parity with reference src/utils/plotting.py:5-162 (same three
plots: log-log LER-vs-p scatter with per-code linear fits in log space,
autoregressive-alpha sequences against the dynamical schedule, and alpha
linearity fits with R^2 reporting).
"""
from __future__ import annotations

import math
from typing import Dict

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

# House palette (colorblind-safe, Okabe-Ito subset) — deliberately NOT the
# reference's styling constants; only the plot SEMANTICS (what is plotted
# against what, the fit extension to 1e-4, the returned R^2 dict) mirror
# reference src/utils/plotting.py.
COLORS = ["#0072B2", "#E69F00", "#009E73", "#CC79A7", "#56B4E9", "#D55E00"]
GRID_KW = dict(ls="--", alpha=0.3)


def plot_simulation_results(results: Dict, filename="simulation_results.png"):
    plt.figure(figsize=(8, 5.5))
    for i, (name, data) in enumerate(results.items()):
        ps = sorted(data.keys())
        lers = [data[p]["logical_error_rate"] for p in ps]
        color = COLORS[i % len(COLORS)]
        plt.loglog(ps, lers, "o", ms=5, label=f"n={name}", color=color)
        ps_a = np.array(ps, dtype=float)
        le_a = np.array(lers, dtype=float)
        mask = (ps_a > 0) & (le_a > 0)
        if mask.sum() >= 2:
            slope, intercept = np.polyfit(np.log10(ps_a[mask]),
                                          np.log10(le_a[mask]), 1)
            fx = np.linspace(np.log10(1e-4), np.log10(max(ps)), 200)
            plt.loglog(10 ** fx, 10 ** (slope * fx + intercept), "-",
                       color=color)
    plt.xlabel("physical error rate p")
    plt.ylabel("logical error rate")
    plt.xlim(1e-4, 1e-2)
    plt.ylim(1e-7, 1.5)
    plt.grid(True, which="both", **GRID_KW)
    plt.legend()
    plt.title("Circuit-level logical error rate vs physical error rate")
    plt.savefig(filename, dpi=160)
    plt.close()
    return filename


def _codes_with_alpha(results):
    return [name for name, data in results.items()
            if any("alpha_values_z" in res for res in data.values())]


def plot_alpha_comparison(results: Dict, filename="alpha_comparison.png"):
    names = _codes_with_alpha(results)
    if not names:
        return None
    ncols = 2 if len(names) > 1 else 1
    nrows = math.ceil(len(names) / ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(6 * ncols, 4.2 * nrows),
                             squeeze=False)
    for ax, name in zip(axes.flat, names):
        dyn_plotted = False
        for p in sorted(results[name]):
            res = results[name][p]
            if "alpha_values_z" not in res:
                continue
            az = np.asarray(res["alpha_values_z"], dtype=float)
            iters = np.arange(1, len(az) + 1)
            ax.plot(iters, az, label=f"p={p} (Z)")
            ax_vals = res.get("alpha_values_x")
            if ax_vals is not None and len(ax_vals):
                ax.plot(iters, np.asarray(ax_vals, float), "--",
                        label=f"p={p} (X)")
            if not dyn_plotted:
                ax.plot(iters, 1.0 - 2.0 ** (-iters.astype(float)), "k:",
                        label="dynamical")
                dyn_plotted = True
        ax.set_title(f"n={name}")
        ax.set_xlabel("BP iteration k")
        ax.set_ylabel(r"normalization $\alpha_k$")
        ax.grid(True, **GRID_KW)
        ax.legend(fontsize=8)
    for idx in range(len(names), nrows * ncols):
        fig.delaxes(axes.flat[idx])
    plt.tight_layout()
    plt.savefig(filename, dpi=160)
    plt.close()
    return filename


def plot_alpha_linearity(results: Dict, filename="alpha_linearity.png"):
    """Linear fits of the alpha sequences; returns nested R^2 dict
    (reference plotting.py:92-162)."""
    r2_values: Dict = {}
    names = _codes_with_alpha(results)
    if not names:
        return r2_values
    ncols = 2 if len(names) > 1 else 1
    nrows = math.ceil(len(names) / ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(6 * ncols, 4.2 * nrows),
                             squeeze=False)

    def fit_r2(iters, seq):
        coeffs = np.polyfit(iters, seq, 1)
        fit = np.polyval(coeffs, iters)
        ss_res = np.sum((seq - fit) ** 2)
        ss_tot = np.sum((seq - np.mean(seq)) ** 2)
        return fit, 1.0 - (ss_res / ss_tot if ss_tot > 0 else np.nan)

    for ax, name in zip(axes.flat, names):
        r2_values.setdefault(name, {})
        for p in sorted(results[name]):
            res = results[name][p]
            if "alpha_values_z" not in res:
                continue
            az = np.asarray(res["alpha_values_z"], dtype=float)
            iters = np.arange(1, len(az) + 1, dtype=float)
            r2_z = r2_x = np.nan
            if az.size >= 2:
                fit, r2_z = fit_r2(iters, az)
                ax.plot(iters, az, label=f"p={p} Z")
                ax.plot(iters, fit, "--", label=f"p={p} Z fit (R^2={r2_z:.3f})")
            axv = res.get("alpha_values_x")
            if axv is not None and len(axv) >= 2:
                axv = np.asarray(axv, dtype=float)
                fit, r2_x = fit_r2(iters, axv)
                ax.plot(iters, axv, ":", label=f"p={p} X")
                ax.plot(iters, fit, "-.", label=f"p={p} X fit (R^2={r2_x:.3f})")
            r2_values[name][p] = {"z": r2_z, "x": r2_x}
        ax.set_title(f"n={name}")
        ax.set_xlabel("BP iteration k")
        ax.set_ylabel(r"normalization $\alpha_k$")
        ax.grid(True, **GRID_KW)
        ax.legend(fontsize=8)
    for idx in range(len(names), nrows * ncols):
        fig.delaxes(axes.flat[idx])
    plt.tight_layout()
    plt.savefig(filename, dpi=160)
    plt.close()
    return r2_values
