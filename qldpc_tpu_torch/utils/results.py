"""Timestamped run directories and results persistence.

Capability parity with the reference driver's output handling
(reference main.py:52-57, 108-149): ``output/run_<ts>/`` with results.npz
(results + alpha/beta values + R^2 dicts), plots, and estimation_plots/.
The npz keys and layout are the JAX package's, so either package loads the
other's results.
"""
from __future__ import annotations

import os
from datetime import datetime
from typing import Dict, Tuple

import numpy as np


def make_run_dir(base: str = "output") -> Tuple[str, str]:
    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    run_dir = os.path.join(base, f"run_{ts}")
    est_dir = os.path.join(run_dir, "estimation_plots")
    os.makedirs(est_dir, exist_ok=True)
    return run_dir, est_dir


def collect_calibration(results: Dict) -> Tuple[Dict, Dict, Dict]:
    """Split calibration metadata out of per-(code, p) results, in the
    reference's nested-dict layout (main.py:109-139)."""
    alpha_values: Dict = {}
    beta_values: Dict = {}
    est_r2: Dict = {}
    for code_name, data in results.items():
        for p, res in data.items():
            if "alpha_values_z" in res or "alpha_values_x" in res:
                alpha_values.setdefault(code_name, {})[p] = {
                    "z": res.get("alpha_values_z"),
                    "x": res.get("alpha_values_x"),
                }
                est_r2.setdefault(code_name, {})[p] = {
                    "alpha_r2_values_z": res.get("alpha_r2_values_z"),
                    "alpha_r2_values_x": res.get("alpha_r2_values_x"),
                }
            if "alpha_r2_z" in res or "alpha_r2_x" in res:
                est_r2.setdefault(code_name, {})[p] = {
                    **est_r2.get(code_name, {}).get(p, {}),
                    "alpha_r2_z": res.get("alpha_r2_z"),
                    "alpha_r2_x": res.get("alpha_r2_x"),
                }
            if "beta_z" in res or "beta_x" in res:
                beta_values.setdefault(code_name, {})[p] = {
                    "z": res.get("beta_z"), "x": res.get("beta_x")}
            if "beta_r2_z" in res or "beta_r2_x" in res:
                est_r2.setdefault(code_name, {})[p] = {
                    **est_r2.get(code_name, {}).get(p, {}),
                    "beta_r2_z": res.get("beta_r2_z"),
                    "beta_r2_x": res.get("beta_r2_x"),
                }
    return alpha_values, beta_values, est_r2


def save_results(run_dir: str, results: Dict, alpha_r2_values: Dict = None
                 ) -> str:
    alpha_values, beta_values, est_r2 = collect_calibration(results)
    path = os.path.join(run_dir, "results.npz")
    np.savez(
        path,
        results=np.asarray(results, dtype=object),
        alpha_values=np.asarray(alpha_values, dtype=object),
        beta_values=np.asarray(beta_values, dtype=object),
        alpha_r2_values=np.asarray(alpha_r2_values or {}, dtype=object),
        estimation_r2_values=np.asarray(est_r2, dtype=object),
    )
    return path


def load_results(path: str) -> Dict:
    data = np.load(path, allow_pickle=True)
    return {k: data[k].item() if data[k].shape == () else data[k]
            for k in data.files}
