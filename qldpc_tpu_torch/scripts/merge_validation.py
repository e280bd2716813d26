"""Assemble validation_results_torch.json from the port's per-mode sweeps.

The port's counterpart of the JAX package's ``scripts/merge_validation.py``.
Inputs (whichever exist at the root of the checkout), each written by
``python -m qldpc_tpu_torch.scripts.validate_ler --out <file>`` on an
NVIDIA H100 at maxIter 50: validation_torch_h100_dynamical.json,
validation_torch_h100_autoregressive.json,
validation_torch_h100_layered.json. Output: validation_results_torch.json,
every row with its ``source`` label.

    python -m qldpc_tpu_torch.scripts.merge_validation
"""
from __future__ import annotations

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SOURCES = [
    ("validation_torch_h100_dynamical.json",
     "dynamical, maxIter 50 (H100)"),
    ("validation_torch_h100_autoregressive.json",
     "alvarado-autoregressive, R2/range-gated fits, maxIter 50 (H100)"),
    ("validation_torch_h100_layered.json",
     "alvarado-autoregressive, layered BP, maxIter 50 (H100)"),
]


def main(root: str = ROOT):
    rows = []
    for fname, label in SOURCES:
        path = os.path.join(root, fname)
        if not os.path.exists(path):
            print(f"skip (missing): {fname}")
            continue
        with open(path) as f:
            data = json.load(f)
        for row in data:
            row = dict(row)
            row["source"] = label
            rows.append(row)
        print(f"{fname}: {len(data)} rows")
    out = os.path.join(root, "validation_results_torch.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=2)
    print(f"wrote {out} ({len(rows)} rows)")
    return rows


if __name__ == "__main__":
    main()
