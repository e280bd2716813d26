"""Diagnostics: channel-probability statistics of cached decoding matrices,
and the explainer gallery.

The port's counterpart of the JAX package's ``info.py``: for each cached
(code, p) decoding-matrix set in ``--cache-dir`` (either package's cache
files), print the channel probabilities' min/max/mean and save their
histograms; with ``--gallery``, regenerate the 15 explainer figures
(``utils/gallery.py``), sampling and decoding on ``--device``.

    python -m qldpc_tpu_torch.scripts.info [--cache-dir matrix_cache]
    python -m qldpc_tpu_torch.scripts.info --gallery [--device cpu]
"""
from __future__ import annotations

import argparse
import glob
import os

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cache-dir", default="matrix_cache")
    ap.add_argument("--out-dir", default="info_vis")
    ap.add_argument("--gallery", action="store_true",
                    help="regenerate the explainer gallery from live objects")
    ap.add_argument("--gallery-code", default="[[72, 12, 6]]")
    ap.add_argument("--device", default="cuda",
                    help="device of the gallery's sampled figures")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    if args.gallery:
        from ..utils.gallery import generate_gallery
        return generate_gallery(args.out_dir, code_name=args.gallery_code,
                                validation_json="validation_results.json",
                                device=args.device)
    files = sorted(glob.glob(os.path.join(args.cache_dir, "matrices_*.npz")))
    if not files:
        print(f"no cached matrices in {args.cache_dir}")
        return []
    paths = []
    for path in files:
        key = os.path.basename(path)[len("matrices_"):-len(".npz")]
        d = np.load(path)
        for basis in ("Z", "X"):
            probs = d[f"channel_probs{basis}"]
            H = d[f"Hdec{basis}"]
            print(f"{key} {basis}: H {H.shape}, probs "
                  f"min={probs.min():.3e} max={probs.max():.3e} "
                  f"mean={probs.mean():.3e}")
            plt.figure(figsize=(6, 4))
            plt.hist(probs, bins=60)
            plt.yscale("log")
            plt.xlabel("channel probability")
            plt.ylabel("fault classes")
            plt.title(f"{key} ({basis}) channel probabilities")
            plt.tight_layout()
            out = os.path.join(args.out_dir, f"{key}_{basis}_probs.png")
            plt.savefig(out, dpi=120)
            plt.close()
            paths.append(out)
    print(f"histograms saved to {args.out_dir}")
    return paths


if __name__ == "__main__":
    main()
