"""Generate BB code npz files from their defining polynomials.

The port's counterpart of the JAX package's ``generate_codes.py``: parity
checks are rebuilt from the polynomial powers, logical operators derived
with GF(2) linear algebra, and each code is written in the reference's
``codes/*.npz`` format (same keys; Hx/Hz and the polynomials byte-identical
to the reference's, Lx/Lz an independently derived symplectic basis).
Without ``--codes`` it also writes ``steane.npz`` (Hx/Hz only, in the
reference file's row order).

    python -m qldpc_tpu_torch.scripts.generate_codes [--out-dir codes]
        [--codes "[[72, 12, 6]]" ...]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from .. import CODE_REGISTRY, get_code


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default="codes")
    ap.add_argument("--codes", nargs="*", default=None,
                    help="subset of registry names (default: all)")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    names = args.codes or list(CODE_REGISTRY)
    paths = []
    for name in names:
        code = get_code(name)
        code.validate()
        # the checks must equal their polynomial reconstruction
        A = np.bitwise_xor.reduce(np.stack(code.A_components()), axis=0)
        B = np.bitwise_xor.reduce(np.stack(code.B_components()), axis=0)
        assert np.array_equal(np.hstack([A, B]), code.Hx), name
        path = os.path.join(args.out_dir, f"{name}.npz")
        code.save_npz(path)
        paths.append(path)
        print(f"{name}: Hx {code.Hx.shape}, k={code.k} -> {path}")
    if args.codes is None:
        from ..parallel.code_capacity import steane_code
        Hx, Hz, _, _ = steane_code()
        # the reference file lists the Hamming rows most-significant-last
        Hx, Hz = Hx[::-1], Hz[::-1]
        path = os.path.join(args.out_dir, "steane.npz")
        np.savez(path, Hx=Hx.astype(np.int64), Hz=Hz.astype(np.int64))
        paths.append(path)
        print(f"steane: Hx {Hx.shape} -> {path}")
    return paths


if __name__ == "__main__":
    main()
