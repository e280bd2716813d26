"""Statistical LER validation sweep vs the reference's archived results.

The port's counterpart of the JAX package's ``scripts/validate_ler.py``:
the same points, flags, seed, OSD order and row keys, run through the
port's ``run_simulation``. Each point is reported against the reference's
archived value with binomial error bars (``z_score``); the JAX package's
own records of the same points are what the port is held against
(``tests/test_torch_validate.py``). Decoding matrices are cached in
``matrix_cache/`` in the JAX package's file format, so both packages share
the cache.

    python -m qldpc_tpu_torch.scripts.validate_ler [--alpha-mode ...]
        [--max-iter 50] [--target-errors 200] [--device cuda|cpu]
        [--out validation_results.json]

Runs on ``cuda`` by default and raises without a GPU; ``--device cpu``
runs the plain versions.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from .. import (SyndromeCircuit, build_decoding_matrices, get_code,
                resolve_device)
from ..parallel.engine import run_simulation
from ..utils.caching import compute_cache_key, load_matrices, save_matrices
from . import card_line

# (code, p, reference LER, reference errors/trials) — BASELINE.md rows.
# The 200-error archive run_20260123_141207 was produced with the
# reference driver's committed default alpha_mode="alvarado-autoregressive"
# (reference main.py:48); the 30-error run_20260121_122432 rows for [[72]]
# are the comparison set for dynamical alpha.
BASELINE_POINTS = {
    "alvarado-autoregressive": [
        ("[[72, 12, 6]]", 0.006, 5.68e-1, (200, 352)),
        ("[[72, 12, 6]]", 0.004, 1.70e-1, (200, 1174)),
        ("[[90, 8, 10]]", 0.006, 7.43e-1, (200, 269)),
        ("[[90, 8, 10]]", 0.004, 1.66e-1, (200, 1205)),
        ("[[108, 8, 10]]", 0.006, 7.19e-1, (200, 278)),
        ("[[108, 8, 10]]", 0.004, 1.52e-1, (200, 1320)),
        ("[[144, 12, 12]]", 0.006, 8.77e-1, (200, 228)),
        ("[[144, 12, 12]]", 0.005, 5.92e-1, (200, 338)),
        ("[[144, 12, 12]]", 0.004, 1.76e-1, (200, 1135)),
        ("[[288, 12, 18]]", 0.005, 8.13e-1, (200, 246)),
        # 30-error archive run_20260122_095028; the round-2 done criterion
        # is gated-autoregressive LER <= the dynamical 0.022 (VALIDATION.md)
        # instead of the ungated collapse to 1.000
        ("[[288, 12, 18]]", 0.0035, 6.59e-2, (30, 455)),
    ],
    "dynamical": [
        ("[[72, 12, 6]]", 0.006, 5.08e-1, (30, 59)),
        ("[[72, 12, 6]]", 0.005, 3.33e-1, (30, 90)),
        ("[[72, 12, 6]]", 0.004, 2.14e-1, (30, 140)),
        ("[[72, 12, 6]]", 0.003, 6.22e-2, (30, 482)),
    ],
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--target-errors", type=int, default=200)
    ap.add_argument("--max-trials", type=int, default=20000)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--codes", nargs="*", default=None)
    ap.add_argument("--alpha-mode", default="dynamical",
                    choices=list(BASELINE_POINTS))
    ap.add_argument("--max-iter", type=int, default=20,
                    help="BP maxIter. NOTE the archives were produced at the "
                         "reference ENGINE default 50 (reference "
                         "engine.py:196; VALIDATION.md root-caused the "
                         "[[90]] z=+3.0 offset to running 20 here), so 50 "
                         "is the config-parity setting; 20 matches the "
                         "reference driver main.py:44.")
    ap.add_argument("--bp-variant", default="minsum",
                    help="minsum | layered | tanh (layered is the "
                         "beyond-reference serial schedule; validate its "
                         "LER against the same archives)")
    ap.add_argument("--out", default="validation_results.json")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu (the "
                         "plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(card_line(device), flush=True)

    rows = []
    for name, p, ref_ler, (ref_err, ref_tr) in BASELINE_POINTS[args.alpha_mode]:
        if args.codes and name not in args.codes:
            continue
        code = get_code(name)
        cycles = code.distance
        circ = SyndromeCircuit(code, num_cycles=cycles)
        key = compute_cache_key(code.Hx, code.Hz, code.Lx, code.Lz, cycles, p)
        M = load_matrices("matrix_cache", key)
        if M is None:
            print(f"building matrices {name} p={p} ...", flush=True)
            M = build_decoding_matrices(circ, code.Lx, code.Lz, p)
            save_matrices("matrix_cache", key, M)
        t0 = time.time()
        res = run_simulation(
            code.Hx, code.Hz, code.Lx, code.Lz, p, num_cycles=cycles,
            maxIter=args.max_iter, osd_order=2, alpha_mode=args.alpha_mode,
            precomputed_matrices=M,
            target_logical_errors=args.target_errors,
            max_trials=args.max_trials, batch_size=args.batch_size,
            base_seed=1234, verbose=False, bp_variant=args.bp_variant,
            ell=code.ell, m=code.m, a_x_powers=code.a_x_powers,
            a_y_powers=code.a_y_powers, b_y_powers=code.b_y_powers,
            b_x_powers=code.b_x_powers, device=device)
        ler = res["logical_error_rate"]
        ne, nt = res["logical_errors"], res["num_trials"]
        sig = np.sqrt(max(ler * (1 - ler) / max(nt, 1), 1e-12))
        ref_sig = np.sqrt(ref_ler * (1 - ref_ler) / ref_tr)
        z = (ler - ref_ler) / np.sqrt(sig**2 + ref_sig**2)
        row = dict(code=name, p=p, alpha_mode=args.alpha_mode,
                   maxIter=args.max_iter, bp_variant=args.bp_variant,
                   ler=ler,
                   errors=ne, trials=nt,
                   ref_ler=ref_ler, z_score=round(float(z), 2),
                   shots_per_sec=round(res["shots_per_sec"], 1),
                   wall_sec=round(time.time() - t0, 1))
        rows.append(row)
        print(json.dumps(row), flush=True)

    with open(args.out, "w") as f:
        json.dump(rows, f, indent=2)
    zs = [abs(r["z_score"]) for r in rows]
    print(f"max |z| = {max(zs):.2f} over {len(rows)} points "
          f"(|z|<3 expected for matching decoders)")
    return rows


if __name__ == "__main__":
    main()
