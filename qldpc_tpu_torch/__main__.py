"""Experiment driver of the port: LER sweeps over BB codes x physical error
rates, on the GPU.

Takes the flags of the JAX package's ``main.py`` plus ``--device``, and
writes the same ``output/run_<ts>/`` artefacts (``results.npz``, plots,
``summary.json``; without matplotlib, no plots and a warning). Codes come
from the built-in registry or from reference-format npz files
(``--codes-dir``).

    python -m qldpc_tpu_torch --codes "[[72, 12, 6]]" --error-rates 0.006
    python -m qldpc_tpu_torch --codes "[[144, 12, 12]]" \\
        --alpha-mode alvarado-autoregressive
    python -m qldpc_tpu_torch --device cpu ...   # the plain versions

Under a ``torch.distributed`` group (``QLDPC_COORDINATOR``,
``QLDPC_NUM_PROCESSES``, ``QLDPC_PROCESS_ID``; NCCL on the card, gloo with
``--device cpu``) every rank runs the sweep over one shot mesh and only
rank 0 writes files.
"""
from __future__ import annotations

import argparse
import json
import logging
import os

from . import CODE_REGISTRY, get_code
from .models.bb import BBCode
from .models.builder import build_decoding_matrices
from .models.circuit import SyndromeCircuit
from .utils.caching import compute_cache_key, load_matrices, save_matrices
from .utils.results import load_results, make_run_dir, save_results

DEFAULT_RATES = [0.006, 0.005, 0.004]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m qldpc_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--codes", nargs="+", default=["[[72, 12, 6]]"],
                   help=f"code names (registry: {list(CODE_REGISTRY)})")
    p.add_argument("--codes-dir", default=None,
                   help="load codes from reference-format npz files here "
                        "instead of the built-in registry")
    p.add_argument("--error-rates", nargs="+", type=float,
                   default=DEFAULT_RATES)
    p.add_argument("--num-cycles", type=int, default=None,
                   help="syndrome cycles (default: code distance)")
    p.add_argument("--target-logical-errors", type=int, default=30)
    p.add_argument("--max-trials", type=int, default=100000)
    p.add_argument("--max-iter", type=int, default=20)
    p.add_argument("--osd-order", type=int, default=2)
    p.add_argument("--alpha-mode", default="dynamical",
                   choices=["dynamical", "alvarado",
                            "alvarado-autoregressive"])
    p.add_argument("--scopt", action="store_true")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--base-seed", type=int, default=None)
    p.add_argument("--cache-dir", default="matrix_cache")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--resume", default=None, metavar="RUN_DIR",
                   help="resume an interrupted sweep: reuse this run dir, "
                        "skip (code, p) points already in its results.npz")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def load_code(name: str, codes_dir):
    if codes_dir:
        return BBCode.load_npz(os.path.join(codes_dir, f"{name}.npz"),
                               name=name)
    return get_code(name)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] %(message)s",
                        datefmt="%H:%M:%S")
    log = logging.getLogger("driver")
    from . import resolve_device
    from .parallel.engine import run_simulation
    from .parallel.mesh import _world, distributed_init_from_env
    try:
        from .utils import plotting
    except ImportError:  # matplotlib is optional: results without figures
        plotting = None
        log.warning("matplotlib is not installed: no plots are written")

    dev = resolve_device(args.device)
    distributed_init_from_env(backend="nccl" if dev.type == "cuda"
                              else "gloo")
    # every rank runs the sweep; only rank 0 touches the filesystem (run
    # dirs, cache writes, checkpoints, plots)
    is_main = _world()[0] == 0
    results = {}
    if args.resume:
        run_dir = args.resume
        est_dir = os.path.join(run_dir, "estimation_plots")
        if is_main:
            os.makedirs(est_dir, exist_ok=True)
        ckpt = os.path.join(run_dir, "results.npz")
        if os.path.exists(ckpt):
            results = load_results(ckpt).get("results", {})
            done = [(c, p) for c, d in results.items() for p in d]
            log.info("resuming %s: %d completed points", run_dir, len(done))
    elif is_main:
        run_dir, est_dir = make_run_dir(args.output_dir)
    else:
        run_dir = est_dir = None

    for name in args.codes:
        code = load_code(name, args.codes_dir)
        short = str(code.n)
        results.setdefault(short, {})
        cycles = args.num_cycles or code.distance or 12
        log.info("=== %s (n=%d, k=%d), %d cycles ===", name, code.n, code.k,
                 cycles)
        circ = SyndromeCircuit(code, num_cycles=cycles)
        for p in args.error_rates:
            if p in results[short]:
                log.info("  p=%g already completed (resume) — skipping", p)
                continue
            key = compute_cache_key(code.Hx, code.Hz, code.Lx, code.Lz,
                                    cycles, p)
            matrices = load_matrices(args.cache_dir, key)
            if matrices is None:
                log.info("building decoding matrices for p=%g ...", p)
                matrices = build_decoding_matrices(circ, code.Lx, code.Lz, p)
                if is_main:
                    save_matrices(args.cache_dir, key, matrices)
            res = run_simulation(
                code.Hx, code.Hz, code.Lx, code.Lz, p, num_cycles=cycles,
                maxIter=args.max_iter, osd_order=args.osd_order,
                precomputed_matrices=matrices, alpha_mode=args.alpha_mode,
                target_logical_errors=args.target_logical_errors,
                max_trials=args.max_trials, scopt=args.scopt,
                estimation_plot_dir=(est_dir if is_main and plotting
                                     else None),
                base_seed=args.base_seed, batch_size=args.batch_size,
                device=dev,
                ell=getattr(code, "ell", None), m=getattr(code, "m", None),
                a_x_powers=getattr(code, "a_x_powers", None),
                a_y_powers=getattr(code, "a_y_powers", None),
                b_y_powers=getattr(code, "b_y_powers", None),
                b_x_powers=getattr(code, "b_x_powers", None),
            )
            results[short][p] = res
            # checkpoint after every point, so --resume RUN_DIR continues
            if is_main:
                save_results(run_dir, results, {})
            log.info("  p=%g LER=%.4e (trials=%d, errors=%d, %.0f shots/s)",
                     p, res["logical_error_rate"], res["num_trials"],
                     res["logical_errors"], res["shots_per_sec"])

    if not is_main:
        return
    alpha_r2 = {}
    if plotting is not None:
        plotting.plot_simulation_results(
            results, os.path.join(run_dir, "simulation_results.png"))
        if args.alpha_mode == "alvarado-autoregressive":
            plotting.plot_alpha_comparison(
                results, os.path.join(run_dir, "alpha_comparison.png"))
            alpha_r2 = plotting.plot_alpha_linearity(
                results, os.path.join(run_dir, "alpha_linearity.png"))
    save_results(run_dir, results, alpha_r2)
    summary = {c: {p: {"ler": r["logical_error_rate"],
                       "trials": r["num_trials"],
                       "shots_per_sec": round(r["shots_per_sec"], 1)}
                   for p, r in d.items()} for c, d in results.items()}
    with open(os.path.join(run_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    print(f"Results saved to {run_dir}")


if __name__ == "__main__":
    main()
