"""Two processes in one gloo group against one process with two shards.

Counterpart of the JAX package's ``scripts/multihost_smoke.py``, with its
two configurations: ``run_simulation`` on [[72,12,6]], p=0.006, 6 cycles,
maxIter 8, OSD order 1, 32 shots a shard per round, seed 42, to 25 logical
errors, under dynamical alpha and under autoregressive calibration (400
estimation trials). Each configuration runs

1. in this process over a mesh of two shards (``shot_mesh(2)``);
2. in two spawned processes that join one gloo group
   (``distributed_init_from_env(backend="gloo")`` from the ``QLDPC_*``
   variables), one shard each;

and must give the same ``num_trials``, ``logical_errors`` and z and x
error counts in all three, with ``num_devices`` 2, and under calibration
the same post-broadcast ``alpha_seq_*`` on both ranks and in the single
process. The shards' streams depend only on the seed and the shard index,
so the result is a function of the mesh, not of the process layout.

``--device cuda`` runs every process on the card (two processes share it,
so the group is gloo: NCCL refuses two ranks on one GPU); the kernels are
built here first and the children load that build. Prints one JSON line
and exits with status 1 unless every configuration agrees. It writes no
record file (``MULTIHOST.json`` is the JAX package's).

Usage (from the root of a checkout):

    python -m qldpc_tpu_torch.scripts.multihost_smoke [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile

import torch
import torch.distributed as dist

from .. import resolve_device
from ..models.bb import get_code
from ..models.builder import build_decoding_matrices
from ..models.circuit import SyndromeCircuit
from ..parallel.mesh import distributed_init_from_env, shot_mesh

CONFIG = dict(code="[[72, 12, 6]]", error_rate=0.006, num_cycles=6,
              maxIter=8, osd_order=1, batch_size=32, base_seed=42,
              target_logical_errors=25, max_trials=2000,
              alpha_mode="dynamical")
CONFIGS = {
    "dynamical": CONFIG,
    "calibrated": dict(CONFIG, alpha_mode="alvarado-autoregressive",
                       alpha_estimation_trials=400),
}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, out_dir, fn, args):
    os.environ.update(QLDPC_COORDINATOR=f"localhost:{port}",
                      QLDPC_NUM_PROCESSES=str(world),
                      QLDPC_PROCESS_ID=str(rank))
    # the ranks share this host's cores
    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    distributed_init_from_env(backend="gloo")
    try:
        out = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def spawn(fn, world: int, args=()) -> list:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes joined in one
    gloo group over a free localhost port; returns each rank's JSON-able
    result, in rank order. A child that raises makes this raise."""
    with tempfile.TemporaryDirectory() as out_dir:
        torch.multiprocessing.spawn(
            _entry, args=(world, free_port(), out_dir, fn, args),
            nprocs=world, join=True)
        outs = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                outs.append(json.load(f))
        return outs


def summary(res: dict) -> dict:
    """The numbers a run is compared on: trials, errors by basis, shards,
    and the sequences the decoder used."""
    n = res["num_trials"]
    out = dict(num_devices=res["num_devices"], num_trials=n,
               logical_errors=res["logical_errors"],
               z_errors=round(res["z_logical_error_rate"] * n),
               x_errors=round(res["x_logical_error_rate"] * n))
    for b in "zx":
        if f"alpha_seq_{b}" in res:
            out[f"alpha_seq_{b}"] = res[f"alpha_seq_{b}"]
    return out


def run_config(cfg: dict, device, mesh=None) -> dict:
    """run_simulation under ``cfg`` (keys of :data:`CONFIG`), summarised."""
    from ..parallel.engine import run_simulation
    cfg = dict(cfg)
    code = get_code(cfg.pop("code"))
    circ = SyndromeCircuit(code, num_cycles=cfg["num_cycles"])
    M = build_decoding_matrices(circ, code.Lx, code.Lz, cfg["error_rate"])
    res = run_simulation(
        code.Hx, code.Hz, code.Lx, code.Lz, precomputed_matrices=M,
        mesh=mesh, verbose=False, device=device, ell=code.ell, m=code.m,
        a_x_powers=code.a_x_powers, a_y_powers=code.a_y_powers,
        b_y_powers=code.b_y_powers, b_x_powers=code.b_x_powers, **cfg)
    return summary(res)


def _child(rank, names, device) -> dict:
    return {name: run_config(CONFIGS[name], device) for name in names}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from .._kernels import build_all
        build_all()  # once, here: the children load this build
    names = list(CONFIGS)
    single = {nm: run_config(CONFIGS[nm], dev, mesh=shot_mesh(2))
              for nm in names}
    ranks = spawn(_child, 2, (names, args.device))
    verdict = {}
    for nm in names:
        runs = [single[nm]] + [r[nm] for r in ranks]
        verdict[nm] = dict(ok=all(r == runs[0] for r in runs)
                           and runs[0]["num_devices"] == 2,
                           single=single[nm], rank0=ranks[0][nm],
                           rank1=ranks[1][nm])
    out = dict(ok=all(v["ok"] for v in verdict.values()), device=str(dev),
               **verdict)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
