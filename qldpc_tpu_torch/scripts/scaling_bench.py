"""Weak-scaling efficiency of the sharded decode round over a shot mesh.

Counterpart of the JAX package's ``scripts/scaling_bench.py``: one decode
round (``engine.make_round_fn``: p=0.005, maxIter 10, OSD order 1) of
``--batch`` shots a shard, over meshes of each ``--devices`` count of
shards (``parallel.mesh.shard_rounds``), each shard drawing from its own
generator; a mesh's rate is its shots over the synchronised host time of a
round (the mean of ``--reps`` after a warm-up round), and its weak-scaling
efficiency that rate over the one-shard rate times the shard count.

Where the shards run, and so what the efficiency measures, is printed:

* by default every shard is decoded in turn by this one process on one
  card (or the CPU): the efficiency then measures the cost a shard adds to
  a round, not any interconnect;
* ``--processes`` runs each mesh as that many processes in one gloo group
  (``multihost_smoke.spawn``), one shard each, all sharing this machine's
  card: a round there ends with the counts' ``all_reduce``, so the
  efficiency measures the processes' contention for the one card and the
  group's collectives. Collectives over NCCL between GPUs are not measured
  by either (one card).

Usage (from the root of a checkout):

    python -m qldpc_tpu_torch.scripts.scaling_bench [--devices 1 2 4 8]
        [--code "[[72, 12, 6]]"] [--batch 64] [--reps 3] [--processes]
        [--device cuda|cpu] [--cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import resolve_device
from ..parallel import engine
from ..parallel.mesh import generator, read_counts, shard_rounds, shot_mesh
from . import build, card_line

P, MAX_ITER, OSD_ORDER = 0.005, 10, 1
SEED = 0


def make_round(code_name: str, batch: int, device):
    """The benched per-shard round(gen, randoms=None)."""
    circ, _M, (dz, dx) = build(code_name, P, MAX_ITER, OSD_ORDER, device)
    return engine.make_round_fn(dz, dx, circ.num_error_locs, P, batch,
                                MAX_ITER, OSD_ORDER)


def sharded_round(fn, n_shards: int, device) -> tuple:
    """(round over a mesh of ``n_shards`` shards, this process's shard
    generators) for the shards this process holds (every shard without a
    process group)."""
    mesh = shot_mesh(n_shards)
    return (shard_rounds(fn, mesh),
            [generator(SEED, s, device=device) for s in mesh.shards])


def round_seconds(sharded, gens, reps: int, device) -> float:
    """Mean host seconds of a round after one warm-up round: each round's
    counts read (under a process group through their ``all_reduce``), the
    device synchronised."""
    def one():
        read_counts([sharded(gens)])
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    one()  # the first round carries the kernel builds
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        one()
    return (time.perf_counter() - t0) / reps


def _rank_seconds(rank, code_name, batch, reps, device) -> float:
    """One rank of a ``--processes`` mesh: its shard's mean round seconds."""
    dev = resolve_device(device)
    fn = make_round(code_name, batch, dev)
    sharded, gens = sharded_round(fn, None, dev)
    return round_seconds(sharded, gens, reps, dev)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", nargs="*", type=int, default=[1, 2, 4, 8],
                    help="shard counts")
    ap.add_argument("--code", default="[[72, 12, 6]]")
    ap.add_argument("--batch", type=int, default=64, help="shots per shard")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--processes", action="store_true",
                    help="one gloo process a shard, sharing the card")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="--device cpu")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else args.device)
    print(card_line(dev), flush=True)
    where = (f"one gloo process a shard, all on one {dev.type} device: "
             "contention and the group's collectives, no interconnect"
             if args.processes else
             f"every shard decoded in turn by one process on one "
             f"{dev.type} device: the cost a shard adds, no interconnect")
    print(f"{args.code} batch/device={args.batch} ({where})", flush=True)
    # the matrices are cached here, once, before any child reads them
    fn = make_round(args.code, args.batch, dev)
    if args.processes:
        from . import scaling_bench  # the children import it by this name
        from .multihost_smoke import spawn
        if dev.type == "cuda":
            from .._kernels import build_all
            build_all()  # once, here: the children load this build
    base_rate = None
    rows = []
    for nd in args.devices:
        if args.processes:
            dt = max(spawn(scaling_bench._rank_seconds, nd,
                           (args.code, args.batch, args.reps, str(dev))))
        else:
            sharded, gens = sharded_round(fn, nd, dev)
            dt = round_seconds(sharded, gens, args.reps, dev)
        rate = args.batch * nd / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * nd)
        rows.append(dict(devices=nd, shots_per_sec=rate, efficiency=eff))
        print(f"devices={nd}: {rate:10.1f} shots/s  "
              f"weak-scaling efficiency {eff:6.1%}", flush=True)
    return rows


if __name__ == "__main__":
    main()
