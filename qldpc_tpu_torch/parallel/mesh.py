"""Shot-axis data parallelism over a ``torch.distributed`` process group.

Counterpart of the JAX package's ``parallel/mesh.py`` (a 1-D ``Mesh`` over
every device with the Monte-Carlo shot axis sharded by ``shard_map``),
written the PyTorch way: one process per GPU, collectives between the
processes, and a shot axis made of *shards*.

- ``distributed_init_from_env()`` joins the process group that the
  ``QLDPC_COORDINATOR`` (host:port), ``QLDPC_NUM_PROCESSES`` and
  ``QLDPC_PROCESS_ID`` variables describe (the JAX package's names), with
  a backend that defaults to NCCL; the CPU, or several processes sharing
  one card, ask for gloo. Without the variables it does nothing and
  returns False.
- ``shot_mesh(n_shards)`` covers the whole group (or the lone process): by
  default one shard per rank. A process may hold several shards, which it
  decodes one after another; on the CPU that gives a test the "virtual
  devices" JAX gets from ``--xla_force_host_platform_device_count``. Shard
  ``s`` of a run decodes ``batch`` shots per round from a generator of its
  own (:func:`stream_seed`), and a round's flags are in shard-major order:
  shard ``s``'s shots at ``[s*n, (s+1)*n)``, as JAX's shot-sharded layout
  puts device ``d``'s.
- ``shard_rounds`` adds ``<flag>_count`` for every flag of ``COUNT_KEYS``
  that the round returns (a circuit-level round its error, convergence,
  rank and OSD-overflow flags, a code-capacity round ``fail`` and
  ``conv``): this process's sum over its shards, a 0-d device tensor, so
  that a dispatch reads nothing back. ``read_counts`` turns the counts of
  a consumed round into the group's totals: one ``all_reduce`` of one
  vector holding every stream's counts, and one host read. Steady rounds
  of the engine's stopping loop read only these totals.
- ``gather_flags`` ``all_gather``s the per-shot flags in shard order;
  the engine calls it only in a round that crosses its error target or is
  cut by ``max_trials``.

Every rank executes the same loop on the same reduced counts, so the host
state (trials, errors, round index) stays identical across ranks; the
engine broadcasts the base seed and the fitted alpha sequences from rank 0.
JAX's ``replicate`` has no counterpart here: each process builds its own
decoder bundles from the same matrices and the broadcast seed, so nothing
large crosses the group.

Collectives run on the CPU under gloo (the counts and flags are copied to
the host first, when the loop consumes the round; it reads them there
anyway) and on the rank's GPU under NCCL. They run whenever the process
group is initialised, also in a group of one rank.
"""
from __future__ import annotations

import dataclasses
import os
import socket
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device

# the flags whose whole-round totals cross the group as counts (the
# engine's steady-state loop reads only these) and that a crossing round
# gathers shot by shot; a round is counted on the ones it returns
COUNT_KEYS = ("any_err", "z_err", "x_err", "z_rankdef", "x_rankdef",
              "osd_overflow", "fail", "conv")


def distributed_init_from_env(backend: str = "nccl") -> bool:
    """Join the process group described by ``QLDPC_COORDINATOR``,
    ``QLDPC_NUM_PROCESSES`` and ``QLDPC_PROCESS_ID``; returns True when it
    did, False (and does nothing) when the variables are unset.

    ``backend``: ``"nccl"`` (the default: every entry point runs on the
    card) or ``"gloo"``, which the CPU, and several processes sharing one
    card, ask for. NCCL needs a GPU of its own for each rank of a host:
    without a GPU, or with more ranks on this host than visible GPUs, it
    raises, and a rank's GPU is its index among this host's ranks. The
    backend is never switched silently."""
    coord = os.environ.get("QLDPC_COORDINATOR")
    if not coord:
        return False
    world = int(os.environ["QLDPC_NUM_PROCESSES"])
    rank = int(os.environ["QLDPC_PROCESS_ID"])
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("backend='nccl' needs a CUDA GPU and none is "
                           "visible; pass backend='gloo' for the CPU")
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            world_size=world, rank=rank)
    if backend == "nccl":
        # which ranks share this host: gathered over a side gloo group, so
        # that no NCCL collective runs before each rank has its own GPU
        host = socket.gethostname()
        hosts = [None] * world
        side = dist.new_group(backend="gloo")
        dist.all_gather_object(hosts, host, group=side)
        dist.destroy_process_group(side)
        local, gpus = hosts.count(host), torch.cuda.device_count()
        if local > gpus:
            dist.destroy_process_group()
            raise RuntimeError(
                f"backend='nccl' needs one GPU per rank: {local} ranks on "
                f"{host} and {gpus} visible GPU(s); several processes "
                "sharing a card need backend='gloo'")
        torch.cuda.set_device(hosts[:rank].count(host))
    return True


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _world() -> tuple:
    """(rank, world size) of the default process group, (0, 1) without
    one."""
    if _distributed():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _comm_device() -> torch.device:
    """Where a collective's tensors live: the rank's GPU under NCCL, the
    host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class ShotMesh:
    """The shot axis: ``n_shards`` shards over the process group, of which
    this process decodes ``shards`` (a contiguous run, rank-major)."""

    n_shards: int
    shards: tuple


def shot_mesh(n_shards: Optional[int] = None) -> ShotMesh:
    """A mesh over the whole process group (the lone process without one):
    ``n_shards`` (default: the world size) must be a multiple of the world
    size; rank r holds shards ``[r*n/w, (r+1)*n/w)``."""
    rank, world = _world()
    n = world if n_shards is None else int(n_shards)
    if n < 1 or n % world:
        raise ValueError(f"n_shards={n} is not a positive multiple of the "
                         f"world size {world}")
    per = n // world
    return ShotMesh(n_shards=n, shards=tuple(range(rank * per,
                                                 (rank + 1) * per)))


def stream_seed(base_seed: int, *path: int) -> int:
    """Seed of one generator of a run, from the base seed and a path of
    non-negative indices (shard, code). The all-zero path is the base seed
    itself, so shard 0 of code 0 draws the stream a run without a mesh
    draws; any other path goes through ``np.random.SeedSequence`` (the
    counterpart of JAX's ``fold_in``)."""
    if not any(path):
        return int(base_seed)
    state = np.random.SeedSequence([int(base_seed), *map(int, path)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(base_seed: int, *path: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with
    :func:`stream_seed`."""
    gen = torch.Generator(device=resolve_device(device))
    return gen.manual_seed(stream_seed(base_seed, *path))


def broadcast_from_rank0(values: np.ndarray) -> np.ndarray:
    """``values`` as rank 0 has them, on every rank (unchanged without a
    process group); the dtype and shape must agree across ranks."""
    if not _distributed():
        return values
    t = torch.as_tensor(np.ascontiguousarray(values)).to(_comm_device())
    dist.broadcast(t, src=0)
    return t.cpu().numpy()


def shard_rounds(round_fn: Callable, mesh: ShotMesh) -> Callable:
    """Wrap a per-shard decode round into a round over the mesh.

    ``round_fn(gen, randoms=None)`` -> a dict of (n,) per-shot flag tensors,
    or a list of such dicts (one per stream: the codes of a multi-code
    round). Returns ``sharded(gens, randoms=None, **kw)``, with ``gens``
    (and ``randoms``) one entry per shard of this process and ``kw`` passed
    to every ``round_fn`` call. The result has the same structure; its
    flags are this process's shards concatenated in shard order, and each
    dict gains ``<flag>_count`` (a 0-d int64 device tensor: this process's
    total; :func:`read_counts` gives the group's) for the flags of
    ``COUNT_KEYS`` it holds. Nothing is read back to the host."""
    def sharded(gens, randoms=None, **kw):
        if len(gens) != len(mesh.shards):
            raise ValueError(f"{len(gens)} generators for "
                             f"{len(mesh.shards)} shards")
        outs = [round_fn(g, randoms=None if randoms is None else randoms[j],
                         **kw)
                for j, g in enumerate(gens)]
        multi = isinstance(outs[0], (list, tuple))
        streams = list(zip(*outs)) if multi else [outs]
        merged = [_merge_counted(parts) for parts in streams]
        return merged if multi else merged[0]

    return sharded


def _merge_counted(parts) -> dict:
    """One stream's flags over this process's shards, with this process's
    counts of the ``COUNT_KEYS`` flags it holds as device tensors (views of
    one vector); no host read."""
    flags = (dict(parts[0]) if len(parts) == 1 else
             {k: torch.cat([p[k] for p in parts]) for k in parts[0]})
    keys = [k for k in COUNT_KEYS if k in flags]
    if not keys:
        return flags
    local = torch.stack([flags[k].sum(dtype=torch.int64) for k in keys])
    flags.update({f"{k}_count": local[i] for i, k in enumerate(keys)})
    return flags


def read_counts(streams) -> list:
    """The group's totals of a consumed round: for each stream's flag dict
    (from :func:`shard_rounds`), ``{<flag>_count: int}`` over every shard of
    the group. Every stream's counts travel as one vector: one
    ``all_reduce`` under a process group (every rank consumes the same
    rounds in the same order, so the collectives match) and one host
    read."""
    keys = [[k for k in COUNT_KEYS if f"{k}_count" in o] for o in streams]
    parts = [o[f"{k}_count"].reshape(1) for o, ks in zip(streams, keys)
             for k in ks]
    if not parts:
        return [{} for _ in streams]
    total = torch.cat(parts)
    if _distributed():
        total = total.to(_comm_device())
        dist.all_reduce(total)
    values = iter(total.tolist())
    return [{f"{k}_count": next(values) for k in ks} for ks in keys]


def gather_flags(flags: dict) -> dict:
    """The same keys as numpy bool arrays over every shard of the group,
    in shard order (the shards are rank-major, so rank order is shard
    order). Under a process group the flags travel as one ``all_gather``
    of a (keys, n) uint8 tensor; every rank must call it in the same
    round."""
    keys = list(flags)
    local = torch.stack([flags[k].to(torch.uint8) for k in keys])
    if _distributed():
        local = local.to(_comm_device())
        parts = [torch.empty_like(local)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(parts, local)
        local = torch.cat(parts, dim=1)
    host = local.cpu().numpy().astype(bool)
    return dict(zip(keys, host))
