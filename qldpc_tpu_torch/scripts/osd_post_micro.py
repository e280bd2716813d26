"""Micro-timings of the OSD's post-elimination ops at the production
shapes, on synthetic inputs.

Counterpart of the JAX package's ``scripts/osd_post_micro.py``: the same
ops at the same shapes (defaults B=512, m=1008, n=8785, K=1280, R=930:
[[144,12,12]]'s stage-1 batch with the column basis appended), each as
``ops/osd.py`` and ``ops/osd_cuda.py`` compute it:

* the OSD-0 correction as the JAX script forms it (a take-along of the
  reduced syndrome by each column's pivot row) and as the port forms it (a
  scatter of the reduced syndrome by each row's pivot column);
* the pivot-row inversion (a scatter (B, M) -> (B, KT+1));
* the logical gather (n,) -> (B, KT) with its XOR reduction;
* the unsatisfied-row sums, twice;
* the full stable sort of |LLR| (B, n) and the top-K of -|LLR|.

Each line is the host's median ms of a call whose outputs are summed on
the device and read back (so it includes the fixed per-call floor), that
ms less the no-op dispatch's (the JAX script's diff), and the device's ms a
call between CUDA events over ``REPS`` calls. On the CPU both are host
times.

Usage (from the root of a checkout):

    python -m qldpc_tpu_torch.scripts.osd_post_micro [B] [m] [n] [K] [R]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..ops.osd import _xor_reduce
from ..ops.osd_cuda import prow_of_col_from
from . import card_line, device_ms, wall_ms

REPS = 10
SEED = 0


def inputs(B: int, m: int, n: int, K: int, R: int, device) -> dict:
    """The JAX script's synthetic tensors (numpy seed 0, its draw order),
    on ``device``."""
    M = -(-m // 128) * 128
    KT = K + R
    rng = np.random.default_rng(SEED)
    arrays = dict(
        s_red=rng.integers(0, 2, (B, M)),
        prow=rng.integers(-1, M, (B, KT)),
        colofrow=rng.integers(-1, KT, (B, M)),
        used=rng.random((B, M)) < 0.9,
        colsE=rng.integers(0, n, (B, KT)),
        lp=rng.integers(0, 1 << 12, (n,)),
        e_perm=rng.integers(0, 2, (B, KT)))
    out = {k: torch.as_tensor(v if v.dtype == bool else v.astype(np.int32),
                              device=device) for k, v in arrays.items()}
    out["llr"] = torch.as_tensor(rng.normal(size=(B, n)).astype(np.float32),
                                 device=device)
    out.update(B=B, M=M, KT=KT, K=K)
    return out


def ops(x: dict) -> list:
    """[(name, fn() -> tensors)] of the timed ops, the no-op first."""
    B, KT, K = x["B"], x["KT"], x["K"]
    s, prow, cf, used = x["s_red"], x["prow"], x["colofrow"], x["used"]
    i32 = torch.int32

    def e0_scatter():
        tgt = torch.where(used & (cf >= 0), cf.long(), KT)
        return torch.zeros((B, KT + 1), dtype=i32, device=s.device
                           ).scatter_(1, tgt, s)[:, :KT]

    return [
        ("noop floor", lambda: s[:4, :4]),
        ("e0 take_along (B,KT)<-(B,M) lanes",
         lambda: s.gather(1, prow.clamp(min=0).long())),
        ("e0 scatter (B,M)->(B,KT+1) (the port's)", e0_scatter),
        ("prow inversion scatter (B,M)->(B,KT+1)",
         lambda: prow_of_col_from(torch.where(used, cf, -1), KT)),
        ("logical gather (n,)->(B,KT) + xor reduce",
         lambda: _xor_reduce(torch.where(x["e_perm"] > 0,
                                         x["lp"][x["colsE"].long()], 0))),
        ("unsat row sums x2",
         lambda: (torch.where(~used, s, 0).sum(1),
                  torch.where(used, s, 0).sum(1))),
        ("argsort full (B,n) f32 (stable)",
         lambda: torch.sort(x["llr"].abs(), dim=1, stable=True).indices),
        ("top-K of -|llr| (B,K)",
         lambda: torch.topk(-x["llr"].abs(), K, dim=1).indices),
    ]


def _reduced(fn):
    """``fn`` with its outputs summed to one device scalar."""
    def run():
        out = fn()
        out = out if isinstance(out, tuple) else (out,)
        return sum(o.to(torch.float32).sum() for o in out)
    return run


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for name, default in (("B", 512), ("m", 1008), ("n", 8785), ("K", 1280),
                          ("R", 930)):
        ap.add_argument(name, nargs="?", type=int, default=default)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    x = inputs(args.B, args.m, args.n, args.K, args.R, dev)
    print(f"B={args.B} m={args.m} (M={x['M']}) n={args.n} K={args.K} "
          f"R={args.R} (KT={x['KT']})", flush=True)
    out, floor = {}, None
    for name, fn in ops(x):
        run = _reduced(fn)
        host = wall_ms(lambda: float(run()), REPS, dev)
        floor = host if floor is None else floor
        dev_ms = device_ms(run, REPS, dev)
        out[name] = dict(host_ms=host, minus_floor_ms=host - floor,
                         device_ms=dev_ms)
        print(f"{name:48s} {host:9.3f} ms  (-floor {host - floor:8.3f}; "
              f"device {dev_ms:8.3f})", flush=True)
    return out


if __name__ == "__main__":
    main()
