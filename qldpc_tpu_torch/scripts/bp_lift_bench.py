"""Lifted-layout BP against generic padded-CSR BP, and kernel K1.

Counterpart of the JAX package's ``scripts/bp_lift_bench.py``: on one set
of syndromes (iid errors from the Z channel, numpy seed 0), the padded-CSR
min-sum decoder (``ops/bp.py::decode_batch``) and the lifted roll decoder
(``ops/bp_lift.py::decode_batch_lift``), each with float32 and bfloat16
messages, and kernel K1 (``ops/bp_lift_cuda.py::decode_batch_lift_cuda``,
float32 messages only). Each line is the mean host ms of ``REPS`` calls
with the device synchronised after each (after a warm-up call), the ms per
iteration (the call over maxIter: every decoder runs maxIter iterations
unless every shot converged) and the share of shots converged.

Usage (from the root of a checkout):

    python -m qldpc_tpu_torch.scripts.bp_lift_bench [code] [p=0.004]
        [batch=512] [maxIter=20] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import channel_llrs, get_code, resolve_device
from ..ops.bp import TannerGraph, alpha_schedule, decode_batch
from ..ops.bp_lift import LiftedGraph, decode_batch_lift
from ..ops.bp_lift_cuda import decode_batch_lift_cuda
from . import card_line, timed
from .bp_breakdown import cached_matrices

REPS = 5
SEED = 0


def decoders(graph, lifted, prior, seq, maxIter: int) -> list:
    """[(name, decode(syndrome))] of the compared decoders."""
    out = []
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        out.append((f"generic decode_batch {tag}",
                    lambda s, d=dt: decode_batch(graph, s, prior, seq,
                                                 maxIter, msg_dtype=d)))
        if lifted is not None:
            out.append((f"lifted  decode_batch {tag}",
                        lambda s, d=dt: decode_batch_lift(
                            lifted, s, prior, seq, maxIter, msg_dtype=d)))
    if lifted is not None:
        out.append(("K1      decode_batch f32",
                    lambda s: decode_batch_lift_cuda(lifted, s, prior, seq,
                                                     maxIter)))
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("code", nargs="?", default="[[144, 12, 12]]")
    ap.add_argument("p", nargs="?", type=float, default=0.004)
    ap.add_argument("batch", nargs="?", type=int, default=512)
    ap.add_argument("maxIter", nargs="?", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B, mi = args.batch, args.maxIter
    print(card_line(dev), flush=True)
    code = get_code(args.code)
    _circ, M = cached_matrices(code, code.distance, args.p)
    H = (np.asarray(M["HdecZ"]) != 0).astype(np.uint8)
    prior_np = channel_llrs(M["channel_probsZ"]).astype(np.float32)
    lifted = LiftedGraph.try_from_dense(H, code.ell, code.m, prior_np,
                                        device=dev)
    print(f"{args.code} p={args.p} B={B} iters={mi} H={H.shape} lift="
          f"{'None' if lifted is None else f'NB={lifted.NB} EB={lifted.EB}'}",
          flush=True)
    graph = TannerGraph.from_dense(H, device=dev)
    prior = torch.as_tensor(prior_np, device=dev)
    seq = torch.as_tensor(alpha_schedule("dynamical", mi), device=dev)
    rng = np.random.default_rng(SEED)
    errors = (rng.random((B, H.shape[1])) < M["channel_probsZ"]).astype(
        np.int64)
    syn = torch.as_tensor((errors @ H.T) % 2, dtype=torch.int8, device=dev)
    rows = []
    for name, decode in decoders(graph, lifted, prior, seq, mi):
        out, ms = timed(name, lambda: decode(syn), REPS, dev, stat="mean")
        conv = float(out["converged"].float().mean())
        rows.append(dict(decoder=name.split()[0], msg=name.split()[-1],
                         ms=ms, ms_per_iter=ms / mi, converged=conv))
        print(f"    {ms / mi:.4f} ms per iteration, converged {conv:.1%}",
              flush=True)
    return rows


if __name__ == "__main__":
    main()
