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

``--layered`` is the JAX package's ``scripts/bp288_layered_lift_probe.py``
(defaults [[288,12,18]], p=0.005, batch 64, maxIter 20; Z syndromes of
one ``trial_batch``, seed 0): the PyTorch-op layered lift
(``decode_batch_lift_layered``), kernel K3 at the same shape (which runs
[[288]] from shared memory, where the JAX layered kernel did not compile)
and K1's flooding, each with its converged shots, then the OSD of the
flooding-failed shots (``engine._osd_fallback``) and the JAX probe's
break-even arithmetic from these numbers: a layered schedule pays
2 * maxIter * ms_per_sweep of BP a round (both bases) and saves
2 * osd_ms * (unconverged_flooding - unconverged_layered) /
unconverged_flooding of OSD.

Usage (from the root of a checkout):

    python -m qldpc_tpu_torch.scripts.bp_lift_bench [code] [p=0.004]
        [batch=512] [maxIter=20] [--device cuda|cpu]
    python -m qldpc_tpu_torch.scripts.bp_lift_bench --layered [code]
        [p=0.005] [batch=64] [maxIter=20] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import channel_llrs, get_code, resolve_device
from ..ops.bp import TannerGraph, alpha_schedule, decode_batch
from ..ops.bp_lift import (LiftedGraph, decode_batch_lift,
                           decode_batch_lift_layered)
from ..ops.bp_lift_cuda import decode_batch_lift_cuda
from ..ops.bp_lift_layered_cuda import decode_batch_lift_layered_cuda
from ..ops.sampler import trial_batch
from . import build, card_line, timed
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


def layered(code_name: str, p: float, B: int, mi: int, device) -> dict:
    """``--layered``: the three decoders' ms, ms a sweep or iteration and
    converged shots, the OSD's ms, and the break-even arithmetic."""
    from ..parallel.engine import _osd_fallback
    circ, _M, (dz,) = build(code_name, p, mi, 2, device, which="Z")
    gen = torch.Generator(device=device).manual_seed(SEED)
    syn = trial_batch(gen, p, dz.maps, dz.maps, circ.num_error_locs,
                      B)["syndrome_z"]
    print(f"{code_name} p={p} B={B} maxIter={mi} H={tuple(dz.H.shape)} "
          f"lift NB={dz.lifted.NB} EB={dz.lifted.EB}", flush=True)
    args = (dz.lifted, syn, dz.prior, dz.alpha_seq, mi)
    out = {}
    for name, fn in (("layered lift (PyTorch ops)", decode_batch_lift_layered),
                     ("K3 layered", decode_batch_lift_layered_cuda),
                     ("K1 flooding", decode_batch_lift_cuda)):
        res, ms = timed(name, lambda: fn(*args), REPS, device, stat="mean")
        conv = int(res["converged"].sum())
        out[name] = dict(ms=ms, ms_per_iter=ms / mi, converged=conv,
                         result=res)
        print(f"    {ms / mi:.4f} ms a sweep (iteration), converged "
              f"{conv}/{B}", flush=True)
    flood = out["K1 flooding"]["result"]
    chunk = B if B <= 64 else max(64, B // 8)
    _, osd_ms = timed("OSD of the flooding-failed shots",
                      lambda: _osd_fallback(syn, flood["values"],
                                            flood["hard"],
                                            flood["converged"], dz, 2, chunk),
                      REPS, device, stat="mean")
    un_f = B - out["K1 flooding"]["converged"]
    for name in ("layered lift (PyTorch ops)", "K3 layered"):
        un_l = B - out[name]["converged"]
        saves = 2 * osd_ms * (un_f - un_l) / un_f if un_f else 0.0
        pays = 2 * mi * out[name]["ms_per_iter"]
        out[name].update(pays_ms=pays, saves_ms=saves)
        print(f"{name}: pays 2 * {mi} * {out[name]['ms_per_iter']:.4f} = "
              f"{pays:.2f} ms of BP a round, saves 2 * {osd_ms:.2f} * "
              f"({un_f} - {un_l}) / {un_f} = {saves:.2f} ms of OSD; "
              f"break-even at {saves / (2 * mi):.4f} ms a sweep", flush=True)
    for r in out.values():
        r.pop("result")
    out["osd_ms"] = osd_ms
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layered", action="store_true",
                    help="the [[288]] layered row (the JAX package's "
                         "scripts/bp288_layered_lift_probe.py)")
    ap.add_argument("code", nargs="?", default=None)
    ap.add_argument("p", nargs="?", type=float, default=None)
    ap.add_argument("batch", nargs="?", type=int, default=None)
    ap.add_argument("maxIter", nargs="?", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.layered:
        print(card_line(dev), flush=True)
        return layered(args.code or "[[288, 12, 18]]", args.p or 0.005,
                       args.batch or 64, args.maxIter, dev)
    args.code = args.code or "[[144, 12, 12]]"
    args.p = args.p or 0.004
    args.batch = args.batch or 512
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
