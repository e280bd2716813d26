"""Where an iteration of the PyTorch-op BP decoders goes.

Counterpart of the JAX package's ``scripts/bp_microbench.py``, on the
port's two PyTorch-op decoders: [[144,12,12]] at p=0.004 (its distance in
cycles), basis Z, 512 shots of iid channel errors (numpy seed 0), maxIter
20, as the JAX script. Variants of the padded-CSR decoder (``ops/bp.py``):

* the full ``decode_batch`` (float32; one host read an iteration for its
  exit, shots frozen at convergence);
* a plain loop of check and variable updates, no syndrome check, no
  freeze, no host read (the JAX script's fixed loop);
* the same with the syndrome check; and with a host read an iteration
  (the JAX script's while loop);
* the plain loop with a float32 extrinsic update instead of the float64
  fused one (``ops/bp.py::_fused_sub``, which makes the port equal JAX's
  XLA bit for bit);
* the plain loop with the column sum as a one-hot bfloat16 matmul (no
  gather), and the JAX script's ``isolate_parts``: the check update alone,
  and a trivial R with the variable update;

and of the roll decoder (``ops/bp_lift.py::decode_batch_lift``, the damped
path's): float32 and bfloat16 at damping 1, damping 0.8 (its float64
fused update), and each without its host read (``exit_check=False``).
Kernel K1 (``decode_batch_lift_cuda``) on the same syndromes is the
yardstick.

Each line is the mean host ms of ``REPS`` calls with the device
synchronised after each, and the ms an iteration. On the card each
PyTorch-op line also gives, from ``torch.profiler`` over one call, the
kernels launched an iteration and the device's busy ms an iteration (the
profiler does not see K1, which its own library launches). The three
costs of an iteration are then split: the launches (the loop's or the
decoder's wall less its device busy time, without the host read), the
float64 fused update (fused less float32 loop; the roll decoder's damped
less undamped) and the host read (loop with the read less without; the
roll decoder with less without ``exit_check``).

Usage (from the root of a checkout):

    python -m qldpc_tpu_torch.scripts.bp_microbench [code] [p=0.004]
        [batch=512] [maxIter=20] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import channel_llrs, get_code, resolve_device
from ..ops import bp as tbp
from ..ops.bp import TannerGraph, alpha_schedule, decode_batch
from ..ops.bp_lift import LiftedGraph, decode_batch_lift
from ..ops.bp_lift_cuda import decode_batch_lift_cuda
from . import card_line, timed
from .bp_breakdown import cached_matrices

REPS = 5
SEED = 0


def csr_loop(graph, syndrome, prior, seq, maxIter: int, check=False,
             host_read=False, fused=True, onehot=None, part="full"):
    """``maxIter`` padded-CSR min-sum iterations (no freeze), with the
    options of the module's variants: ``check`` the syndrome check,
    ``host_read`` a read of the converged flags an iteration (the exit
    test), ``fused`` the float64 fused extrinsic update, ``onehot`` a
    (n, m*dr) one-hot matrix for the column sum, ``part`` "check" for the
    check update alone or "trivial" for a trivial R with the variable
    update. Returns the final row messages."""
    syn, sgn, prior, mask3, Q = tbp._initial(graph, syndrome, prior,
                                             torch.float32)
    index = tbp._edge_index(graph)
    big = torch.tensor(tbp._BIG, dtype=torch.float32, device=Q.device)
    done = torch.zeros(syn.shape[1], dtype=torch.bool, device=Q.device)
    for it in range(maxIter):
        if host_read and bool(done.all()):
            break
        if part == "trivial":
            R, parts = Q * seq[it], None
        else:
            R, *parts = tbp._check_update(Q, sgn, seq[it], parts=True)
        if part == "check":
            Q = torch.where(mask3, R, big)
            continue
        if onehot is not None:
            Rm = torch.where(mask3, R, 0.0).reshape(-1, R.shape[-1])
            values = prior[:, None] + (onehot @ Rm.to(torch.bfloat16)
                                       ).to(torch.float32)
            vals_rows = values.index_select(0, index[1]).reshape(R.shape)
            Qn = vals_rows - R
        else:
            _, Qn, vals_rows = tbp._variable_update(
                R, prior, graph, index, parts if fused and parts else None)
        Q = torch.where(mask3, torch.clamp(Qn, -20.0, 20.0), big)
        if check:
            done = done | tbp._converged(vals_rows, graph, syn)
    return Q


def onehot_matrix(graph, device):
    """(n, m*dr) bfloat16: 1 where row slot e holds column j."""
    rc = graph.row_cols.reshape(-1)
    mk = graph.row_mask.reshape(-1)
    A = torch.zeros((graph.n, rc.numel()), dtype=torch.bfloat16,
                    device=device)
    A[rc[mk].to(A.device), torch.nonzero(mk).flatten().to(A.device)] = 1.0
    return A


def device_profile(fn, device):
    """(kernels launched, device busy ms) over one call of ``fn`` under
    ``torch.profiler``; (None, None) on the CPU."""
    if device.type != "cuda":
        return None, None
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize(device)
    launches, busy_us = 0, 0.0
    for ev in prof.events():
        if ev.device_type is not None and str(ev.device_type).endswith(
                "CUDA"):
            launches += 1
            busy_us += ev.time_range.elapsed_us()
    return launches, busy_us / 1e3


def variants(graph, lifted, syn, prior, seq, mi: int, device) -> list:
    """[(name, fn)] of the timed decoders and loops."""
    out = [("csr full decode_batch f32",
            lambda: decode_batch(graph, syn, prior, seq, mi)),
           ("csr loop, no check, no freeze",
            lambda: csr_loop(graph, syn, prior, seq, mi)),
           ("csr loop, with syndrome check",
            lambda: csr_loop(graph, syn, prior, seq, mi, check=True)),
           ("csr loop, check + host read",
            lambda: csr_loop(graph, syn, prior, seq, mi, check=True,
                             host_read=True)),
           ("csr loop, float32 update",
            lambda: csr_loop(graph, syn, prior, seq, mi, fused=False))]
    onehot = onehot_matrix(graph, device)
    out += [("csr loop, col-sum as one-hot matmul",
             lambda: csr_loop(graph, syn, prior, seq, mi, onehot=onehot)),
            ("csr loop, check update only",
             lambda: csr_loop(graph, syn, prior, seq, mi, part="check")),
            ("csr loop, trivial R + var update",
             lambda: csr_loop(graph, syn, prior, seq, mi, part="trivial"))]
    if lifted is not None:
        for label, kw in (("f32", {}),
                          ("bf16", dict(msg_dtype=torch.bfloat16)),
                          ("damped 0.8", dict(damping=0.8)),
                          ("damped 0.8 bf16", dict(damping=0.8,
                                                   msg_dtype=torch.bfloat16))):
            for exit_check in (True, False):
                tag = "" if exit_check else ", no host read"
                out.append((f"roll decode_batch_lift {label}{tag}",
                            lambda kw=kw, ec=exit_check: decode_batch_lift(
                                lifted, syn, prior, seq, mi,
                                exit_check=ec, **kw)))
        out.append(("K1 decode_batch_lift_cuda f32",
                    lambda: decode_batch_lift_cuda(lifted, syn, prior, seq,
                                                   mi)))
    return out


def split(rows: dict, mi: int) -> dict:
    """The three costs of an iteration, ms, from the variants' rows."""
    def it(name):
        return rows[name]["ms"] / mi if name in rows else None

    def diff(a, b):
        return None if it(a) is None or it(b) is None else it(a) - it(b)

    plain = rows["csr loop, no check, no freeze"]
    out = dict(
        csr_launch_ms=(None if plain["busy_ms"] is None
                       else (plain["ms"] - plain["busy_ms"]) / mi),
        csr_launches=(None if plain["launches"] is None
                      else plain["launches"] / mi),
        csr_float64_update_ms=diff("csr loop, no check, no freeze",
                                   "csr loop, float32 update"),
        csr_host_read_ms=diff("csr loop, check + host read",
                              "csr loop, with syndrome check"))
    roll = rows.get("roll decode_batch_lift f32, no host read")
    if roll is not None:
        out.update(
            roll_launch_ms=(None if roll["busy_ms"] is None
                            else (roll["ms"] - roll["busy_ms"]) / mi),
            roll_launches=(None if roll["launches"] is None
                           else roll["launches"] / mi),
            roll_float64_update_ms=diff(
                "roll decode_batch_lift damped 0.8, no host read",
                "roll decode_batch_lift f32, no host read"),
            roll_host_read_ms=diff(
                "roll decode_batch_lift f32",
                "roll decode_batch_lift f32, no host read"),
            k1_ms=it("K1 decode_batch_lift_cuda f32"))
    return out


def main(argv=None) -> dict:
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
    graph = TannerGraph.from_dense(H, device=dev)
    prior = torch.as_tensor(prior_np, device=dev)
    seq = torch.as_tensor(alpha_schedule("dynamical", mi), device=dev)
    rng = np.random.default_rng(SEED)
    errors = (rng.random((B, H.shape[1])) < M["channel_probsZ"]).astype(
        np.int64)
    syn = torch.as_tensor((errors @ H.T) % 2, dtype=torch.int8, device=dev)
    print(f"{args.code} p={args.p} B={B} iters={mi} H={H.shape} "
          f"dr={graph.dr} dc={graph.dc}", flush=True)
    rows = {}
    for name, fn in variants(graph, lifted, syn, prior, seq, mi, dev):
        _, ms = timed(name, fn, REPS, dev, stat="mean", width=52)
        launches, busy = ((None, None) if name.startswith("K1")
                          else device_profile(fn, dev))
        rows[name] = dict(ms=ms, launches=launches, busy_ms=busy)
        prof = ("" if launches is None else
                f", {launches / mi:.1f} launches and {busy / mi:.4f} ms "
                f"device busy an iteration")
        print(f"    {ms / mi:.4f} ms an iteration{prof}", flush=True)
    parts = split(rows, mi)
    print("an iteration: " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in parts.items()), flush=True)
    return dict(rows=rows, split=parts)


if __name__ == "__main__":
    main()
