"""Decode the reference-sampled trials with the port: the ``ourdecode``
phase of the JAX package's ``scripts/ler_oracle.py``.

``scripts/oracle_data/`` holds trials that the reference's own sampler
drew (syndromes and true logicals of both bases) and, beside each file,
the JAX package's per-trial error flags for them (``*_ourdecode_mi20.npz``
and ``_mi50.npz``, its float32 XLA path on the CPU). This script decodes
the same syndromes with the port's ``engine._decode_one_basis`` (dynamical
alpha, OSD order ``--osd-order``, 256 trials a call; kernels K1, G1 and
the eliminator on the card), prints the JAX script's result line and,
beside it, the comparison with the committed flags: their LER and the z of
the difference, per basis the disagreeing trials, and the trials whose OSD
reprocess slice overflowed (their batch was decoded again with whole
chunks).

The matrices are built from ``codes/<code>.npz`` (Hx, Hz and the BB
polynomials) with the logical operators in CSS standard form
(``models.gf2.css_standard_form_logicals``): the basis in which the
reference recorded ``true_z`` and ``true_x``. The logicals stored in
``codes/*.npz`` are another basis of the same operators, against which
nearly every trial reads as an error (``load_code(name, "codes")``). The
data files are read with numpy; nothing of the JAX package is imported.
The ``sample`` and ``refdecode`` phases run the reference's own code and
have no counterpart.

``basis`` is the evidence for that basis: on the trials whose BP
converges, the decoded final data-qubit frame (each fault class's frame,
from the builder's propagation with the identity as the logical rows) is
regressed over GF(2) against each recorded true bit. It prints the rank
of the frames (full rank: the operator is unique), the share of those
trials each recovered operator predicts, and whether the operators equal
the standard form and the stored basis.

Usage (from the root of a checkout):

    python -m qldpc_tpu_torch.scripts.ler_oracle ourdecode \\
        --code "[[90, 8, 10]]" --cycles 10 --p 0.004 [--max-iter 20 50] \\
        [--osd-order 2] [--first N] [--flags-out DIR] [--device cuda|cpu]
    python -m qldpc_tpu_torch.scripts.ler_oracle basis \\
        --code "[[90, 8, 10]]" --cycles 10 --p 0.004 [--first 2000] \\
        [--max-iter 50] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..models import gf2
from ..models.bb import make_code
from ..ops.bp import alpha_schedule
from ..ops import osd_cuda
from ..parallel.engine import _bp_one_basis, _decode_one_basis, _make_basis
from . import card_line
from .bp_breakdown import cached_matrices

ROOT = Path(__file__).resolve().parents[2]
DATA_DIR = ROOT / "scripts" / "oracle_data"
CODES_DIR = ROOT / "codes"
BATCH = 256
BB_KEYS = ("ell", "m", "a_x_powers", "a_y_powers", "b_y_powers",
           "b_x_powers")


def data_path(name: str, cycles: int, p: float) -> Path:
    """The trials file of a code, cycle count and rate (the JAX script's
    naming)."""
    tag = name.replace(" ", "").replace(",", "_")
    return DATA_DIR / f"trials_{tag}_c{cycles}_p{p:g}.npz"


def record_path(name: str, cycles: int, p: float, max_iter: int) -> Path:
    """The JAX package's per-trial flags of that file at ``max_iter``."""
    path = data_path(name, cycles, p)
    return path.with_name(path.stem + f"_ourdecode_mi{max_iter}.npz")


def load_code(name: str, logicals: str = "standard"):
    """The code of ``codes/<name>.npz`` with its logical operators in CSS
    standard form (``"standard"``) or as the file stores them
    (``"codes"``)."""
    d = np.load(CODES_DIR / f"{name}.npz")
    if logicals == "standard":
        Lx, Lz = gf2.css_standard_form_logicals(d["Hx"], d["Hz"])
    elif logicals == "codes":
        Lx, Lz = d["Lx"], d["Lz"]
    else:
        raise ValueError(f"unknown logicals {logicals!r}")
    bb = {k: (int(d[k]) if np.ndim(d[k]) == 0 else np.asarray(d[k]))
          for k in BB_KEYS if k in d}
    return make_code(d["Hx"], d["Hz"], Lx, Lz, **bb)


def decode_file(circ, M, data, max_iter: int, osd_order: int, device,
                first: int = None) -> dict:
    """Both bases of the trials in ``data`` (the first ``first``, or all),
    256 a call, the last call padded with zero syndromes as the JAX script
    pads it. Returns per basis: err, conv, rank_deficient, overflow (N,)
    bool numpy arrays and the seconds taken."""
    seq = alpha_schedule("dynamical", max_iter)
    N = data["syn_z"].shape[0] if first is None else first
    out = {}
    for basis, skey, tkey in (("Z", "syn_z", "true_z"),
                              ("X", "syn_x", "true_x")):
        dec = _make_basis(circ, M, basis, seq, osd_order=osd_order,
                          device=device)
        syn = np.asarray(data[skey][:N], np.uint8)
        tru = np.asarray(data[tkey][:N], np.uint8)
        B = min(BATCH, N)
        pad = (-N) % B
        if pad:
            syn = np.concatenate([syn, np.zeros((pad, syn.shape[1]),
                                                np.uint8)])
            tru = np.concatenate([tru, np.zeros((pad, tru.shape[1]),
                                                np.uint8)])
        syn_t = torch.as_tensor(syn.astype(np.int8), device=device)
        tru_t = torch.as_tensor(tru.astype(np.int8), device=device)
        t0 = time.perf_counter()
        parts = [_decode_one_basis(syn_t[c:c + B], tru_t[c:c + B], dec,
                                   max_iter, osd_order,
                                   return_overflow=True)
                 for c in range(0, len(syn), B)]
        flags = [torch.cat([p[j] for p in parts])[:N].cpu().numpy()
                 for j in range(4)]
        seconds = time.perf_counter() - t0
        out[basis] = dict(zip(("err", "conv", "rank_deficient",
                               "overflow"), flags), seconds=seconds)
    return out


def compare(res: dict, record, N: int) -> dict:
    """The decode ``res`` against the committed flags ``record`` (an npz
    with z_err and x_err) on the first N trials: both LERs, the z of their
    difference (each LER's binomial sigma over N, in quadrature, as
    ``validate_ler`` forms it), and per basis the disagreeing trials."""
    ours = res["Z"]["err"] | res["X"]["err"]
    rec_z = np.asarray(record["z_err"][:N], bool)
    rec_x = np.asarray(record["x_err"][:N], bool)
    rec = rec_z | rec_x
    ler, ler_rec = float(ours.mean()), float(rec.mean())
    sig = np.sqrt(ler * (1 - ler) / N + ler_rec * (1 - ler_rec) / N)
    out = dict(record_ler=ler_rec, record_errors=int(rec.sum()),
               z=float((ler - ler_rec) / sig) if sig > 0 else 0.0)
    for b, r in (("Z", rec_z), ("X", rec_x)):
        idx = np.nonzero(res[b]["err"] != r)[0]
        out[f"{b.lower()}_disagree"] = int(idx.size)
        out[f"{b.lower()}_disagree_trials"] = idx.tolist()
    return out


def launch_counts() -> dict:
    """The launch counts of the kernels a decode runs: K1, G1 and the
    selected eliminator."""
    from ..ops import bp_lift_cuda
    elim = {"K2": osd_cuda.eliminate_blocks_v1,
            "K4": osd_cuda.eliminate_blocks_fused,
            "K5": osd_cuda.eliminate_blocks_pair}[osd_cuda.selected_kernel()]
    return dict(K1=bp_lift_cuda.decode_batch_lift_cuda.launches,
                G1=osd_cuda.gather_pack.launches,
                eliminator=elim.launches)


def ourdecode(args) -> list:
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    code = load_code(args.code)
    t0 = time.perf_counter()
    circ, M = cached_matrices(code, args.cycles, args.p)
    print(f"{args.code} c={args.cycles} p={args.p}: matrices "
          f"{M['HdecZ'].shape} in {time.perf_counter() - t0:.1f} s, "
          f"eliminator {osd_cuda.selected_kernel()}", flush=True)
    data = np.load(data_path(args.code, args.cycles, args.p))
    N = data["syn_z"].shape[0] if args.first is None else args.first
    results = []
    for mi in args.max_iter:
        launches0 = launch_counts()
        res = decode_file(circ, M, data, mi, args.osd_order, dev, args.first)
        for b in "ZX":
            e = res[b]["err"]
            print(f"{b}: {int(e.sum())}/{N} = {e.mean():.4f} "
                  f"({res[b]['seconds']:.0f}s)", flush=True)
        any_err = res["Z"]["err"] | res["X"]["err"]
        ler = float(any_err.mean())
        line = dict(code=args.code, p=args.p, cycles=args.cycles, n=N,
                    max_iter=mi, osd_order=args.osd_order,
                    z_ler=float(res["Z"]["err"].mean()),
                    x_ler=float(res["X"]["err"].mean()),
                    ler=ler, errors=int(any_err.sum()),
                    sigma=float(np.sqrt(ler * (1 - ler) / N)))
        print(json.dumps(line), flush=True)
        extra = dict(
            max_iter=mi, seconds=sum(res[b]["seconds"] for b in "ZX"),
            overflow_trials={b: int(res[b]["overflow"].sum())
                             for b in "ZX"},
            rank_deficient={b: int(res[b]["rank_deficient"].sum())
                            for b in "ZX"},
            converged={b: int(res[b]["conv"].sum()) for b in "ZX"},
            launches={k: v - launches0[k]
                      for k, v in launch_counts().items()})
        rec = record_path(args.code, args.cycles, args.p, mi)
        if rec.exists():
            extra.update(compare(res, np.load(rec), N))
        print("vs record: " + json.dumps(extra), flush=True)
        if args.flags_out:
            os.makedirs(args.flags_out, exist_ok=True)
            path = Path(args.flags_out) / record_path(
                args.code, args.cycles, args.p, mi).name
            np.savez(path, z_err=res["Z"]["err"], x_err=res["X"]["err"])
            print("per-trial flags:", path, flush=True)
        results.append(dict(line=line, extra=extra, flags=res))
    return results


def class_frames(circ, basis: str) -> np.ndarray:
    """(classes, n) 0/1: the final data-qubit frame of each fault class's
    first fault, in the builder's class order (which the logical rows do
    not change)."""
    from ..models import builder
    n = circ.code.Hx.shape[1]
    specs = builder._enumerate_specs(circ, basis)
    L = circ.code.Lx if basis == "Z" else circ.code.Lz
    _, rep = builder._group_classes(builder._signatures_for_specs(
        circ, basis, np.asarray(L) % 2, specs))
    frames = builder._signatures_for_specs(circ, basis,
                                           np.eye(n, dtype=np.uint8), specs)
    return frames[rep, -n:]


def regress(frames: np.ndarray, bit: np.ndarray, rng, attempts: int = 400):
    """A GF(2) operator l with frames @ l = bit on most rows, by solving
    random subsets of rows (a few decodes are wrong); the best of
    ``attempts`` and the share of rows it predicts."""
    N, n = frames.shape
    best, share = None, 0.0
    for _ in range(attempts):
        idx = rng.choice(N, min(N, n + 40), replace=False)
        x = gf2.solve(frames[idx], bit[idx])
        if x is None:
            continue
        s = float(((frames.astype(np.int64) @ x) % 2 == bit).mean())
        if s > share:
            best, share = x, s
        if share > 0.99:
            break
    return best, share


def basis(args) -> dict:
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    code = load_code(args.code, "codes")
    circ, M = cached_matrices(code, args.cycles, args.p)
    data = np.load(data_path(args.code, args.cycles, args.p))
    N = data["syn_z"].shape[0] if args.first is None else args.first
    std = load_code(args.code, "standard")
    mi = args.max_iter[0]
    seq = alpha_schedule("dynamical", mi)
    rng = np.random.default_rng(0)
    out = {}
    for b, skey, tkey in (("Z", "syn_z", "true_z"), ("X", "syn_x",
                                                     "true_x")):
        dec = _make_basis(circ, M, b, seq, device=dev)
        syn = torch.as_tensor(np.asarray(data[skey][:N], np.int8),
                              device=dev)
        bp = _bp_one_basis(syn, dec, mi)
        conv = bp["converged"].cpu().numpy()
        hard = bp["hard"].cpu().numpy()[conv].astype(np.int64)
        frames = (hard @ class_frames(circ, b)) % 2
        true = np.asarray(data[tkey][:N])[conv]
        ops, shares = [], []
        for j in range(true.shape[1]):
            x, share = regress(frames.astype(np.uint8), true[:, j], rng)
            ops.append(x)
            shares.append(share)
        found = (np.array(ops, np.uint8) if all(x is not None for x in ops)
                 else None)
        L_std = std.Lx if b == "Z" else std.Lz
        L_npz = code.Lx if b == "Z" else code.Lz
        out[b] = dict(
            converged=int(conv.sum()), rank=gf2.rank(frames),
            n=frames.shape[1], min_share=min(shares),
            equals_standard=found is not None and np.array_equal(
                found, np.asarray(L_std) % 2),
            equals_stored=found is not None and np.array_equal(
                found, np.asarray(L_npz) % 2))
        print(f"{b}: {out[b]['converged']} of {N} trials converged "
              f"(maxIter {mi}); their decoded frames have rank "
              f"{out[b]['rank']} of {out[b]['n']}; the recovered operators "
              f"predict every true bit on at least {min(shares):.2%} of them;"
              f" equal to the standard form: {out[b]['equals_standard']}, "
              f"to codes/'s basis: {out[b]['equals_stored']}", flush=True)
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("basis")
    for flag, kw in (("--code", dict(required=True)),
                     ("--cycles", dict(type=int, required=True)),
                     ("--p", dict(type=float, required=True)),
                     ("--max-iter", dict(type=int, nargs=1, default=[50])),
                     ("--first", dict(type=int, default=2000)),
                     ("--device", dict(default="cuda"))):
        b.add_argument(flag, **kw)
    p = sub.add_parser("ourdecode")
    p.add_argument("--code", required=True)
    p.add_argument("--cycles", type=int, required=True)
    p.add_argument("--p", type=float, required=True)
    p.add_argument("--n", type=int, default=1000,
                   help="unused by ourdecode (the JAX script's sample size)")
    p.add_argument("--seed", type=int, default=7,
                   help="unused by ourdecode (the JAX script's sample seed)")
    p.add_argument("--max-iter", type=int, nargs="+", default=[20])
    p.add_argument("--osd-order", type=int, default=2)
    p.add_argument("--first", type=int, default=None,
                   help="decode only the file's first N trials")
    p.add_argument("--flags-out", default=None,
                   help="directory for the per-trial flags (never the "
                        "committed oracle_data)")
    p.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return basis(args) if args.cmd == "basis" else ourdecode(args)


if __name__ == "__main__":
    main()
