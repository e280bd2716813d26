"""The reference of one pooled decode round: per basis, sampling, BP, OSD on
the shots BP left unconverged, and the readout, with the per-shot flags the
program's round returns."""
from __future__ import annotations

import numpy as np
import torch

from . import bp, bp_layered, osd
from .sampling import Signatures


class Basis:
    """One decoding basis, built from the benchmark's arrays alone.

    H (m, n) decoding matrix; full (m + k, n) augmented signatures (its
    last k rows: each column's logical action); prior (n,) channel LLRs;
    gate_loc, role, cls (per elementary location) and idle (per gate
    location): the sampling tables; (ell, mm): the code's group."""

    def __init__(self, name: str, H, full, prior, gate_loc, role, cls, idle,
                 group: tuple, decoder: dict, device, basis_cols=None):
        H = (np.asarray(H) != 0).astype(np.uint8)
        m, n = H.shape
        self.name = name
        self.dev = torch.device(device)
        self.sig = Signatures(gate_loc, role, cls, idle, full, m, name,
                              device)
        self.graph = bp.Graph(H, prior, *group, device)
        self.HT = torch.as_tensor(H.T != 0, device=self.dev)
        self.logical = torch.as_tensor(
            np.ascontiguousarray(np.asarray(full)[m:].T % 2, np.int64),
            device=self.dev)
        self.K = osd.choose_k(m, n, decoder["osd_margin"])
        if basis_cols is None:
            basis_cols = osd.column_basis(H, device)
        self.basis_cols = torch.as_tensor(np.asarray(basis_cols, np.int64),
                                          device=self.dev)
        self.decoder = decoder
        self.alpha = alpha_schedule(decoder["alpha"], decoder["max_iter"])


def alpha_schedule(mode: str, max_iter: int) -> np.ndarray:
    """The dynamical schedule: alpha_t = 1 - 2**-(t + 1)."""
    if mode != "dynamical":
        raise ValueError(f"unknown alpha schedule {mode!r}")
    return (1.0 - 2.0 ** (-(np.arange(max_iter) + 1.0))).astype(np.float32)


OSD_BLOCK = 32   # shots whose columns are packed at once (bounds memory)

# a configuration's ``decoder.bp`` -> the reference's BP of that schedule
SCHEDULES = {"flooding normalized min-sum": bp.decode,
             "layered normalized min-sum": bp_layered.decode}


def decode_basis(b: Basis, syndrome, true_log, msg_dtype=torch.float32,
                 block: int = 1024) -> dict:
    """BP of the decoder's schedule, OSD of the unconverged shots and the
    readout of one basis for a pool of shots. Returns err, conv, rankdef
    (bool) and iterations."""
    d = b.decoder
    decode = SCHEDULES[d["bp"]]
    parts = [decode(b.graph, syndrome[i:i + block], b.alpha, d["max_iter"],
                    d["clip_llr"], msg_dtype)
             for i in range(0, syndrome.shape[0], block)]
    res = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    conv, hard = res["converged"], res["hard"]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        bp_log = (hard.to(torch.float32)
                  @ b.logical.to(torch.float32)).to(torch.int64) & 1
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    failed = torch.nonzero(~conv)[:, 0]
    delta, rdef = osd.osd(b.HT, b.basis_cols, syndrome[failed],
                          res["values"][failed], hard[failed], b.K,
                          d["osd_order"], b.logical, OSD_BLOCK)
    dec_log = bp_log.clone()
    dec_log[failed] ^= delta
    rankdef = torch.zeros_like(conv)
    rankdef[failed] = rdef
    err = (dec_log != true_log.to(torch.int64)).any(1)
    return dict(err=err, conv=conv, rankdef=rankdef,
                iterations=res["iterations"])


def decode_round(bases, randoms, msg_dtype=torch.float32,
                 block: int = 1024) -> dict:
    """Every round of a pooled dispatch: ``randoms`` is a list of per-round
    (err, pauli, cat2). Returns per basis name ("z", "x") the flags of the
    whole pool, rounds in order: {"z_err": ..., "z_conv": ..., ...,
    "z_iterations": ...}."""
    out = {}
    for b in bases:
        syn, true = [], []
        for err, pauli, cat2 in randoms:
            for i in range(0, err.shape[0], block):
                s, t = b.sig.augmented(err[i:i + block], pauli[i:i + block],
                                       cat2[i:i + block])
                syn.append(s)
                true.append(t)
        r = decode_basis(b, torch.cat(syn), torch.cat(true), msg_dtype,
                         block)
        out.update({f"{b.name.lower()}_{k}": v for k, v in r.items()})
    return out
