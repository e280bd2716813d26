"""Feasibility probe for a left-looking panel GF(2) eliminator.

Counterpart of the JAX package's ``scripts/osd_panel_probe.py``:

(a) The cost of the eliminator (``ops.osd_cuda.eliminate_blocks``: K2, or
    K4 / K5 under ``QLDPC_OSD_KERNEL``) as a function of the word width W:
    256 column steps with no early exit (``exit_on_valid=False``,
    ``rank=m``) at 8, 16 and 40 words, B=512 shots of M=1024 rows (m =
    M - 16), asking JAX's 64 shots a block. Inputs are random words in
    G1's column layout (``osd_cuda.column_stride``), zero past ceil(m/32)
    words a column. If the cost scales ~linearly with W, a panel kernel
    that touches 8 words a step instead of 40 cuts the serial scan ~5x.
    Prints per width the mean host ms of ``REPS`` synchronised calls, the
    microseconds a step, the scaling against 8 words and the shots a block
    the launch took (the plan clamps JAX's 64).
(b) The panel-entry update outside the eliminator: one recorded panel
    transform applied to a 4-word slab (128 columns) by the JAX script's
    expression: unpack the words, a pivot indicator from ``colofrow``, two
    batched products in bfloat16 with float32 accumulation (:func:`bmm_f32`;
    JAX computes this outside any Pallas kernel, so a library product is
    its counterpart here) and the parity, packed back and XORed in; for one
    pair and for six pairs. :func:`transform_plain` is the same map as
    integer XORs, the exactness reference.

Usage (from the root of a checkout):

    python -m qldpc_tpu_torch.scripts.osd_panel_probe [B=512] [M=1024]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..ops import osd_cuda
from . import card_line, timed

WIDTHS = (8, 16, 40)
STEPS = 256          # fixed step count: rank=m and no validity exit
JAX_BLOCK_SHOTS = 64  # the JAX script's block_shots
P = 128              # panel columns: 4 words
REPS = 10


def column_input(rng, B: int, W: int, M: int, m: int, device):
    """(B, 32W, S) int32 random words in G1's column layout, zero past
    ceil(m/32) words a column."""
    S = osd_cuda.column_stride(W, M, device)
    words = rng.integers(0, 2**32, (B, 32 * W, S), dtype=np.uint64)
    words[:, :, -(-m // 32):] = 0
    return torch.as_tensor(words.astype(np.uint32).view(np.int32),
                           device=device)


def bmm_f32(a, b):
    """Batched product of bfloat16 ``a`` and ``b`` accumulated and returned
    in float32, as JAX's ``einsum(..., preferred_element_type=float32)``:
    on the card cuBLAS's bfloat16 product with a float32 output; the CPU
    has no such kernel, so there the same values as float32 (exact: the
    inputs are small integers)."""
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _unpack(words):
    """(B, 4, M) int32 words -> (B, M, 128) bfloat16 bits, column
    32w + c = bit c of word w."""
    B, nw, M = words.shape
    bits = torch.arange(32, dtype=torch.int32, device=words.device)
    u = (words[:, :, None, :] >> bits[None, None, :, None]) & 1
    return u.reshape(B, nw * 32, M).transpose(1, 2).to(torch.bfloat16)


def apply_transform(cur, Vw, cf):
    """The JAX script's panel-entry update: cur (B, 4, M) int32 words of
    the slab, Vw (B, 4, M) the recorded transform's words, cf (B, M) the
    pivot column of each row (-1: none). Returns cur XOR the parity of
    Vu @ (G @ cu) packed back to words, where cu and Vu are the unpacked
    bits and G (B, P, M) marks row m as column p's pivot."""
    B, nw, M = cur.shape
    cols0 = torch.arange(P, dtype=torch.int32, device=cur.device)
    cu = _unpack(cur)                                            # (B,M,P)
    G = (cf[:, None, :] == cols0[None, :, None]).to(torch.bfloat16)
    piv = bmm_f32(G, cu)                                         # (B,P,P)
    delta = bmm_f32(_unpack(Vw), piv.to(torch.bfloat16))         # (B,M,P)
    dbits = delta.to(torch.int32) & 1
    bits = torch.arange(32, dtype=torch.int32, device=cur.device)
    dw = (dbits.reshape(B, M, nw, 32) << bits).sum(3, dtype=torch.int32)
    return cur ^ dw.transpose(1, 2)


def transform_plain(cur, Vw, cf) -> np.ndarray:
    """:func:`apply_transform` as integer XORs on numpy words: column p's
    pivot word row is the XOR of the slab rows whose pivot is p, and row m
    gains the XOR of those of the columns its transform bits select."""
    cur = np.asarray(cur).view(np.uint32)
    Vw = np.asarray(Vw).view(np.uint32)
    cf = np.asarray(cf)
    out = cur.copy()
    piv = np.stack([np.bitwise_xor.reduce(
        np.where((cf == p)[:, None, :], cur, np.uint32(0)), axis=2)
        for p in range(P)], 1)                                    # (B,P,4)
    for p in range(P):
        sel = ((Vw[:, p // 32, :] >> np.uint32(p % 32)) & 1).astype(bool)
        out ^= np.where(sel[:, None, :], piv[:, p, :, None], np.uint32(0))
    return out.view(np.int32)


def transform_inputs(rng, B: int, M: int):
    """The JAX script's (b) inputs as numpy: cur and Vw (B, 4, M) uint32
    words, cf (B, M) int32 in [-1, 200)."""
    cur = rng.integers(0, 2**32, (B, 4, M), dtype=np.uint64).astype(
        np.uint32)
    Vw = rng.integers(0, 2**32, (B, 4, M), dtype=np.uint64).astype(
        np.uint32)
    cf = rng.integers(-1, 200, (B, M)).astype(np.int32)
    return cur, Vw, cf


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("B", nargs="?", type=int, default=512)
    ap.add_argument("M", nargs="?", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B, M = args.B, args.M
    m = M - 16
    print(card_line(dev), flush=True)
    rng = np.random.default_rng(0)
    kernel = osd_cuda.selected_kernel()
    res, base = {}, None
    for W in WIDTHS:
        Hp = column_input(rng, B, W, M, m, dev)
        s = torch.as_tensor(rng.integers(0, 2, (B, M)).astype(np.int32),
                            device=dev)
        in_place = (dev.type == "cuda"
                    and osd_cuda.elim_sizes(W, M, kernel)["device_memory"])

        def run(Hp=Hp, s=s, in_place=in_place):
            out = osd_cuda.eliminate_blocks(
                Hp.clone() if in_place else Hp, s, STEPS, m, rank=m,
                exit_on_valid=False, want_matrix=False,
                block_shots=JAX_BLOCK_SHOTS)
            return out[1].sum(), out[4].sum()
        _, ms = timed(f"eliminate W={W:2d} K={STEPS} ({STEPS} steps, "
                      f"no exit)", run, REPS, dev, stat="mean", width=52)
        taken = (osd_cuda.elim_launch_info(
            B, W, M, dev, kernel, JAX_BLOCK_SHOTS)["shots_per_block"]
            if dev.type == "cuda" else None)
        res[W] = dict(ms=ms, us_per_step=ms * 1e3 / STEPS, taken=taken)
        print(f"    {ms * 1e3 / STEPS:.3f} us a step; " + (
            "plain version" if taken is None else
            f"{kernel} took {taken} shots a block (block_shots="
            f"{JAX_BLOCK_SHOTS} asked)"), flush=True)
        if base is None:
            base = ms
        else:
            res[W]["scaling"] = ms / base
            print(f"    width scaling vs W=8: {ms / base:.2f}x", flush=True)

    cur_np, Vw_np, cf_np = transform_inputs(rng, B, M)
    cur, Vw, cf = (torch.as_tensor(a, device=dev) for a in (
        cur_np.view(np.int32), Vw_np.view(np.int32), cf_np))

    def run_pair():
        return apply_transform(cur, Vw, cf).sum()

    def run_6pairs():
        out = cur
        for i in range(6):
            out = apply_transform(out, Vw, cf + i)
        return out.sum()
    _, ms1 = timed(f"panel-entry transform (1 pair, B={B})", run_pair, REPS,
                   dev, stat="mean", width=52)
    _, ms6 = timed("panel-entry transform (6 pairs = Q4 total)", run_6pairs,
                   REPS, dev, stat="mean", width=52)
    res["transform_ms"] = dict(pair=ms1, six_pairs=ms6)
    return res


if __name__ == "__main__":
    main()
