"""Flooding min-sum BP on a lifted graph: CUDA kernel K1 and its plain twin.

``decode_batch_lift_cuda`` has the contract of the JAX package's
``decode_batch_lift_pallas`` (schedule="flooding", damping 1): same
arguments and outputs, including the ``out_gather`` / ``residual`` epilogue
(edge-free columns keep the prior and decide ``prior < 0``). On a CUDA
tensor it launches ``csrc/bp_lift_flood.cu`` (one thread block per shot,
several per SM, all iterations, per-shot exit) or raises; on a CPU tensor
it runs ``decode_batch_lift_plain``, the same algorithm in PyTorch over the
neighbour tables of :func:`flood_tables`. The kernel reads no table: it
computes its neighbours from :func:`flood_geometry` and keeps each check's
messages compressed (two products, sign bits and the argmin slot).

Output note: each shot's ``values`` are frozen at its converging iteration
(the kernel stops the shot there), so converged shots' values equal the
reference lift's. The Pallas kernel instead keeps iterating converged shots
of a block; only ``hard``, ``converged``, ``iterations`` and the values of
unconverged shots are part of the cross-implementation contract.

Internal column-slot order is (pattern, t, x, y) — the check order
(t, x, y) of the syndrome rows with the pattern in front — so neighbouring
threads touch neighbouring shared-memory words in both passes.
"""
from __future__ import annotations

import ctypes
import re

import numpy as np
import torch

from .. import _kernels
from .bp import _BIG
from .bp_lift import LiftedGraph

_SMEM_LIMIT = _kernels.SMEM_PER_BLOCK


def _flood_define(name: str) -> int:
    """An integer ``#define`` of csrc/bp_lift_common.cuh, the one place the
    layout constants of K1 and K3 are set."""
    src = (_kernels.SRC_DIR / "bp_lift_common.cuh").read_text()
    return int(re.search(rf"^#define {name} (\d+)\b", src, re.M).group(1))


_MAX_EB = _flood_define("MAX_EB")
_FLOOD_THREADS = _flood_define("FLOOD_THREADS")


class _FloodGraph(ctypes.Structure):
    """csrc/bp_lift_common.cuh's ``FloodGraph``: the lift's per-edge
    constants (offsets in bytes), passed to K1 and K3 by value."""
    _fields_ = ([(f, ctypes.c_int * _MAX_EB) for f in
                 ("chk_off", "col_off", "pb_off", "pb_last")]
                + [(f, ctypes.c_int) for f in ("EB", "NB", "P", "L")])


def flood_tables(g: LiftedGraph, device) -> dict:
    """Neighbour tables of the lifted graph in the kernel's layout, cached
    on the graph per device.

    chk_nbr (EB, m): column slot of edge e at check row r, -1 when dead.
    col_chk (EB, P): check row of edge e at column position q of its
      pattern, -1 when dead (P = ell*mm*T).
    pb_start (NB+1,): edge-slot range of each base pattern.
    prior_grid (NB*P,), out_gather (n,): in the internal slot order."""
    key = ("flood", str(device))
    if key in g.cache:
        return g.cache[key]
    ell, mm, T, NB, EB = g.ell, g.mm, g.T, g.NB, g.EB
    P = ell * mm * T
    cmask = g.cmask.cpu().numpy()
    slot_mask = g.slot_mask.cpu().numpy()
    t, x, y = np.meshgrid(np.arange(T), np.arange(ell), np.arange(mm),
                          indexing="ij")                  # row order (t,x,y)
    chk_nbr = np.full((EB, g.m), -1, np.int64)
    col_chk = np.full((EB, P), -1, np.int64)
    for e in range(EB):
        pb, o, cx, cy = g.eb_pb[e], g.eb_o[e], g.eb_cx[e], g.eb_cy[e]
        live = cmask[e].transpose(2, 0, 1)                # (T, ell, mm)
        slot = (pb * P + (t - o) * ell * mm + ((x - cx) % ell) * mm
                + (y - cy) % mm)
        chk_nbr[e] = np.where(live, slot, -1).reshape(-1)
        # column position (a, gx, gy) = (t, x, y) grids reused
        a, gx, gy = t, x, y
        clive = slot_mask[pb].transpose(2, 0, 1) & (a + o < T)
        row = (a + o) * ell * mm + ((gx + cx) % ell) * mm + (gy + cy) % mm
        col_chk[e] = np.where(clive, row, -1).reshape(-1)
    pb_start = np.zeros(NB + 1, np.int64)
    for e, pb in enumerate(g.eb_pb):
        pb_start[pb + 1] = e + 1
    prior_grid = g.prior_grid.cpu().numpy().transpose(0, 3, 1, 2).reshape(-1)
    so = g.out_gather.cpu().numpy().astype(np.int64)      # (pb, x, y, t)
    pb_o, rest = so // P, so % P
    a_o, gxy = rest % T, rest // T
    out_k = pb_o * P + a_o * ell * mm + (gxy // mm) * mm + gxy % mm

    def dev32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                               device=device)

    tabs = dict(
        chk_nbr=dev32(chk_nbr), col_chk=dev32(col_chk),
        pb_start=dev32(pb_start), out_gather=dev32(out_k),
        prior_grid=torch.as_tensor(np.ascontiguousarray(prior_grid),
                                   device=device),
        residual=g.residual.to(device=device, dtype=torch.uint8),
        pb_ranges=[(int(pb_start[i]), int(pb_start[i + 1]))
                   for i in range(NB)],
        P=P)
    g.cache[key] = tabs
    return tabs


def flood_geometry(g: LiftedGraph, device) -> dict:
    """What kernels K1 and K3 compute their neighbours from, cached on the
    graph per device.

    graph: the kernel's ``FloodGraph`` parameter: per edge slot e =
      (pb, o, cx, cy), chk_off = 4 (pb*P - o*ell*mm - cx*mm - cy), col_off =
      16 (o*ell*mm + cx*mm + cy), pb_off = 4*pb*P and pb_last (1 on each
      pattern's last slot; slots are sorted by pattern).
    wrap (2, ell*mm, 36) uint8 (36 = the kernel's MAX_EB): at (x, y),
      wrap[0, x*mm + y, e] = ell*mm*(x < cx) + mm*(y < cy) and
      wrap[1, x*mm + y, e] = ell*mm*(x >= ell - cx) + mm*(y >= mm - cy).
      Check row r = (t, x, y) meets edge slot e at column slot
      r + chk_off/4 + wrap[0, x*mm + y, e]; column position q = (a, x, y)
      meets it at check row q + col_off/16 - wrap[1, x*mm + y, e].
    pos_info (m, 8) int32: per position p = (t, x, y), the live bits of
      edge slots 0-31 and 32-35 at check row p (slot 32w + i at bit 31 - i
      of word w), x*mm + y, 0; the same at column position p (live iff the
      slot is live and t + o < T).
    The sizes of the kernels' state come from the kernels themselves
    (:func:`_state_sizes`)."""
    key = ("flood_geometry", str(device))
    if key in g.cache:
        return g.cache[key]
    ell, mm, T, NB, EB, m = g.ell, g.mm, g.T, g.NB, g.EB, g.m
    L = ell * mm
    if EB > _MAX_EB or L + mm > 255:
        raise ValueError(f"K1 and K3 take at most {_MAX_EB} edge slots and "
                         f"ell*mm + mm < 256; got EB={EB}, ell={ell}, "
                         f"mm={mm}")
    P = L * T
    pb, o, cx, cy = (np.asarray(v, np.int64)
                     for v in (g.eb_pb, g.eb_o, g.eb_cx, g.eb_cy))
    graph = _FloodGraph(EB=EB, NB=NB, P=P, L=L)
    for name, vals in dict(
            chk_off=4 * (pb * P - o * L - cx * mm - cy),
            col_off=16 * (o * L + cx * mm + cy), pb_off=4 * pb * P,
            pb_last=np.append(pb[1:] != pb[:-1], True)).items():
        padded = [int(v) for v in vals] + [0] * (_MAX_EB - EB)
        getattr(graph, name)[:] = padded
    gx, gy = np.divmod(np.arange(L), mm)
    wrap = np.zeros((2, L, _MAX_EB), np.uint8)
    wrap[0, :, :EB] = (L * (gx[:, None] < cx) + mm * (gy[:, None] < cy))
    wrap[1, :, :EB] = (L * (gx[:, None] >= ell - cx)
                       + mm * (gy[:, None] >= mm - cy))
    t, xy = np.divmod(np.arange(m), L)

    def bits(live):  # (EB, m) bool -> two (m,) words, first slot highest
        e = np.arange(EB)
        at = (31 - e % 32).astype(np.uint64)[:, None]
        return [(live[e // 32 == w].astype(np.uint64)
                 << at[e // 32 == w]).sum(0) for w in (0, 1)]

    def rows(mask):  # (k, ell, mm, T) -> (k, m) in row order (t, x, y)
        return mask.cpu().numpy().transpose(0, 3, 1, 2).reshape(len(mask), m)

    chk_live = rows(g.cmask)
    col_live = rows(g.slot_mask)[pb] & (t[None] + o[:, None] < T)
    tail = [xy.astype(np.uint64), np.zeros(m, np.uint64)]
    pos = np.stack(bits(chk_live) + tail + bits(col_live) + tail, 1)
    wrap_flat = np.zeros(-(-wrap.size // 16) * 16, np.uint8)
    wrap_flat[:wrap.size] = wrap.reshape(-1)
    geo = dict(graph=graph,
               pos_info=torch.as_tensor(pos.astype(np.uint32).view(np.int32),
                                        device=device).contiguous(),
               wrap_words=torch.as_tensor(wrap_flat.view(np.int32),
                                          device=device))
    g.cache[key] = geo
    return geo


def _state_sizes(geo: dict, kernel: str) -> tuple:
    """(state bytes a shot, shared memory a block with the state in it) of
    ``kernel`` ("K1" or "K3") as its source lays them out, cached in
    ``geo``. The kernel reports them, so the device-memory slab it indexes
    is sized by the same formula."""
    key = ("sizes", kernel)
    if key not in geo:
        out = (ctypes.c_longlong * 3)()
        _kernels.check(_bp_entry(kernel)["sizes"](
            ctypes.byref(geo["graph"]), out), f"{kernel} sizes")
        if geo["wrap_words"].numel() * 4 < out[1]:
            raise RuntimeError(f"{kernel} reads {out[1]} bytes of wrap "
                               f"tables; flood_geometry holds "
                               f"{geo['wrap_words'].numel() * 4}")
        geo[key] = (out[0], out[2])
    return geo[key]


def _check_inputs(g: LiftedGraph, syndrome, prior, alpha_seq, maxIter):
    if syndrome.dim() != 2 or syndrome.shape[1] != g.m:
        raise ValueError(f"syndrome must be (B, {g.m}), got "
                         f"{tuple(syndrome.shape)}")
    if prior.shape != (g.n,):
        raise ValueError(f"prior must be ({g.n},), got {tuple(prior.shape)}")
    if maxIter < 1 or alpha_seq.shape[0] < maxIter:
        raise ValueError("need maxIter >= 1 and len(alpha_seq) >= maxIter")


def decode_batch_lift_cuda(g: LiftedGraph, syndrome, prior, alpha_seq,
                           maxIter: int, clip_llr: float = 20.0):
    """Flooding min-sum BP (damping 1). syndrome (B, m) 0/1 with rows
    t*ell*mm + x*mm + y; prior (n,) f32; alpha_seq (>= maxIter,) f32.

    Returns dict hard (B, n) int8, converged (B,) bool, values (B, n) f32,
    iterations (B,) int32. CUDA tensors launch kernel K1; CPU tensors run
    :func:`decode_batch_lift_plain`. ``decode_batch_lift_cuda.launches``
    counts the kernel launches."""
    _check_inputs(g, syndrome, prior, alpha_seq, maxIter)
    if syndrome.device.type == "cpu":
        return decode_batch_lift_plain(g, syndrome, prior, alpha_seq,
                                       maxIter, clip_llr)
    launch, out = prepare_flood_launch(g, syndrome, prior, alpha_seq,
                                       maxIter, clip_llr)
    launch()
    return out


decode_batch_lift_cuda.launches = 0


def prepare_flood_launch(g: LiftedGraph, syndrome, prior, alpha_seq,
                         maxIter: int, clip_llr: float = 20.0):
    """K1 on CUDA tensors, prepared but not launched: input casts, geometry
    and tables, output and scratch allocation, library load. Returns
    (launch, outputs): each ``launch()`` runs the kernel once into
    ``outputs`` and counts it on ``decode_batch_lift_cuda``, so a caller can
    also time the kernel alone."""
    return prepare_bp_launch("K1", decode_batch_lift_cuda, g, syndrome,
                             prior, alpha_seq, maxIter, clip_llr)


def flood_launch_info(g: LiftedGraph, device) -> dict:
    """K1's shape on the card for graph ``g`` (:func:`bp_launch_info`)."""
    return bp_launch_info("K1", g, device)


# The lifted min-sum kernels: library (csrc/<name>.cu) and the prefix of
# its C entry points. Both take one C signature (csrc/bp_lift_common.cuh).
_BP_KERNELS = {"K1": ("bp_lift_flood", "bp_flood"),
               "K3": ("bp_lift_layered", "bp_layered")}


def _bp_entry(kernel: str) -> dict:
    """The ``launch``, ``info`` and ``sizes`` C entry points of K1 or K3,
    their argument types set."""
    name, prefix = _BP_KERNELS[kernel]
    lib = _kernels.load(name)
    fns = {s: getattr(lib, f"{prefix}_{s}") for s in ("launch", "info",
                                                      "sizes")}
    if not fns["launch"].argtypes:
        Pt, It = ctypes.c_void_p, ctypes.c_int
        fns["launch"].argtypes = ([Pt] * 14 + [It] * 3
                                  + [ctypes.c_float, It, Pt])
        fns["info"].argtypes = [Pt, It, It, Pt]
        fns["sizes"].argtypes = [Pt, Pt]
        for f in fns.values():
            f.restype = ctypes.c_int
    return fns


def _bp_threads(g: LiftedGraph) -> int:
    return min(_FLOOD_THREADS, -(-g.m // 32) * 32)


def prepare_bp_launch(kernel: str, wrapper, g: LiftedGraph, syndrome, prior,
                      alpha_seq, maxIter: int, clip_llr: float = 20.0):
    """K1 or K3 (``kernel``) on CUDA tensors, prepared but not launched:
    input casts, geometry and tables, output and scratch allocation, library
    load. Returns (launch, outputs): each ``launch()`` runs the kernel once
    into ``outputs`` and counts it on ``wrapper.launches``."""
    _check_inputs(g, syndrome, prior, alpha_seq, maxIter)
    if syndrome.device.type != "cuda":
        raise ValueError(f"unsupported device {syndrome.device}")
    dev = syndrome.device
    geo = flood_geometry(g, dev)
    tabs = flood_tables(g, dev)
    B, n = syndrome.shape[0], g.n
    syn = syndrome.to(torch.int8).contiguous()
    prior = prior.to(device=dev, dtype=torch.float32).contiguous()
    alpha = alpha_seq.to(device=dev, dtype=torch.float32).contiguous()
    values = torch.empty((B, n), dtype=torch.float32, device=dev)
    hard = torch.empty((B, n), dtype=torch.int8, device=dev)
    conv = torch.empty((B,), dtype=torch.bool, device=dev)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    state, smem = _state_sizes(geo, kernel)
    scratch = None
    if smem > _SMEM_LIMIT:  # per-shot slab in device memory
        scratch = torch.empty((B, state), dtype=torch.uint8, device=dev)
    threads = _bp_threads(g)
    fn = _bp_entry(kernel)["launch"]

    def launch():
        # syn, prior, alpha and scratch stay referenced by this closure
        code = fn(
            ctypes.byref(geo["graph"]), syn.data_ptr(),
            tabs["prior_grid"].data_ptr(), geo["pos_info"].data_ptr(),
            geo["wrap_words"].data_ptr(), alpha.data_ptr(),
            tabs["out_gather"].data_ptr(), tabs["residual"].data_ptr(),
            prior.data_ptr(), values.data_ptr(),
            hard.data_ptr(), conv.data_ptr(), iters.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            B, n, maxIter, float(clip_llr), threads, _kernels.stream_ptr(dev))
        _kernels.check(code, f"{kernel} launch")
        wrapper.launches += 1

    return launch, dict(hard=hard, converged=conv, values=values,
                        iterations=iters)


def bp_launch_info(kernel: str, g: LiftedGraph, device) -> dict:
    """K1's or K3's shape on the card for graph ``g``: registers and
    spilled bytes a thread, threads a block (one shot), state bytes a shot
    and where they live, shared memory a block, and blocks (shots) resident
    per SM."""
    geo = flood_geometry(g, device)
    threads = _bp_threads(g)
    state, smem = _state_sizes(geo, kernel)
    in_smem = smem <= _SMEM_LIMIT
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        _kernels.check(_bp_entry(kernel)["info"](
            ctypes.byref(geo["graph"]), threads, int(not in_smem), out),
            f"{kernel} info")
    return dict(registers=out[0], local_bytes=out[1], threads=threads,
                state_bytes=state,
                state_in="shared memory" if in_smem else "device memory",
                smem_bytes=out[2], blocks_per_sm=out[3])


class _PlainGraph:
    """What the plain versions of the lifted-BP kernels share: the gather
    indices of ``flood_tables`` as int64 tensors, the syndrome signs, and
    the kernels' min-sum message rule and posterior sum."""

    def __init__(self, g: LiftedGraph, syndrome):
        dev = syndrome.device
        self.g, self.dev = g, dev
        self.tabs = tabs = flood_tables(g, dev)
        self.B, self.m = syndrome.shape
        chk = tabs["chk_nbr"].long()
        self.live = chk >= 0                                  # (EB, m)
        self.idx = chk.clamp(min=0)
        col = tabs["col_chk"].long()
        # flat R index of each (edge, column position); dead -> zero pad
        e_ids = torch.arange(g.EB, device=dev)[:, None]
        self.colR = torch.where(col >= 0, e_ids * self.m + col,
                                g.EB * self.m)                # (EB, P)
        self.syn = syndrome.to(torch.int32)
        self.sgn_syn = 1.0 - 2.0 * self.syn.to(torch.float32)
        self.big = torch.tensor(_BIG, dtype=torch.float32, device=dev)

    def messages(self, Q, alpha):
        """New R (B, EB, m) from Q (dead edges at +_BIG): min1/min2 and
        sign parity per check, R = (alpha*sgn)*mag with the edge sign as a
        select, dead edges 0."""
        absQ = Q.abs()
        m1 = absQ.amin(1)
        is_min = absQ == m1[:, None]
        m2d = torch.where(is_min, self.big, absQ).amin(1)
        m2 = torch.where(is_min.sum(1) > 1, m1, m2d)
        neg = Q < 0.0
        sgn = (torch.where((neg.sum(1) & 1) == 1, -1.0, 1.0)
               .to(torch.float32) * self.sgn_syn)
        mag = torch.where(is_min, m2[:, None], m1[:, None])
        rpos = (alpha * sgn)[:, None] * mag
        return torch.where(self.live, torch.where(neg, -rpos, rpos), 0.0)

    def posteriors(self, R):
        """V (B, NB*P): per column slot, R summed in edge-slot order from
        zero, then the prior added."""
        B, P = self.B, self.tabs["P"]
        Rf = torch.cat([R.reshape(B, -1),
                        torch.zeros((B, 1), dtype=torch.float32,
                                    device=self.dev)], 1)
        pg = self.tabs["prior_grid"]
        parts = []
        for pb, (e0, e1) in enumerate(self.tabs["pb_ranges"]):
            acc = torch.zeros((B, P), dtype=torch.float32, device=self.dev)
            for e in range(e0, e1):
                acc = acc + Rf[:, self.colR[e]]
            parts.append(pg[pb * P:(pb + 1) * P] + acc)
        return torch.cat(parts, 1)

    def satisfied(self, V):
        """(B,) whether the hard decision of V meets the syndrome."""
        par = ((V[:, self.idx] < 0.0) & self.live).sum(1) & 1    # (B, m)
        return (par == self.syn).all(1)

    def output(self, vals, prior, done, iters):
        """The decode dict in original column order; edge-free columns keep
        the prior."""
        prior = prior.to(device=self.dev, dtype=torch.float32)
        values = torch.where(self.g.residual.to(self.dev)[None], prior[None],
                             vals[:, self.tabs["out_gather"].long()])
        return dict(hard=(values < 0.0).to(torch.int8), converged=done,
                    values=values, iterations=iters)


def decode_batch_lift_plain(g: LiftedGraph, syndrome, prior, alpha_seq,
                            maxIter: int, clip_llr: float = 20.0):
    """Plain PyTorch version of kernel K1: the same per-element float32
    arithmetic over the same neighbour tables, vectorized over shots, with
    per-shot freezing at convergence. One host read per iteration."""
    _check_inputs(g, syndrome, prior, alpha_seq, maxIter)
    ctx = _PlainGraph(g, syndrome)
    B, dev = ctx.B, ctx.dev
    alpha_seq = alpha_seq.to(device=dev, dtype=torch.float32)
    V = ctx.tabs["prior_grid"][None].expand(B, -1).clone()
    R = torch.zeros((B, g.EB, ctx.m), dtype=torch.float32, device=dev)
    vals = V.clone()
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.full((B,), maxIter - 1, dtype=torch.int32, device=dev)
    for it in range(maxIter):
        if bool(done.all()):
            break
        Vc = V[:, ctx.idx]                                 # (B, EB, m)
        # iteration 0 sends the prior itself, unclipped
        Q = Vc if it == 0 else torch.clamp(Vc - R, -clip_llr, clip_llr)
        R = ctx.messages(torch.where(ctx.live, Q, ctx.big), alpha_seq[it])
        V = ctx.posteriors(R)
        ok = ctx.satisfied(V)
        vals = torch.where(done[:, None], vals, V)
        iters = torch.where(ok & ~done, torch.full_like(iters, it), iters)
        done = done | ok
    return ctx.output(vals, prior, done, iters)
