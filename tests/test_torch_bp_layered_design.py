"""The design of kernel K3 (time-layered min-sum), held on the CPU.

K3 (qldpc_tpu_torch/csrc/bp_lift_layered.cu) is K1's design with the
layered order of passes: it keeps each check row's messages compressed (the
products P1 = (alpha*sgn)*m1, P2 = (alpha*sgn)*m2, the q-sign bits and the
argmin slot), computes its neighbours from ``bp_lift_cuda.flood_geometry``,
and maps each half-sweep's threads onto its own layer's rows: thread p of
half L takes row (2*(i // Ls) + L)*Ls + i % Ls for its layer indices
i = p, p + nt, ..., Ls = ell*mm. The kernel runs only on the card; here its
mapping, its state and its whole algorithm, written out in PyTorch, are held
against the plain version (``decode_batch_lift_layered_plain``):

* the row mapping covers each layer's rows exactly once, T even and odd;
* R rebuilt from the compressed state is bit-equal to the plain layered R
  after every half-sweep, tied minima included;
* the kernel's algorithm on that state, K1's neighbour formulas and the
  row mapping gives the plain version's outputs bit for bit.
"""
import numpy as np
import pytest
import torch

from qldpc_tpu_torch.ops.bp import alpha_schedule
from qldpc_tpu_torch.ops.bp_lift_cuda import _BIG, _PlainGraph, _bp_threads
from qldpc_tpu_torch.ops.bp_lift_cuda import flood_tables
from qldpc_tpu_torch.ops.bp_lift_layered_cuda import (
    decode_batch_lift_layered_plain)
from test_torch_bp_flood_design import (CLIP, CPU, NO_EDGE, KernelNeighbours,
                                        _bits, _graphs, _syndromes, compress,
                                        rebuild)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def c72():
    return _graphs("[[72, 12, 6]]", 6, 0.006)


@pytest.fixture(scope="module")
def c72_odd():
    return _graphs("[[72, 12, 6]]", 5, 0.006)


def thread_rows(g, L):
    """The rows each thread of half L walks, in its order, as the kernel
    computes them (layer_row in bp_lift_layered.cu)."""
    Ls = g.ell * g.mm
    T = g.m // Ls
    n_layer = ((T + 1) // 2 if L == 0 else T // 2) * Ls
    nt = _bp_threads(g)
    return [[i + (i // Ls + L) * Ls for i in range(p, n_layer, nt)]
            for p in range(nt)]


def layer_rows(g, L):
    """Every row of layer L, in the order the threads take them."""
    return torch.as_tensor([r for rows in thread_rows(g, L) for r in rows],
                           dtype=torch.int64)


@pytest.mark.parametrize("name, cycles, T", [
    ("[[72, 12, 6]]", 6, 8), ("[[72, 12, 6]]", 5, 7),
    ("[[144, 12, 12]]", 12, 14)])
def test_half_pass_rows_cover_each_layer_once(name, cycles, T):
    """The union of the threads' rows in half L is the set of rows whose
    time slice has parity L, each row once; at [[144]] each thread of the
    512 holds at most one row a half."""
    g = _graphs(name, cycles, 0.004)["Z"]["graph"]
    Ls = g.ell * g.mm
    assert g.m == T * Ls
    slice_parity = (np.arange(g.m) // Ls) % 2
    for L in (0, 1):
        rows = layer_rows(g, L).numpy()
        assert len(rows) == len(set(rows.tolist()))
        assert np.array_equal(np.sort(rows), np.flatnonzero(slice_parity == L))
        if T == 14:
            assert max(len(r) for r in thread_rows(g, L)) == 1


def merge(state, new, rows):
    """The row states of ``rows`` replaced by ``new`` (both full (B, ...)
    tensors); the other rows keep theirs."""
    out = []
    for old, nw in zip(state, new):
        o = old.clone()
        o[..., rows] = nw[..., rows]
        out.append(o)
    return tuple(out)


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_compressed_state_rebuilds_plain_layered_messages(c72, basis):
    """Over a run of the plain layered algorithm, R rebuilt from the
    compressed state (each half committing only its layer's rows) equals
    the plain R bit for bit after every half-sweep, and the run has checks
    with tied minima."""
    d = c72[basis]
    g = d["graph"]
    syn = _syndromes(d, 48, 7)
    ctx = _PlainGraph(g, syn)
    B = len(syn)
    seq = torch.as_tensor(alpha_schedule("dynamical", 12))
    layer = (torch.arange(g.m) // (g.ell * g.mm)) % 2
    V = ctx.tabs["prior_grid"][None].expand(B, -1).clone()
    R = torch.zeros((B, g.EB, g.m))
    state = (torch.zeros((B, g.m)), torch.zeros((B, g.m)),
             torch.zeros((B, g.EB, g.m), dtype=torch.bool),
             torch.full((B, g.m), NO_EDGE))
    assert torch.equal(_bits(rebuild(state, ctx.live)), _bits(R))
    ties = 0
    for it in range(12):
        for L in (0, 1):
            Q = torch.clamp(V[:, ctx.idx] - R, -CLIP, CLIP)
            Qm = torch.where(ctx.live, Q, ctx.big)
            R = torch.where(layer == L, ctx.messages(Qm, seq[it]), R)
            state = merge(state, compress(Qm, ctx.live, seq[it], ctx.sgn_syn),
                          layer_rows(g, L))
            assert torch.equal(_bits(rebuild(state, ctx.live)), _bits(R)), \
                (it, L)
            absQ = Qm.abs()[..., layer == L]
            ties += int(((absQ == absQ.amin(1, keepdim=True)).sum(1)
                         > 1).sum())
            V = ctx.posteriors(R)
    assert ties > 0


def test_compressed_state_at_forced_ties_layered():
    """Halves of alternating layers on messages drawn from a few magnitudes,
    so most checks have two or more edges at m1: after every half the
    rebuilt R equals the plain layered R, with argmin in place of the
    is-min bits and the other layer's rows untouched."""
    rng = np.random.default_rng(5)
    B, EB, m = 32, 7, 48
    live = torch.as_tensor(rng.random((EB, m)) < 0.8)
    syn = torch.as_tensor(rng.integers(0, 2, (B, m)))
    layer = (torch.arange(m) // 6) % 2

    class Ctx:  # what _PlainGraph.messages reads
        pass
    ctx = Ctx()
    ctx.live, ctx.big = live, torch.tensor(_BIG)
    ctx.sgn_syn = 1.0 - 2.0 * syn.to(torch.float32)
    R = torch.zeros((B, EB, m))
    state = (torch.zeros((B, m)), torch.zeros((B, m)),
             torch.zeros((B, EB, m), dtype=torch.bool),
             torch.full((B, m), NO_EDGE))
    tied = 0.0
    for half in range(6):
        L = half % 2
        alpha = torch.tensor(0.5 + 0.0625 * half, dtype=torch.float32)
        Q = torch.as_tensor(rng.choice([-2.0, -1.0, 1.0, 2.0, 0.5, -0.5],
                                       (B, EB, m)).astype(np.float32))
        Qm = torch.where(live, Q, torch.tensor(_BIG))
        R = torch.where(layer == L, _PlainGraph.messages(ctx, Qm, alpha), R)
        state = merge(state, compress(Qm, live, alpha, ctx.sgn_syn),
                      torch.nonzero(layer == L)[:, 0])
        assert torch.equal(_bits(rebuild(state, live)), _bits(R)), half
        absQ = Qm.abs()
        tied += float(((absQ == absQ.amin(1, keepdim=True)).sum(1)
                       > 1).float().mean())
    assert tied / 6 > 0.5


def kernel_algorithm(g, syndrome, prior, alpha_seq, maxIter):
    """K3's algorithm over its own state, neighbour formulas and row
    mapping, vectorized over shots: the first half walks the even layer's
    rows (update and posterior-sign parity) and, where they all pass, the
    odd layer's rows (parity alone), the second half the odd layer's rows
    (update); each half's variable pass sums the rebuilt R of every row in
    edge-slot order, then adds the prior; each shot freezes at its
    convergence."""
    kn = KernelNeighbours(g)
    tabs = flood_tables(g, CPU)
    B, m, EB, NB = len(syndrome), g.m, g.EB, g.NB
    syn = syndrome.to(torch.int64)
    chk = [tuple(torch.as_tensor(a) for a in kn.check_side(e))
           for e in range(EB)]
    col = [tuple(torch.as_tensor(a) for a in kn.column_side(e))
           for e in range(EB)]
    rows = [layer_rows(g, L) for L in (0, 1)]
    sgn_syn = 1.0 - 2.0 * syn.to(torch.float32)
    pg = tabs["prior_grid"]
    V = pg[None].expand(B, -1).clone()
    state = (torch.zeros((B, m)), torch.zeros((B, m)),
             torch.zeros((B, EB, m), dtype=torch.bool),
             torch.full((B, m), NO_EDGE))
    done = torch.zeros(B, dtype=torch.bool)
    iters = torch.full((B,), maxIter - 1, dtype=torch.int32)

    def parity(rw):
        par = torch.zeros((B, len(rw)), dtype=torch.int64)
        for e in range(EB):
            lv, s = chk[e][0][rw], chk[e][1][rw]
            v = V[:, s.clamp(0, NB * m - 1)]
            par = par ^ ((v < 0.0) & lv).to(torch.int64)
        return par == syn[:, rw]

    def check_pass(rw, alpha):
        P1o, P2o, sgo, amino = (x[..., rw] for x in state)
        k = len(rw)
        m1 = torch.full((B, k), _BIG)
        m2 = torch.full((B, k), _BIG)
        amin = torch.full((B, k), NO_EDGE)
        sg = torch.zeros((B, EB, k), dtype=torch.bool)
        for e in range(EB):
            lv, s = chk[e][0][rw], chk[e][1][rw]
            v = V[:, s.clamp(0, NB * m - 1)]
            po = torch.where(amino == e, P2o, P1o)
            q = torch.clamp(v - torch.where(sgo[:, e], -po, po), -CLIP, CLIP)
            aq = q.abs()
            amin = torch.where(lv & (aq < m1), e, amin)
            m2 = torch.where(lv, torch.minimum(m2, torch.where(aq < m1, m1,
                                                               aq)), m2)
            m1 = torch.where(lv, torch.minimum(m1, aq), m1)
            sg[:, e] = lv & (q < 0.0)
        odd = (sg.sum(1) & 1) == 1
        a_s = alpha * (torch.where(odd, -1.0, 1.0) * sgn_syn[:, rw])
        new = [x.clone() for x in state]
        for full, part in zip(new, (a_s * m1, a_s * m2, sg, amin)):
            full[..., rw] = part
        return tuple(new)

    def column_pass():
        Vn = torch.empty_like(V)
        acc = torch.zeros((B, m))
        for e in range(EB):  # each pattern's posterior at its last slot
            lv, row = col[e]
            row = row.clamp(0, m - 1)
            P = torch.where(state[3][:, row] == e, state[1][:, row],
                            state[0][:, row])
            R = torch.where(state[2][:, e, row], -P, P)
            acc = torch.where(lv, acc + R, acc)
            if kn.gr.pb_last[e]:
                pb = kn.pattern(e)
                Vn[:, pb * m:(pb + 1) * m] = pg[pb * m:(pb + 1) * m] + acc
                acc = torch.zeros((B, m))
        return torch.where(done[:, None], V, Vn)

    for sw in range(maxIter + 1):
        if sw > 0:  # the odd rows are walked when the even ones pass
            ok = parity(rows[0]).all(1)
            ok = ok & parity(rows[1]).all(1)
            iters = torch.where(ok & ~done, torch.full_like(iters, sw - 1),
                                iters)
            done = done | ok
        if sw == maxIter or bool(done.all()):
            break
        for L in (0, 1):
            state = check_pass(rows[L], alpha_seq[sw])
            V = column_pass()
    values = torch.where(g.residual[None], prior[None],
                         V[:, tabs["out_gather"].long()])
    return dict(hard=(values < 0.0).to(torch.int8), converged=done,
                values=values, iterations=iters)


@pytest.mark.parametrize("cycles, basis", [(6, "Z"), (6, "X"), (5, "Z")])
def test_kernel_algorithm_matches_layered_plain(c72, c72_odd, cycles, basis):
    """K3's algorithm on its compressed state, computed neighbours and row
    mapping equals decode_batch_lift_layered_plain on every output, bit for
    bit, with converged and unconverged shots in the batch; T = 8 and, at 5
    cycles, T = 7 (an even layer one time slice larger)."""
    d = (c72 if cycles == 6 else c72_odd)[basis]
    g = d["graph"]
    syn = _syndromes(d, 40, 11)
    prior = torch.as_tensor(d["prior"])
    seq = torch.as_tensor(alpha_schedule("dynamical", 30))
    got = kernel_algorithm(g, syn, prior, seq, 30)
    want = decode_batch_lift_layered_plain(g, syn, prior, seq, 30)
    for k in ("hard", "converged", "iterations"):
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(_bits(got["values"]), _bits(want["values"]))
    assert want["converged"].any() and not want["converged"].all()
