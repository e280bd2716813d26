"""The two ingredients of kernel K1's design, held on the CPU.

K1 (qldpc_tpu_torch/csrc/bp_lift_flood.cu) reads no neighbour table and
stores no edge message: it computes neighbours from the lift's per-edge
constants and per-position live bits (``bp_lift_cuda.flood_geometry``), and
keeps each check row's messages as two products P1 = (alpha*sgn)*m1,
P2 = (alpha*sgn)*m2, the q-sign bits and the first edge slot reaching m1
(argmin). The kernel itself runs only on the card; here its formulas and
its state, written out in PyTorch, are held against the plain version
(``decode_batch_lift_plain`` and ``_PlainGraph``):

* the neighbour formulas reproduce ``flood_tables`` entry for entry;
* R rebuilt from the compressed state is bit-equal to the plain R at every
  iteration, tied minima included;
* the kernel's whole algorithm on that state and those formulas gives the
  plain version's outputs bit for bit.
"""
import numpy as np
import pytest
import torch

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.ops.bp import alpha_schedule
from qldpc_tpu_torch.ops.bp_lift import LiftedGraph
from qldpc_tpu_torch.ops.bp_lift_cuda import (_BIG, _MAX_EB as MAX_EB,
                                              _PlainGraph,
                                              decode_batch_lift_plain,
                                              flood_geometry, flood_tables)

torch.set_num_threads(1)

CPU = torch.device("cpu")
NO_EDGE = 63  # the kernel's argmin before any edge is seen
CLIP = 20.0


def _graphs(name, cycles, p):
    code = qt.get_code(name)
    circ = qt.SyndromeCircuit(code, num_cycles=cycles)
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, p)
    out = {}
    for basis in "ZX":
        H = (np.asarray(M[f"Hdec{basis}"]) != 0).astype(np.uint8)
        prior = qt.channel_llrs(M[f"channel_probs{basis}"]).astype(np.float32)
        g = LiftedGraph.try_from_dense(H, code.ell, code.m, prior,
                                       device="cpu")
        out[basis] = dict(graph=g, H=H, prior=prior,
                          probs=M[f"channel_probs{basis}"])
    return out


@pytest.fixture(scope="module")
def c72():
    return _graphs("[[72, 12, 6]]", 6, 0.006)


@pytest.fixture(scope="module")
def c144():
    return _graphs("[[144, 12, 12]]", 12, 0.004)


@pytest.fixture(scope="module")
def c288():
    return _graphs("[[288, 12, 18]]", 18, 0.004)


def _syndromes(d, B, seed):
    rng = np.random.default_rng(seed)
    errs = (rng.random((B, d["H"].shape[1])) < d["probs"]).astype(np.int8)
    return torch.as_tensor((errs @ d["H"].T) % 2).to(torch.int8)


class KernelNeighbours:
    """The kernel's neighbour arithmetic, from the ``FloodGraph`` parameter,
    the wrap tables and ``pos_info`` exactly as the kernel receives them."""

    def __init__(self, g):
        geo = flood_geometry(g, CPU)
        self.gr = gr = geo["graph"]
        L = g.ell * g.mm
        self.wrap = (geo["wrap_words"].numpy().view(np.uint8)
                     [:2 * L * MAX_EB].reshape(2, L, MAX_EB))
        pos = geo["pos_info"].numpy().view(np.uint32).astype(np.int64)
        self.chk_live, self.col_live = pos[:, 0:2], pos[:, 4:6]
        self.xy = pos[:, 2]
        assert np.array_equal(pos[:, 6], self.xy)
        self.r = np.arange(gr.P)

    def check_side(self, e):
        """(live, column slot) of edge e at every check row."""
        s = (self.r + self.gr.chk_off[e] // 4
             + self.wrap[0, self.xy, e].astype(np.int64))
        return self._live(self.chk_live, e), s

    def column_side(self, e):
        """(live, check row) of edge e at every column position."""
        row = (self.r + self.gr.col_off[e] // 16
               - self.wrap[1, self.xy, e].astype(np.int64))
        return self._live(self.col_live, e), row

    @staticmethod
    def _live(words, e):  # slot 32w + i sits at bit 31 - i of word w
        return ((words[:, e // 32] >> (31 - e % 32)) & 1).astype(bool)

    def pattern(self, e):
        return self.gr.pb_off[e] // (4 * self.gr.P)


def _check_formulas(g):
    tabs = flood_tables(g, CPU)
    kn = KernelNeighbours(g)
    chk, col = tabs["chk_nbr"].numpy(), tabs["col_chk"].numpy()
    pb_start = tabs["pb_start"].numpy()
    for e in range(g.EB):
        assert pb_start[kn.pattern(e)] <= e < pb_start[kn.pattern(e) + 1]
        assert kn.gr.pb_last[e] == (e + 1 in pb_start)
        live, s = kn.check_side(e)
        assert np.array_equal(np.where(live, s, -1), chk[e]), e
        live, row = kn.column_side(e)
        assert np.array_equal(np.where(live, row, -1), col[e]), e


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_neighbour_formula_matches_flood_tables(c72, basis):
    _check_formulas(c72[basis]["graph"])


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_neighbour_formula_matches_flood_tables_144(c144, basis):
    _check_formulas(c144[basis]["graph"])


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_neighbour_formula_matches_flood_tables_288(c288, basis):
    """[[288,12,18]], the largest code whose state K1 keeps in shared
    memory: its wraps run to ell*mm + mm = 156."""
    _check_formulas(c288[basis]["graph"])


def compress(Q, live, alpha, sgn_syn):
    """The kernel's row state from Q (B, EB, m), dead edges ignored: one
    walk over the edge slots in order, argmin the first slot with |q| < m1
    (the strict test), then P1 = (alpha*sgn)*m1, P2 = (alpha*sgn)*m2."""
    B, EB, m = Q.shape
    m1 = torch.full((B, m), _BIG)
    m2 = torch.full((B, m), _BIG)
    amin = torch.full((B, m), NO_EDGE)
    for e in range(EB):
        aq = Q[:, e].abs()
        lv = live[e]
        amin = torch.where(lv & (aq < m1), e, amin)
        m2 = torch.where(lv, torch.minimum(m2, torch.where(aq < m1, m1, aq)),
                         m2)
        m1 = torch.where(lv, torch.minimum(m1, aq), m1)
    neg = (Q < 0.0) & live
    odd = (neg.sum(1) & 1) == 1
    a_s = alpha * (torch.where(odd, -1.0, 1.0) * sgn_syn)
    return a_s * m1, a_s * m2, neg, amin


def rebuild(state, live):
    """R (B, EB, m) from the row state: sign ? -P : P with
    P = (e == argmin) ? P2 : P1; dead edges 0."""
    P1, P2, neg, amin = state
    e_ids = torch.arange(neg.shape[1])[None, :, None]
    P = torch.where(e_ids == amin[:, None], P2[:, None], P1[:, None])
    return torch.where(live, torch.where(neg, -P, P), 0.0)


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_compressed_state_rebuilds_plain_messages(c72, basis):
    """Over a run of the plain algorithm, R rebuilt from the compressed
    state equals _PlainGraph.messages' R bit for bit (-0.0 included), and
    the run has checks with tied minima."""
    d = c72[basis]
    g = d["graph"]
    syn = _syndromes(d, 48, 7)
    ctx = _PlainGraph(g, syn)
    seq = torch.as_tensor(alpha_schedule("dynamical", 12))
    V = ctx.tabs["prior_grid"][None].expand(len(syn), -1).clone()
    R = torch.zeros((len(syn), g.EB, g.m))
    ties = 0
    for it in range(12):
        Vc = V[:, ctx.idx]
        Q = Vc if it == 0 else torch.clamp(Vc - R, -CLIP, CLIP)
        Qm = torch.where(ctx.live, Q, ctx.big)
        R = ctx.messages(Qm, seq[it])
        state = compress(Qm, ctx.live, seq[it], ctx.sgn_syn)
        assert torch.equal(_bits(rebuild(state, ctx.live)), _bits(R)), it
        absQ = Qm.abs()
        ties += int(((absQ == absQ.amin(1, keepdim=True)).sum(1) > 1).sum())
        V = ctx.posteriors(R)
    assert ties > 0


def test_compressed_state_at_forced_ties():
    """Messages drawn from a few magnitudes, so most checks have two or
    more edges at m1 (and some at m2): the rebuild still equals the plain
    R, with argmin in place of the is-min bits."""
    rng = np.random.default_rng(3)
    B, EB, m = 64, 7, 40
    Q = torch.as_tensor(rng.choice([-2.0, -1.0, 1.0, 2.0, 0.5, -0.5],
                                   (B, EB, m)).astype(np.float32))
    live = torch.as_tensor(rng.random((EB, m)) < 0.8)
    Qm = torch.where(live, Q, torch.tensor(_BIG))
    syn = torch.as_tensor(rng.integers(0, 2, (B, m)))
    sgn_syn = 1.0 - 2.0 * syn.to(torch.float32)
    alpha = torch.tensor(0.8125, dtype=torch.float32)

    class Ctx:  # what _PlainGraph.messages reads
        pass
    ctx = Ctx()
    ctx.live, ctx.sgn_syn, ctx.big = live, sgn_syn, torch.tensor(_BIG)
    R = _PlainGraph.messages(ctx, Qm, alpha)
    state = compress(Qm, live, alpha, sgn_syn)
    assert torch.equal(_bits(rebuild(state, live)), _bits(R))
    absQ = Qm.abs()
    tied = (absQ == absQ.amin(1, keepdim=True)).sum(1) > 1
    assert tied.float().mean() > 0.5


def kernel_algorithm(g, syndrome, prior, alpha_seq, maxIter):
    """K1's algorithm over its own state and neighbour formulas, vectorized
    over shots: the check pass walks each row's edge slots once, rebuilding
    the old R from the row state and folding the posterior's sign into the
    convergence parity; the variable pass sums the rebuilt R in edge-slot
    order, then adds the prior; each shot freezes at its convergence."""
    kn = KernelNeighbours(g)
    tabs = flood_tables(g, CPU)
    B, m, EB, NB = len(syndrome), g.m, g.EB, g.NB
    syn = syndrome.to(torch.int64)
    chk = [tuple(torch.as_tensor(a) for a in kn.check_side(e))
           for e in range(EB)]
    col = [tuple(torch.as_tensor(a) for a in kn.column_side(e))
           for e in range(EB)]
    sgn_syn = 1.0 - 2.0 * syn.to(torch.float32)
    pg = tabs["prior_grid"]
    V = pg[None].expand(B, -1).clone()
    state = (torch.zeros((B, m)), torch.zeros((B, m)),
             torch.zeros((B, EB, m), dtype=torch.bool),
             torch.full((B, m), NO_EDGE))
    done = torch.zeros(B, dtype=torch.bool)
    iters = torch.full((B,), maxIter - 1, dtype=torch.int32)
    for it in range(maxIter + 1):
        P1o, P2o, sgo, amino = state
        m1 = torch.full((B, m), _BIG)
        m2 = torch.full((B, m), _BIG)
        amin = torch.full((B, m), NO_EDGE)
        sg = torch.zeros((B, EB, m), dtype=torch.bool)
        par = torch.zeros((B, m), dtype=torch.int64)
        for e in range(EB):
            lv, s = chk[e]
            v = V[:, s.clamp(0, NB * m - 1)]
            par = par ^ ((v < 0.0) & lv).to(torch.int64)
            q = v
            if it > 0:
                po = torch.where(amino == e, P2o, P1o)
                q = torch.clamp(v - torch.where(sgo[:, e], -po, po),
                                -CLIP, CLIP)
            aq = q.abs()
            amin = torch.where(lv & (aq < m1), e, amin)
            m2 = torch.where(lv, torch.minimum(m2, torch.where(aq < m1, m1,
                                                               aq)), m2)
            m1 = torch.where(lv, torch.minimum(m1, aq), m1)
            sg[:, e] = lv & (q < 0.0)
        ok = (par == syn).all(1)
        if it > 0:
            iters = torch.where(ok & ~done, torch.full_like(iters, it - 1),
                                iters)
            done = done | ok
        if it == maxIter or bool(done.all()):
            break
        odd = (sg.sum(1) & 1) == 1
        a_s = alpha_seq[it] * (torch.where(odd, -1.0, 1.0) * sgn_syn)
        state = (a_s * m1, a_s * m2, sg, amin)
        Vn = torch.empty_like(V)
        acc = torch.zeros((B, m))
        for e in range(EB):  # each pattern's posterior at its last slot
            lv, row = col[e]
            row = row.clamp(0, m - 1)
            P = torch.where(amin[:, row] == e, state[1][:, row],
                            state[0][:, row])
            R = torch.where(sg[:, e, row], -P, P)
            acc = torch.where(lv, acc + R, acc)
            if kn.gr.pb_last[e]:
                pb = kn.pattern(e)
                Vn[:, pb * m:(pb + 1) * m] = pg[pb * m:(pb + 1) * m] + acc
                acc = torch.zeros((B, m))
        V = torch.where(done[:, None], V, Vn)
    values = torch.where(g.residual[None], prior[None],
                         V[:, tabs["out_gather"].long()])
    return dict(hard=(values < 0.0).to(torch.int8), converged=done,
                values=values, iterations=iters)


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_kernel_algorithm_matches_plain(c72, basis):
    """The kernel's algorithm on its compressed state and computed
    neighbours equals decode_batch_lift_plain on every output, bit for
    bit, with converged and unconverged shots in the batch."""
    d = c72[basis]
    g = d["graph"]
    syn = _syndromes(d, 40, 11)
    prior = torch.as_tensor(d["prior"])
    seq = torch.as_tensor(alpha_schedule("dynamical", 30))
    got = kernel_algorithm(g, syn, prior, seq, 30)
    want = decode_batch_lift_plain(g, syn, prior, seq, 30)
    for k in ("hard", "converged", "iterations"):
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(_bits(got["values"]), _bits(want["values"]))
    assert want["converged"].any() and not want["converged"].all()
