"""The BP residual syndrome ``syndrome ^ H @ hard`` (kernel R1's function,
``ops/osd_cuda.py::bp_residual``) on the CPU: its plain version against
NumPy and against R1's own algorithm (the hard decision's set columns
XORed from the column index the kernel reads), ``osd_batch`` handed the
residual against computing it, and ``engine._osd_fallback``, which
computes it once for the pool, against the ordering and chunks it ran
before, with the ``osd.hard_ones`` counter. [[72,12,6]] at 3 and 6 cycles
(180 and 288 rows). Imports neither jax nor the JAX package."""
import numpy as np
import pytest
import torch

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.ops import osd
from qldpc_tpu_torch.ops.bp import alpha_schedule
from qldpc_tpu_torch.ops.osd_cuda import bp_residual, bp_residual_plain
from qldpc_tpu_torch.parallel import engine
from qldpc_tpu_torch.utils import telemetry

torch.set_num_threads(1)

P, MAXITER = 0.006, 20


@pytest.fixture(scope="module", params=[3, 6], ids=["c3", "c6"])
def setup(request):
    code = qt.get_code("[[72, 12, 6]]")
    circ = qt.SyndromeCircuit(code, num_cycles=request.param)
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, P)
    seq = alpha_schedule("dynamical", MAXITER)
    decs = [engine._make_basis(circ, M, b, seq, osd_order=2, device="cpu")
            for b in "ZX"]
    return circ, decs


@pytest.fixture
def traced():
    telemetry.reset()
    telemetry.enable()
    yield
    telemetry.disable()
    telemetry.reset()


def _r1_numpy(index, syndrome, hard):
    """R1's algorithm: per shot, XOR the rows of every column whose hard
    byte is odd into a bitset, then the syndrome."""
    colptr, rows = index.colptr.numpy(), index.rows.numpy()
    out = np.array(syndrome, np.int32)
    for b, h in enumerate(np.asarray(hard)):
        for j in np.flatnonzero(h & 1):
            out[b, rows[colptr[j]:colptr[j + 1]]] ^= 1
    return out


@pytest.mark.parametrize("density", [0.0, 0.01, 0.5, 1.0])
def test_plain_residual_matches_numpy(setup, density):
    """The plain residual and weight equal NumPy's ``(syndrome ^ H @ hard)
    % 2`` and R1's column XOR, with B not a multiple of 32, a shot of no
    set column and one of every column; at density 1 every row's count
    is far above 1."""
    _, decs = setup
    rng = np.random.default_rng(int(density * 100) + 7)
    for dec in decs:
        H = dec.H.numpy().astype(np.int64)
        m, n = H.shape
        B = 37
        hard = (rng.random((B, n)) < density).astype(np.int8)
        hard[0] = 0
        hard[1] = 1
        syn = (rng.random((B, m)) < 0.3).astype(np.int8)
        want = syn ^ ((hard.astype(np.int64) @ H.T) % 2)
        res, wt = bp_residual(torch.as_tensor(syn), torch.as_tensor(hard),
                              dec.HT, dec.col_index)
        assert res.dtype == torch.int32 and wt.dtype == torch.int32
        assert np.array_equal(res.numpy(), want)
        assert np.array_equal(wt.numpy(), want.sum(1))
        assert np.array_equal(_r1_numpy(dec.col_index, syn, hard), want)


def test_residual_reads_the_low_bit_of_each_hard_byte(setup):
    """A hard byte other than 0 and 1 counts by its low bit in the plain
    product as in R1's column XOR (-1 and 3 odd, 2 even)."""
    _, decs = setup
    dec = decs[0]
    m, n = dec.H.shape
    rng = np.random.default_rng(3)
    hard = rng.choice(np.array([0, 1, 2, 3, -1], np.int8), (9, n),
                      p=[0.9, 0.025, 0.025, 0.025, 0.025])
    syn = (rng.random((9, m)) < 0.3).astype(np.int8)
    res, _ = bp_residual_plain(torch.as_tensor(syn), torch.as_tensor(hard),
                               dec.HT)
    assert np.array_equal(res.numpy(),
                          _r1_numpy(dec.col_index, syn, hard))
    assert np.array_equal(res.numpy(), bp_residual_plain(
        torch.as_tensor(syn), torch.as_tensor(hard & 1), dec.HT)[0].numpy())


def _failed_shots(setup, basis, B, seed):
    """BP on ``B`` sampled shots of one basis: (decoder, syndromes,
    posteriors, hard decisions, converged)."""
    circ, decs = setup
    gen = torch.Generator().manual_seed(seed)
    trials = engine.trial_batch(gen, P, decs[0].maps, decs[1].maps,
                                circ.num_error_locs, B)
    dec = decs["zx".index(basis)]
    syn = trials[f"syndrome_{basis}"]
    bp = engine._bp_one_basis(syn, dec, MAXITER)
    return dec, syn, bp["values"], bp["hard"], bp["converged"]


def test_osd_batch_given_the_residual(setup):
    """``osd_batch(..., residual=r)`` gives every output ``osd_batch``
    gives when it computes the residual itself, and ignores the
    syndrome."""
    dec, syn, values, hard, conv = _failed_shots(setup, "z", 96, 5)
    fail = ~conv
    assert int(fail.sum()) > 4
    s, v, h = syn[fail], values[fail], hard[fail]
    kw = dict(K=dec.K, order=2, num_test=dec.num_test, rank=dec.rank,
              basis_cols=dec.basis_cols, logical_pack=dec.logical_pack,
              col_index=dec.col_index)
    want = osd.osd_batch(dec.H, dec.HT, s, v, h, **kw)
    r = bp_residual(s, h, dec.HT, dec.col_index)[0]
    got = osd.osd_batch(dec.H, dec.HT, None, v, h, residual=r, **kw)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(osd.osd_batch(dec.H, dec.HT, None, v, h, residual=r,
                                     stop_after="residual", **kw)[0], r)
    with pytest.raises(ValueError):
        osd.osd_batch(dec.H, dec.HT, None, v, h, residual=r[1:], **kw)


def _fallback_before(syndrome, values, hard, conv, dec, chunk):
    """``engine._osd_fallback`` as it ran before the residual was computed
    once: the residual weight by the float32 product in the ordering, and
    each chunk's ``osd_batch`` computing the residual again."""
    B, m = syndrome.shape
    res_wt = (syndrome.to(torch.int32)
              ^ ((hard.to(torch.float32) @ dec.HT).to(torch.int32) & 1)
              ).sum(1)
    order = torch.sort(torch.where(conv, m + 1, res_wt), stable=True).indices
    n_fail = (~conv).sum()
    delta = torch.zeros(B, dtype=torch.int32)
    rdef = torch.zeros(B, dtype=torch.bool)
    overflow = torch.zeros(B, dtype=torch.bool)
    for c0 in range(0, B, chunk):
        idx = order[c0:c0 + chunk]
        out = osd.osd_batch(
            dec.H, dec.HT, syndrome[idx], values[idx], hard[idx], K=dec.K,
            order=2, num_test=dec.num_test, rank=dec.rank,
            basis_cols=dec.basis_cols, logical_pack=dec.logical_pack,
            return_solution=False, n_live=(n_fail - c0).clamp(0, len(idx)),
            reprocess_slice=osd.REPROCESS_SLICE, col_index=dec.col_index)
        delta.index_copy_(0, idx, out["logical_delta_packed"])
        rdef.index_copy_(0, idx, out["rank_deficient"])
        overflow.index_copy_(0, idx, out["reprocess_overflow"])
    return torch.where(conv, 0, delta), rdef & ~conv, overflow & ~conv


@pytest.mark.parametrize("chunk", [96, 32])
def test_osd_fallback_as_before_and_its_counter(setup, chunk):
    """``_osd_fallback`` gives the delta, rank-deficiency and overflow
    flags of the ordering and chunks it ran before, in one chunk and in
    three; with telemetry on ``osd.order`` counts ``osd.hard_ones``, the
    hard decision's set bits, and no other span does; off, nothing is
    recorded."""
    for basis in "zx":
        dec, syn, values, hard, conv = _failed_shots(setup, basis, 96, 9)
        assert 0 < int((~conv).sum()) < 96
        want = _fallback_before(syn, values, hard, conv, dec, chunk)
        telemetry.reset()
        got = engine._osd_fallback(syn, values, hard, conv, dec, 2, chunk)
        assert telemetry.export()["spans"] == []
        for w, g in zip(want, got):
            assert torch.equal(w, g)
        telemetry.enable()
        try:
            again = engine._osd_fallback(syn, values, hard, conv, dec, 2,
                                         chunk)
            spans = telemetry.export()["spans"]
        finally:
            telemetry.disable()
            telemetry.reset()
        for w, g in zip(want, again):
            assert torch.equal(w, g)
        counted = [(s["name"], s["counters"]["osd.hard_ones"])
                   for s in spans if "osd.hard_ones" in s["counters"]]
        assert counted == [("osd.order", int(hard.sum()))]


def test_osd_batch_counts_its_own_residual(setup, traced):
    """``osd_batch`` without a residual computes it in ``osd.prep`` and
    counts ``osd.hard_ones`` there."""
    dec, syn, values, hard, conv = _failed_shots(setup, "z", 64, 13)
    fail = ~conv
    with telemetry.span("osd"):
        osd.osd_batch(dec.H, dec.HT, syn[fail], values[fail], hard[fail],
                      K=dec.K, rank=dec.rank, basis_cols=dec.basis_cols,
                      col_index=dec.col_index)
    spans = telemetry.export()["spans"]
    counted = [(s["name"], s["counters"]["osd.hard_ones"])
               for s in spans if "osd.hard_ones" in s["counters"]]
    assert counted == [("osd.prep", int(hard[fail].sum()))]
