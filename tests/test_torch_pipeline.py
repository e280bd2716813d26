"""The port's asynchronous round, on the CPU: the gates the kernels read,
the gather-pack G1, the OSD's reprocess slice and the stopping loop with
two dispatches in flight.

* G1 (``csrc/gather_pack.cu``): its index arithmetic (a warp per shot and
  32-column group, lane c on column 32w + c, its bits ORed into its own
  column of the warp's tile, the tile stored whole) emulated in numpy and
  held against the plain version (``_gather_pack`` bit-transposed into the
  eliminators' column layout) over the whole batch, a partial range and an
  empty one, at an odd and an even batch, with the stride odd and its
  padding words zero; and the wrapper's plain path with a gate.
* The gated plain eliminators equal their ungated call on the live shots.
* ``osd_batch``: a batch decoded with ``n_live`` equals the live prefix
  decoded alone; a reprocess slice too small flags its overflow, and the
  replay with the whole batch as the slice equals the unforced call.
* ``_drive_stopping_rounds`` at depth 1 and depth 2 gives identical
  tallies with real pooled dispatches (a crossing round, a truncated
  round, two streams), and a forced reprocess overflow is replayed to the
  same tallies.

[[72,12,6]]; no JAX needed (the JAX-held checks of the same paths are in
tests/test_torch_osd.py and tests/test_torch_engine.py).
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.models.builder import channel_llrs
from qldpc_tpu_torch.models.gf2 import column_basis, rank_fast
from qldpc_tpu_torch.ops import osd, osd_cuda
from qldpc_tpu_torch.ops.bp import alpha_schedule
from qldpc_tpu_torch.ops.bp_lift import LiftedGraph
from qldpc_tpu_torch.ops.bp_lift_cuda import decode_batch_lift_plain
from qldpc_tpu_torch.parallel import engine, mesh

torch.set_num_threads(1)

SRC = (Path(__file__).resolve().parent.parent / "qldpc_tpu_torch" / "csrc"
       / "gather_pack.cu").read_text()
GPC_WARPS, GPC_DEG = (int(re.search(rf"^#define {name} (\d+)\b", SRC,
                                     re.M).group(1))
                      for name in ("GPC_WARPS", "GPC_DEG"))
SPANS = [None, (5, 23), (9, 9)]


@pytest.fixture(scope="module")
def code72():
    code = qt.get_code("[[72, 12, 6]]")
    circ = qt.SyndromeCircuit(code, num_cycles=6)
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, 0.006)
    return code, circ, M


@pytest.fixture(scope="module")
def failed72(code72):
    """BP-failed [[72,12,6]] basis-Z shots (6 cycles, p=0.006)."""
    code, _, M = code72
    H = (np.asarray(M["HdecZ"]) != 0).astype(np.uint8)
    prior = channel_llrs(M["channel_probsZ"])
    rng = np.random.default_rng(2)
    errs = (rng.random((96, H.shape[1])) < M["channel_probsZ"])
    syn = ((errs.astype(np.int8) @ H.T) % 2).astype(np.int8)
    g = LiftedGraph.try_from_dense(H, code.ell, code.m, prior, device="cpu")
    bp = decode_batch_lift_plain(
        g, torch.as_tensor(syn), torch.as_tensor(prior, dtype=torch.float32),
        torch.as_tensor(alpha_schedule("dynamical", 12)), 12)
    fail = ~bp["converged"]
    k, first = M["k"], M["first_logical_rowZ"]
    HL = (np.asarray(M["HZ_full"])[first:first + k] != 0).astype(np.int64)
    return dict(H=H, syn=torch.as_tensor(syn)[fail],
                vals=bp["values"][fail], hard=bp["hard"][fail],
                lp=torch.as_tensor((HL << np.arange(k)[:, None]).sum(0)
                                   .astype(np.int32)),
                rank=rank_fast(H), basis=torch.as_tensor(column_basis(H)))


def _emulate_gather_pack(index, cols, ld, K, W, S, span):
    """gather_pack.cu's kernel in numpy: a warp per (shot, 32-column group)
    task, GPC_WARPS tasks a block; lane c ORs the bits of column 32w + c,
    its first GPC_DEG rows loaded up front and the rest after, into its own
    S words of the warp's zeroed tile; the tile goes to the output whole.
    (B, 32W, S) uint32 words, gated-off shots unwritten (zero here)."""
    colptr, rows = index.colptr.numpy(), index.rows.numpy()
    flat = cols.reshape(-1)
    B = len(cols)
    out = np.zeros((B, 32 * W, S), np.uint32)
    lo, hi = (0, B) if span is None else span
    for block in range(-(-B * W // GPC_WARPS)):      # blockIdx.x
        for warp in range(GPC_WARPS):
            task = block * GPC_WARPS + warp
            if task >= B * W:
                continue                             # past the last task
            b, w = divmod(task, W)
            if not lo <= b < hi:
                continue                             # gated off
            tile = np.zeros((32, S), np.uint32)
            for lane in range(32):
                c = 32 * w + lane
                if c >= K:
                    continue
                j = flat[b * ld + c]
                e, e1 = colptr[j], colptr[j + 1]
                first = [rows[e + d] if e + d < e1 else -1
                         for d in range(GPC_DEG)]
                rest = rows[e + GPC_DEG:e1]
                for r in [r for r in first if r >= 0] + list(rest):
                    tile[lane, r >> 5] |= np.uint32(1 << (r & 31))
            # 8 S 16-byte vectors, lane i storing i, i + 32, ...: the tile
            # is 32 S contiguous words of the output, starting at column 32w
            out[b, 32 * w:32 * w + 32] = tile
    return out


@pytest.mark.parametrize("B", [23, 32])
@pytest.mark.parametrize("span", SPANS)
def test_gather_pack_emulation_matches_plain(code72, span, B):
    """The kernel's arithmetic gives the plain version's column words on
    every live shot, from a column-order view with a row stride (the sort
    indices' prefix) and a partial last word, at an odd and an even batch;
    S is odd and every padding word is zero. The wrapper's plain path gated
    the same way equals it and reads zero elsewhere."""
    _, _, M = code72
    H = (np.asarray(M["HdecZ"]) != 0).astype(np.uint8)
    index = osd_cuda.column_index(H)
    m, n = H.shape
    rng = np.random.default_rng(4)
    order = torch.as_tensor(np.stack([rng.permutation(n)
                                      for _ in range(B)]))
    K, Kp = 200, 224
    cols = order[:, :K]
    assert cols.stride(0) == n                       # a view: ld = n
    S = osd_cuda.column_stride(Kp // 32, m, "cpu")
    assert S % 2 == 1 and S == -(-m // 32) | 1
    lo, hi = (0, B) if span is None else (span[0], min(span[1], B))
    got = _emulate_gather_pack(index, order.numpy(), n, K, Kp // 32, S,
                               (lo, hi))
    want = osd_cuda.words_to_columns(
        osd_cuda._gather_pack(index.HT, cols, Kp, words_major=True), S)
    assert want.shape == (B, Kp, S)
    assert np.array_equal(got[lo:hi].view(np.int32), want[lo:hi].numpy())
    assert not want[:, K:].any()                     # columns past K
    assert not want[..., -(-m // 32):].any()         # the stride's padding
    live = None if span is None else torch.tensor(span, dtype=torch.int32)
    plain = osd_cuda.gather_pack(index, cols, Kp, live=live)
    assert torch.equal(plain[lo:hi], want[lo:hi])
    off = torch.ones(B, dtype=torch.bool)
    off[lo:hi] = False
    assert not plain[off].any()


@pytest.mark.parametrize("span", [(3, 29), (0, 0), (0, 40), (17, 18)])
@pytest.mark.parametrize("plain", ["eliminate_blocks_plain",
                                   "eliminate_blocks_fused_plain"])
def test_gated_plain_eliminators_match_ungated(failed72, plain, span):
    """K2's / K5's and K4's plain versions gated to [lo, hi) equal their
    ungated call on the live shots; the others record no pivot and no
    step."""
    d = failed72
    H, K = d["H"], 256
    B, m = 40, d["H"].shape[0]
    cols = torch.sort(d["vals"][:B].abs(), dim=1, stable=True).indices
    Hp = osd_cuda._gather_pack(torch.as_tensor(H.T.copy()), cols[:, :K], K,
                               words_major=True)
    s = (d["syn"][:B].to(torch.int32)
         ^ ((d["hard"][:B].float() @ torch.as_tensor(H.T.astype(np.float32))
             ).to(torch.int32) & 1))
    fn = getattr(osd_cuda, plain)
    full = fn(Hp, s, K, m, rank=d["rank"], return_steps=True)
    gated = fn(Hp, s, K, m, rank=d["rank"], return_steps=True,
               live=torch.tensor(span, dtype=torch.int32))
    lo, hi = span
    for name, x, y in zip(("Hp", "s", "prow", "used", "colofrow", "steps"),
                          gated, full):
        assert torch.equal(x[lo:hi], y[lo:hi]), name
    off = torch.ones(B, dtype=torch.bool)
    off[lo:hi] = False
    assert (gated[4][off] == -1).all() and (gated[5][off] == 0).all()
    assert not gated[3][off].any() and (gated[2][off] == -1).all()
    assert int(full[5].max()) > 0


def _osd(d, n, **kw):
    H = d["H"]
    return osd.osd_batch(
        torch.as_tensor(H), torch.as_tensor(H.T.astype(np.float32)),
        d["syn"][:n], d["vals"][:n], d["hard"][:n], logical_pack=d["lp"],
        rank=d["rank"], return_solution=False, **kw)


def test_osd_batch_live_prefix_equals_alone(failed72):
    """A batch decoded with n_live = 13 (staged scan, basis rerun, order-2
    reprocess slice) gives the 13 live shots what decoding them alone
    gives."""
    d = failed72
    kw = dict(K=512, order=2, num_test=12, basis_cols=d["basis"],
              reprocess_slice=osd.REPROCESS_SLICE)
    gated = _osd(d, 40, n_live=torch.tensor(13), **kw)
    alone = _osd(d, 13, **kw)
    for key in ("valid", "rank_deficient", "logical_delta_packed",
                "reprocess_overflow"):
        assert torch.equal(gated[key][:13], alone[key]), key
    assert not gated["reprocess_overflow"].any()


def test_reprocess_slice_overflow_and_replay(failed72):
    """A narrow K without the basis leaves shots truncation-deficient: with
    a slice of one shot the others that failed OSD-0 are flagged, and keep
    OSD-0's answer; the replay with the whole batch as the slice equals
    the call whose slice holds every failure."""
    d = failed72
    kw = dict(K=64, order=1, num_test=11)
    forced = _osd(d, 24, reprocess_slice=1, **kw)
    unforced = _osd(d, 24, reprocess_slice=osd.REPROCESS_SLICE, **kw)
    replay = _osd(d, 24, reprocess_slice=None, **kw)
    failed = forced["rank_deficient"]
    assert int(failed.sum()) > 1
    over = forced["reprocess_overflow"]
    first = int(torch.nonzero(failed)[0, 0])
    assert torch.equal(over, failed & (torch.arange(24) != first))
    assert not unforced["reprocess_overflow"].any()
    for key in ("valid", "rank_deficient", "logical_delta_packed",
                "reprocess_overflow"):
        assert torch.equal(replay[key], unforced[key]), key
    # the shots the slice held are final; the flagged ones keep OSD-0's
    # answer, which the order-1 search changes on some of them
    keep = ~over
    osd0 = _osd(d, 24, K=64, order=0, num_test=0)
    for key in ("valid", "logical_delta_packed"):
        assert torch.equal(forced[key][keep], unforced[key][keep]), key
        assert torch.equal(forced[key][over], osd0[key][over]), key
    assert not torch.equal(unforced["logical_delta_packed"][over],
                           osd0["logical_delta_packed"][over])


# the stopping loop: [[72]] 6 cycles, p=0.006, maxIter 12, 2 rounds of 32
# shots a dispatch
P, MAXITER, BATCH, ROUNDS = 0.006, 12, 32, 2


@pytest.fixture(scope="module")
def decoders(code72):
    _, circ, M = code72
    seq = alpha_schedule("dynamical", MAXITER)
    return circ, [engine._make_basis(circ, M, b, seq, osd_order=1,
                                     device="cpu") for b in "ZX"]


def _loop(dispatch, gens, depth, n_streams, target, max_trials):
    return engine._drive_stopping_rounds(
        dispatch, mesh.gather_flags, n_streams, BATCH * ROUNDS, max_trials,
        target, False, [f"s{i}" for i in range(n_streams)],
        pipeline_depth=depth, generators=gens)


def _single(circ, decs, depth, target, max_trials, seed=3):
    fn = mesh.shard_rounds(engine.make_pooled_round_fn(
        *decs, circ.num_error_locs, P, BATCH, MAXITER, 1, ROUNDS),
        mesh.shot_mesh())
    gen = torch.Generator().manual_seed(seed)
    calls = []

    def dispatch(ri, replay=False):
        calls.append((ri, replay))
        return [fn([gen], replay=replay)]

    out = _loop(dispatch, [gen], depth, 1, target, max_trials)
    return out, calls


def _tallies(out):
    return {k: out[k] for k in ("trials", "z_errs", "x_errs", "tot_errs",
                                "rankdef", "replays")}


@pytest.mark.parametrize("target, max_trials", [(45, 10_000), (None, 150)])
def test_stopping_loop_depths_agree(decoders, target, max_trials):
    """Depth 1 and depth 2 give the same tallies: a run that crosses its
    error target inside a round, and one cut by max_trials inside a round;
    at depth 2 one more dispatch is issued than consumed."""
    circ, decs = decoders
    one, calls1 = _single(circ, decs, 1, target, max_trials)
    two, calls2 = _single(circ, decs, 2, target, max_trials)
    assert _tallies(one) == _tallies(two)
    if target:
        assert one["tot_errs"] == [target]
        assert one["trials"][0] % (BATCH * ROUNDS)  # crossed inside a round
    else:
        assert one["trials"] == [max_trials]
    assert len(calls2) == len(calls1) + 1
    assert not any(r for _, r in calls1 + calls2)


def test_stopping_loop_two_streams(decoders):
    """Two streams (one dispatch decodes both, each from its own
    generator): each stops at its own crossing, and depth 2 equals depth
    1."""
    circ, decs = decoders
    spec = dict(dec_z=decs[0], dec_x=decs[1], n_locs=circ.num_error_locs,
                error_rate=P, batch=BATCH, maxIter=MAXITER, osd_order=1)
    fn = mesh.shard_rounds(engine.make_multi_code_pooled_round_fn(
        [spec, spec], ROUNDS), mesh.shot_mesh())
    runs = []
    for depth in (1, 2):
        gens = [torch.Generator().manual_seed(s) for s in (5, 6)]
        runs.append(_loop(lambda ri, replay=False: fn([gens], replay=replay),
                          gens, depth, 2, 30, 10_000))
    assert _tallies(runs[0]) == _tallies(runs[1])
    assert runs[0]["tot_errs"] == [30, 30]
    assert runs[0]["trials"][0] != runs[0]["trials"][1]


def test_forced_overflow_is_replayed(decoders, monkeypatch):
    """Decoders with a narrow K and no basis fail OSD-0 on some shots; with
    a reprocess slice of 0 every such round overflows and is replayed with
    whole chunks, from its saved generator state (at depth 2 while the next
    dispatch is already issued): the tallies equal the run whose slice
    never overflows."""
    circ, decs = decoders
    narrow = [dataclasses.replace(d, K=64, basis_cols=None) for d in decs]
    monkeypatch.setattr(osd, "REPROCESS_SLICE", BATCH * ROUNDS)
    want, _ = _single(circ, narrow, 1, 40, 10_000)
    assert want["replays"] == 0 and want["rankdef"][0] > 0
    monkeypatch.setattr(osd, "REPROCESS_SLICE", 0)
    for depth in (1, 2):
        got, calls = _single(circ, narrow, depth, 40, 10_000)
        assert got["replays"] > 0
        assert sum(r for _, r in calls) == got["replays"]
        assert {k: v for k, v in _tallies(got).items() if k != "replays"} \
            == {k: v for k, v in _tallies(want).items() if k != "replays"}


def test_osd_fallback_delta_is_zero_on_converged_shots(decoders, monkeypatch):
    """``osd_batch``'s outputs past its live shots are unspecified (on the
    card they are whatever the allocator held); ``_osd_fallback`` gives
    the converged shots a delta of 0, whatever ``osd_batch`` left there,
    and the unconverged ones their own."""
    circ, decs = decoders
    dec = decs[0]
    g = torch.Generator().manual_seed(5)
    shape = (2 * BATCH, circ.num_error_locs)
    err = torch.rand(shape, generator=g) < P
    c = torch.randint(0, 45, shape, generator=g, dtype=torch.int32)
    syn = engine.trial_batch(None, P, decs[0].maps, decs[1].maps,
                             circ.num_error_locs, 2 * BATCH,
                             (err, c % 3, c // 3))["syndrome_z"]
    bp = engine._bp_one_basis(syn, dec, MAXITER)
    conv = bp["converged"]
    assert 0 < int(conv.sum()) < len(conv)
    args = (syn, bp["values"], bp["hard"], conv, dec, 1, BATCH)
    want = engine._osd_fallback(*args)
    real = engine.osd_batch

    def unspecified(*a, n_live=None, **kw):
        out = real(*a, n_live=n_live, **kw)
        lane = torch.arange(len(out["logical_delta_packed"]))
        out["logical_delta_packed"] = torch.where(
            lane < n_live, out["logical_delta_packed"], 448)
        return out

    monkeypatch.setattr(engine, "osd_batch", unspecified)
    got = engine._osd_fallback(*args)
    assert not got[0][conv].any()
    for g_, w in zip(got, want):
        assert torch.equal(g_, w)


# The pooled round's OSD chunk (engine.pooled_osd_chunk), as arithmetic on
# the bench shapes' widths (PERF.md section 6): m rows, n columns, the
# prefix K and the basis rerun's KTp = K + rank rounded to a word; OSD
# order 2 with 12 test columns, so 12 + 66 flip sets
BENCH_SHAPES = {"[[144,12,12]]": (1008, 8785, 1280, 70 * 32, 4096),
                "[[288,12,18]]": (2880, 26209, 3584, 198 * 32, 1024)}
H100_MEMORY = 85_029_158_912  # torch.cuda.get_device_properties(...)


def _widths(m, n, K, KTp):
    """A stand-in for a BasisDecoder with only the widths the rule reads
    (H's shape, a stride-0 view)."""
    return dataclasses.make_dataclass("Widths", ["H", "K", "basis_cols",
                                                 "num_test"])(
        torch.zeros((1, 1), dtype=torch.uint8).expand(m, n), K,
        torch.zeros(KTp - K, dtype=torch.int64), 12)


@pytest.mark.parametrize("shape", sorted(BENCH_SHAPES))
def test_pooled_osd_chunk_is_the_whole_pool_at_bench_shapes(shape,
                                                            monkeypatch):
    """With an H100's budget, [[144]]'s 4,096-shot and [[288]]'s
    1,024-shot pools are one chunk: the larger of the basis rerun's G1
    output and a replayed chunk's reprocess (parity table and reduced
    matrix) over the whole pool is below 1/8 of the card."""
    m, n, K, KTp, pool = BENCH_SHAPES[shape]
    monkeypatch.setattr(engine, "OSD_CHUNK_CPU_BYTES",
                        H100_MEMORY // engine.OSD_CHUNK_MEMORY_SHARE)
    dec = _widths(m, n, K, KTp)
    S = -(-m // 32) | 1
    g1, reprocess = KTp * S * 4, 4 * m * (12 + 66 + KTp // 32)
    assert engine.osd_shot_bytes(dec, 2, "cpu") == max(g1, reprocess)
    assert pool * max(g1, reprocess) < 3.5e9
    assert engine.pooled_osd_chunk(pool, [dec, dec], 2, "cpu") == pool
    # order 0 holds no reprocess: the G1 output alone
    assert engine.osd_shot_bytes(dec, 0, "cpu") == g1


@pytest.mark.parametrize("fit", [8, 32, 100, 992, 4095, 4096])
def test_pooled_osd_chunk_splits_into_equal_chunks(fit, monkeypatch):
    """Under a budget that holds ``fit`` shots of [[144]]'s widths, a
    4,096-shot pool takes the fewest chunks of at most ``fit`` shots (at
    least 32), each a multiple of 32 shots, the last at most 32 shots a
    chunk short of the others; the whole pool where it fits."""
    m, n, K, KTp, pool = BENCH_SHAPES["[[144,12,12]]"]
    dec = _widths(m, n, K, KTp)
    shot = engine.osd_shot_bytes(dec, 2, "cpu")
    monkeypatch.setattr(engine, "OSD_CHUNK_CPU_BYTES", fit * shot + shot - 1)
    chunk = engine.pooled_osd_chunk(pool, [dec], 2)
    cap = max(32, fit // 32 * 32)
    n_chunks = -(-pool // chunk)
    if fit >= pool:
        assert chunk == pool
        return
    assert chunk % 32 == 0 and chunk <= cap
    assert n_chunks == -(-pool // cap)
    assert 0 <= n_chunks * chunk - pool < 32 * n_chunks


def test_pooled_osd_chunk_budget(monkeypatch):
    """The budget: 1/8 of the card's memory on a card, a fixed size on the
    CPU; a pool of at most 64 shots stays whole under any budget."""
    props = type("Props", (), {"total_memory": H100_MEMORY})()
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: props)
    assert engine.osd_chunk_budget("cuda") == H100_MEMORY // 8
    assert engine.osd_chunk_budget("cpu") == engine.OSD_CHUNK_CPU_BYTES
    monkeypatch.setattr(engine, "OSD_CHUNK_CPU_BYTES", 1)
    dec = _widths(*BENCH_SHAPES["[[288,12,18]]"][:4])
    assert [engine.pooled_osd_chunk(p, [dec], 2) for p in (1, 37, 64, 65)] \
        == [1, 37, 64, 32]
