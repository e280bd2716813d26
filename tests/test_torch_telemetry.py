"""The port's telemetry (qldpc_tpu_torch/utils/telemetry.py) on the CPU:
off, a span is the shared no-op and nothing is recorded; on, every span of
the pooled round appears under its parent with its dispatch, the counters
equal what they count, and a span's time lands on a profiler trace's
clock; at the default OSD chunk a pool that fits is one chunk a basis.
[[72,12,6]], 6 cycles, p=0.003, maxIter 20, OSD order 2, two rounds of 32
shots a dispatch in OSD chunks of 32, on fixed randoms."""
import dataclasses
import json
import time
from collections import Counter

import numpy as np
import pytest
import torch

import qldpc_tpu_torch as qt
from qldpc_tpu_torch.ops import osd
from qldpc_tpu_torch.ops.bp import alpha_schedule
from qldpc_tpu_torch.parallel import engine, mesh
from qldpc_tpu_torch.utils import telemetry

torch.set_num_threads(1)

P, MAXITER, BATCH, ROUNDS, CHUNK = 0.003, 20, 32, 2, 32
OSD_STEPS = ("osd.prep", "osd.stage1", "osd.tail", "osd.basis",
             "osd.osd0", "osd.reprocess", "osd.delta")


@pytest.fixture(scope="module")
def setup():
    code = qt.get_code("[[72, 12, 6]]")
    circ = qt.SyndromeCircuit(code, num_cycles=6)
    M = qt.build_decoding_matrices(circ, code.Lx, code.Lz, P)
    seq = alpha_schedule("dynamical", MAXITER)
    decs = [engine._make_basis(circ, M, b, seq, osd_order=2, device="cpu")
            for b in "ZX"]
    fn = engine.make_pooled_round_fn(*decs, circ.num_error_locs, P, BATCH,
                                     MAXITER, 2, ROUNDS, osd_chunk=CHUNK)
    return circ, decs, fn, _draws(circ, BATCH, 11)


def _draws(circ, batch, seed):
    """ROUNDS rounds of fixed randoms (err, pauli, cat2) of ``batch``
    shots."""
    g = torch.Generator().manual_seed(seed)
    shape = (batch, circ.num_error_locs)
    randoms = []
    for _ in range(ROUNDS):
        err = torch.rand(shape, generator=g) < P
        c = torch.randint(0, 45, shape, generator=g, dtype=torch.int32)
        randoms.append((err, c % 3, c // 3))
    return randoms


@pytest.fixture
def traced():
    telemetry.reset()
    telemetry.enable()
    yield
    telemetry.disable()
    telemetry.reset()


def _round(fn, randoms, dispatch=7):
    with telemetry.dispatch(dispatch):
        return fn(None, randoms=randoms)


def test_off_is_a_shared_no_op(setup):
    _, _, fn, randoms = setup
    telemetry.reset()
    assert not telemetry.enabled()
    assert telemetry.span("a") is telemetry.span("b", x=1) \
        is telemetry.dispatch(3)
    off = _round(fn, randoms)
    assert telemetry.export()["spans"] == []
    telemetry.enable()
    try:
        on = _round(fn, randoms)
    finally:
        telemetry.disable()
        telemetry.reset()
    assert set(on) == set(off)
    for k in off:
        assert torch.equal(on[k], off[k]), k


def test_spans_parents_and_dispatch(setup, traced):
    _, _, fn, randoms = setup
    _round(fn, randoms)
    spans = telemetry.export()["spans"]
    pool = BATCH * ROUNDS
    chunks = 2 * (pool // CHUNK)
    n = Counter(s["name"] for s in spans)
    want = {"round": 1, "sampling": ROUNDS, "bp": 2 * ROUNDS, "pool": 1,
            "osd": 2, "osd.order": 2, "osd.chunk": chunks,
            "osd.merge": chunks, "readout": 2,
            # stage 1, the tail, the basis rerun, the full-Jordan reprocess
            "elim": 4 * chunks}
    want.update({s: chunks for s in OSD_STEPS})
    assert dict(n) == want
    assert all(s["dispatch"] == 7 and not s["replay"] for s in spans)
    assert all(s["end_ns"] >= s["start_ns"] for s in spans)
    name = {i: s["name"] for i, s in enumerate(spans)}
    parent = {"round": None, "sampling": "round", "bp": "round",
              "pool": "round", "osd": "round", "readout": "round",
              "osd.order": "osd", "osd.chunk": "osd", "osd.merge": "osd",
              **{s: "osd.chunk" for s in OSD_STEPS}}
    for s in spans:
        p = name.get(s["parent"])
        if s["name"] == "elim":
            assert p in ("osd.stage1", "osd.tail", "osd.basis",
                         "osd.reprocess")
        else:
            assert p == parent[s["name"]], s["name"]
        # a child lies inside its parent
        if s["parent"] >= 0:
            q = spans[s["parent"]]
            assert q["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= q["end_ns"]
    rnd = spans[0]
    assert rnd["attrs"] == {"rounds": ROUNDS, "batch": BATCH,
                            "replay": False}
    assert [s["attrs"]["basis"] for s in spans if s["name"] == "osd"] \
        == ["z", "x"]
    full = [s for s in spans if s["name"] == "elim"
            and s["attrs"]["full_jordan"]]
    assert len(full) == chunks
    assert all(name[s["parent"]] == "osd.reprocess" for s in full)


def test_counters(setup, traced):
    circ, decs, fn, randoms = setup
    out = _round(fn, randoms)
    spans = telemetry.export()["spans"]
    # BP: the iterations run by the shots, from the converging iteration
    # (from 0) that _bp_one_basis returns on the same syndromes
    for b, basis in enumerate("zx"):
        want = 0
        for r in randoms:
            trials = engine.trial_batch(None, P, decs[0].maps, decs[1].maps,
                                        circ.num_error_locs, BATCH, r)
            bp = engine._bp_one_basis(trials[f"syndrome_{basis}"], decs[b],
                                      MAXITER)
            want += int((bp["iterations"] + 1).sum())
        got = [s["counters"] for s in spans
               if s["name"] == "bp" and s["attrs"]["basis"] == basis]
        assert sum(c["bp.shot_iterations"] for c in got) == want
        assert sum(c["bp.shots"] for c in got) == BATCH * ROUNDS
    # OSD: failed shots from the convergence flags, chunks live =
    # ceil(failed / chunk), and the chunk's live count at its stage 1
    osds = [i for i, s in enumerate(spans) if s["name"] == "osd"]
    lives = 0
    for i, basis in zip(osds, "zx"):
        n_fail = int((~out[f"{basis}_conv"]).sum())
        c = spans[i]["counters"]
        assert c["osd.failed"] == n_fail
        assert c["osd.chunks_issued"] == BATCH * ROUNDS // CHUNK
        chunk_spans = [j for j, s in enumerate(spans)
                       if s["name"] == "osd.chunk" and s["parent"] == i]
        live = [spans[j]["counters"]["osd.live"] for j in chunk_spans]
        assert live == [min(max(n_fail - c0, 0), CHUNK)
                        for c0 in range(0, BATCH * ROUNDS, CHUNK)]
        assert sum(v > 0 for v in live) == -(-n_fail // CHUNK)
        lives += sum(v > 0 for v in live)
        for j, v in zip(chunk_spans, live):
            stage1 = next(k for k, s in enumerate(spans)
                          if s["name"] == "osd.stage1" and s["parent"] == j)
            elim1 = next(s for s in spans if s["name"] == "elim"
                         and s["parent"] == stage1)
            assert elim1["counters"]["elim.live"] == v
    # an empty chunk's launches hold no shot and run no column step
    assert 0 < lives < 2 * BATCH * ROUNDS // CHUNK
    by_chunk = {}
    for s in spans:
        if s["name"] == "elim":
            step = spans[s["parent"]]
            by_chunk.setdefault(step["parent"], []).append(s["counters"])
    empty = 0
    for j, counters in by_chunk.items():
        if spans[j]["counters"]["osd.live"] == 0:
            assert all(c["elim.live"] == 0 and c["elim.steps"] == 0
                       for c in counters)
            empty += len(counters)
    assert empty == 4 * (2 * BATCH * ROUNDS // CHUNK - lives)
    assert sum(s["counters"]["elim.live"] == 0 for s in spans
               if s["name"] == "elim") >= empty
    rep = [s["counters"]["osd.reprocess_failed"] for s in spans
           if s["name"] == "osd.reprocess"]
    assert len(rep) == 2 * BATCH * ROUNDS // CHUNK and min(rep) >= 0


def test_default_chunk_is_the_whole_pool(setup, traced):
    """At the default OSD chunk a pooled round of 128 shots issues one
    chunk a basis (the pool fits the budget), with one reprocess slice
    over the whole pool; its flags, ``osd_overflow`` included, equal the
    same round's in chunks of pool // 8 on the same randoms."""
    circ, decs, _, _ = setup
    batch = 64
    pool = batch * ROUNDS
    randoms = _draws(circ, batch, 12)
    assert engine.pooled_osd_chunk(pool, decs, 2) == pool
    whole = engine.make_pooled_round_fn(*decs, circ.num_error_locs, P,
                                        batch, MAXITER, 2, ROUNDS)
    got = _round(whole, randoms)
    spans = telemetry.export()["spans"]
    osds = [s for s in spans if s["name"] == "osd"]
    assert [s["attrs"]["chunk"] for s in osds] == [pool, pool]
    assert [s["counters"]["osd.chunks_issued"] for s in osds] == [1, 1]
    assert sum(s["name"] == "osd.reprocess" for s in spans) == 2
    eighths = engine.make_pooled_round_fn(*decs, circ.num_error_locs, P,
                                          batch, MAXITER, 2, ROUNDS,
                                          osd_chunk=pool // 8)
    want = _round(eighths, randoms)
    assert set(got) == set(want) and "osd_overflow" in got
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert 0 < int((~got["z_conv"]).sum()) + int((~got["x_conv"]).sum())


def test_stopping_loop_dispatch_ids(setup, traced):
    circ, decs, fn, _ = setup
    sharded = mesh.shard_rounds(fn, mesh.shot_mesh())
    gen = torch.Generator().manual_seed(3)
    out = engine._drive_stopping_rounds(
        lambda ri, replay=False: [sharded([gen], replay=replay)],
        mesh.gather_flags, 1, BATCH * ROUNDS, 3 * BATCH * ROUNDS, None,
        False, ["s"], pipeline_depth=2, generators=[gen])
    assert out["trials"] == [3 * BATCH * ROUNDS]
    spans = telemetry.export()["spans"]
    rounds = [s["dispatch"] for s in spans if s["name"] == "round"]
    consumed = [s["dispatch"] for s in spans if s["name"] == "consume"]
    assert rounds == [0, 1, 2, 3] and consumed == [0, 1, 2]
    assert all(s["dispatch"] is not None for s in spans)


def test_replay_span(setup, traced, monkeypatch):
    """A round whose reprocess slice overflowed is replayed inside a
    ``replay`` span of its own dispatch, counted once."""
    circ, decs, _, randoms = setup
    narrow = [dataclasses.replace(d, K=64, basis_cols=None) for d in decs]
    fn = engine.make_pooled_round_fn(*narrow, circ.num_error_locs, P, BATCH,
                                     MAXITER, 2, ROUNDS, osd_chunk=CHUNK)
    monkeypatch.setattr(osd, "REPROCESS_SLICE", 0)
    sharded = mesh.shard_rounds(fn, mesh.shot_mesh())
    out = engine._drive_stopping_rounds(
        lambda ri, replay=False: [sharded([None], randoms=[randoms],
                                          replay=replay)],
        mesh.gather_flags, 1, BATCH * ROUNDS, BATCH * ROUNDS, None, False,
        ["s"], pipeline_depth=1)
    assert out["replays"] == 1
    spans = telemetry.export()["spans"]
    rep = [i for i, s in enumerate(spans) if s["name"] == "replay"]
    assert len(rep) == 1 and spans[rep[0]]["counters"] == {"replays": 1}
    assert (spans[rep[0]]["dispatch"], spans[rep[0]]["replay"]) == (0, True)
    inner = [s for s in spans if s["parent"] == rep[0]]
    assert [s["name"] for s in inner] == ["round", "consume"]
    assert inner[0]["attrs"]["replay"] and inner[0]["replay"]


def test_spans_on_the_profiler_clock(tmp_path, traced):
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with telemetry.span("probe", i=i), \
                    record_function(f"probe.{i}"):
                torch.ones(64).sum()
            time.sleep(0.002)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    base = int(data.get("baseTimeNanoseconds", 0))
    ranges = {e["name"]: e["ts"] for e in data["traceEvents"]
              if str(e.get("name", "")).startswith("probe.")}
    exp = telemetry.export()
    probes = [s for s in exp["spans"] if s["name"] == "probe"]
    assert len(probes) == 5
    for s in probes:
        ts = exp["to_trace_us"](s["start_ns"], base)
        assert abs(ts - ranges[f"probe.{s['attrs']['i']}"]) < 1000.0


def test_cap_counts_dropped(traced, monkeypatch):
    monkeypatch.setattr(telemetry, "cap", 3)
    with telemetry.span("a"):
        for _ in range(4):
            with telemetry.span("b"):
                telemetry.count("n", torch.tensor([1, 2]))
    exp = telemetry.export()
    assert [s["name"] for s in exp["spans"]] == ["a", "b", "b"]
    assert exp["dropped"] == 2
    assert [s["counters"] for s in exp["spans"][1:]] == [{"n": 3}] * 2
    assert np.isclose(exp["to_trace_us"](exp["anchor"][0]),
                      exp["anchor"][1] / 1e3)
