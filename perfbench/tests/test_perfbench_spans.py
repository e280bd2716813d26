"""The program's spans beside the device trace (``spans.py``): innermost
spans, idle gaps and launches put down to them on a hand-made trace with
``trace.Trace``'s own numbers left as they are; the readers of
``span_report.py``'s five metrics without their input; and the report on
the small [[72]] cell on the CPU, where the program's BP shot-iterations
equal the reference's."""
import pytest

from perfbench import harness, span_report, spans, trace

from helpers import CELL, manifest


def ev(cat, name, ts, dur, **args):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def span(name, start, end, parent, dispatch=7, **counters):
    return dict(name=name, start_ns=start * 1000, end_ns=end * 1000,
                parent=parent, dispatch=dispatch, replay=False, attrs={},
                counters=counters)


# spans on a clock whose anchor maps ns / 1000 onto the trace's us
EXPORT = {
    "spans": [span("round", 10, 700, -1),                   # 0
              span("osd", 100, 600, 0),                     # 1
              span("osd.chunk", 110, 400, 1, **{"osd.live": 3}),  # 2
              span("osd.stage1", 120, 260, 2),              # 3
              span("elim", 200, 250, 3, **{"elim.live": 0}),  # 4
              span("osd.merge", 410, 420, 1)],              # 5
    "dropped": 0, "anchor": (0, 0),
    "to_trace_us": lambda t, base=0: t / 1e3 - base / 1e3,
}


def events():
    return [
        ev("user_annotation", "perfbench.window", 0, 1000),
        ev("user_annotation", "perfbench.dispatch.7", 5, 700),
        ev("user_annotation", "perfbench.osd", 100, 500),
        ev("cuda_runtime", "cudaLaunchKernel", 130, 2, correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 210, 2, correlation=2),
        ev("cuda_runtime", "cudaMemsetAsync", 415, 2, correlation=3),
        ev("kernel", "gf2_pack", 0, 150, correlation=1),
        ev("kernel", "gf2_elim_kernel", 300, 20, correlation=2),
        ev("gpu_memset", "Memset", 700, 10, correlation=3),
    ]


def test_innermost_segments():
    segs = spans.innermost([(0, 10, "a"), (2, 5, "b"), (3, 4, "c"),
                            (6, 8, "d")])
    assert segs == [(0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 5, "b"),
                    (5, 6, "a"), (6, 8, "d"), (8, 10, "a")]


def test_idle_and_launches_by_span():
    evs = events()
    t = trace.Trace(evs)
    before = (dict(t.device_ops), dict(t.idle), t.busy_s)
    r = spans.SpanTrace(evs, 0, EXPORT)
    # gaps [150, 300] (middle 225: elim), [320, 700] (510: osd),
    # [710, 1000] (855: no span)
    assert dict(r.idle_by_span()) == pytest.approx(
        {"elim": 150e-6, "osd": 380e-6, "no span": 290e-6})
    assert sum(r.idle.values()) == pytest.approx(t.window_s - t.busy_s)
    assert r.idle_by_index[4] == pytest.approx(150e-6)
    # what trace.Trace puts down to the OSD stage, all of it in osd spans
    osd_idle = sum(v for k, v in t.idle.items() if k.startswith("osd:"))
    assert r.osd_stage_idle == pytest.approx(osd_idle)
    assert r.osd_stage_idle_in_osd_spans == pytest.approx(osd_idle)
    # launches by the innermost span open at the launch
    assert dict(r.launches) == {3: 1, 4: 1, 5: 0}
    assert r.device[3] == pytest.approx(150e-6)
    assert r.device[4] == pytest.approx(20e-6)
    assert r.device[5] == pytest.approx(10e-6)
    # the OSD stage range opens where the osd span does
    assert r.clock_offsets_us == [0]
    # trace.Trace's own reduction is untouched
    assert (dict(t.device_ops), dict(t.idle), t.busy_s) == before
    assert set(t.breakdown()) == {"device_ops", "idle_gaps"}


def test_table_and_self_time():
    r = spans.SpanTrace(events(), 0, EXPORT)
    own = spans.self_ns(EXPORT)
    assert own[0] == (690 - 500) * 1000 and own[1] == (500 - 290 - 10) * 1000
    rows = {row["span"]: row for row in
            spans.table(EXPORT, EXPORT, r, [7], [7])}
    assert rows["elim"]["calls"] == 1 and rows["elim"]["launches"] == 1
    assert rows["osd.chunk"]["osd.live"] == 3
    assert rows["elim"]["idle_ms"] == pytest.approx(0.15)
    assert "osd.chunk" in spans.format_table(list(rows.values()))


@pytest.mark.parametrize("name", span_report.METRICS)
def test_readers_without_input(name):
    read = harness.reader(name)
    run = harness.Run(config={}, traffic={}, device="cpu", setup_s=0.0,
                      window_s=1.0, shots_per_dispatch=1, dispatches=[])
    assert read(run) is None
    run.telemetry = run.telemetry_unprofiled = {"spans": [], "dropped": 0}
    assert read(run) is None


def test_report_on_the_cpu():
    notes = []
    out = span_report.report(CELL, 2**31 + 11, device="cpu", man=manifest(),
                             log=lambda *a, **k: notes.append(a[0]))
    assert out["correct"] and out["checks"] == {"conv_mismatch": 0,
                                                "decode_mismatch": 0}
    m = out["metrics"]
    for name in span_report.METRICS:
        assert name in m, name
    assert 0 <= m["osd_live_chunk_pct"] <= 100
    assert 0 <= m["elim_empty_pct"] <= 100
    assert 1 <= m["bp_iters_per_shot"] <= 20
    assert any("bp_iters_per_shot: the program's shot-iterations equal"
               in n for n in out["notes"])
    rows = {r["span"]: r for r in out["table"]}
    assert rows["round"]["calls"] == 1 and rows["elim"]["calls"] > 0
    assert out["dropped"] == 0
