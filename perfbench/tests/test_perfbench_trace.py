"""The trace reduction on a hand-made trace in the profiler's export
format: device time and launches by stage and dispatch, busy time as the
union of intervals, idle gaps named by what the host was doing."""
import pytest

from perfbench import trace


def ev(cat, name, ts, dur, **args):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def make():
    return [
        ev("user_annotation", "perfbench.window", 0, 1000),
        ev("user_annotation", "perfbench.dispatch.7", 10, 300),
        ev("user_annotation", "perfbench.sampling", 20, 50),
        ev("user_annotation", "perfbench.bp", 80, 100),
        ev("user_annotation", "perfbench.osd", 190, 100),
        ev("cpu_op", "aten::sort", 200, 40),
        ev("cuda_runtime", "cudaLaunchKernel", 30, 2, correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 90, 2, correlation=2),
        ev("cuda_runtime", "cudaLaunchKernel", 210, 2, correlation=3),
        ev("cuda_runtime", "cudaMemcpyAsync", 220, 2, correlation=4),
        ev("kernel", "sample_kernel", 100, 100, correlation=1),
        ev("kernel", "void bp_flood_kernel<false>(...)", 150, 200,
           correlation=2),
        ev("kernel", "gf2_elim_kernel", 400, 50, correlation=3),
        ev("gpu_memcpy", "Memcpy DtoH", 600, 10, correlation=4),
    ]


def test_reduction():
    t = trace.Trace(make())
    assert t.window_s == pytest.approx(1e-3)
    # [100, 350] u [400, 450] u [600, 610]
    assert t.busy_s == pytest.approx(310e-6)
    assert t.stage_mean("sampling", [7]) == pytest.approx(100e-6)
    assert t.stage_mean("bp", [7]) == pytest.approx(200e-6)
    assert t.stage_mean("osd", [7]) == pytest.approx(60e-6)
    assert t.stage_mean("osd", [7], 1) == 1      # the copy is no launch
    assert t.kernels[7]["void bp_flood_kernel<false>(...)"] == \
        pytest.approx(200e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["void bp_flood_kernel<false>(...)",
                                  pytest.approx(200e-6)]
    idle = dict(b["idle_gaps"])
    assert sum(idle.values()) == pytest.approx(690e-6)
    assert idle["between dispatches: python"] == pytest.approx(
        (400 - 350 + 600 - 450 + 1000 - 610) * 1e-6)
    assert idle["sampling: python"] == pytest.approx(100e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_dispatch_work_before_the_window_is_its_own():
    # the window's first dispatch is issued before the window opens; its
    # BP launch ran wholly before then and still counts for it, while the
    # window's busy time and device ops leave it out
    events = make() + [
        ev("user_annotation", "perfbench.dispatch.6", -500, 100),
        ev("user_annotation", "perfbench.bp", -480, 50),
        ev("cuda_runtime", "cudaLaunchKernel", -470, 2, correlation=5),
        ev("kernel", "void bp_flood_kernel<false>(...)", -300, 250,
           correlation=5),
    ]
    t = trace.Trace(events)
    assert t.kernels[6]["void bp_flood_kernel<false>(...)"] == \
        pytest.approx(250e-6)
    assert t.stage_mean("bp", [6]) == pytest.approx(250e-6)
    assert t.stage_mean("bp", [6, 7]) == pytest.approx(225e-6)
    assert t.busy_s == pytest.approx(310e-6)
    assert t.device_ops["void bp_flood_kernel<false>(...)"] == \
        pytest.approx(200e-6)


def test_missing_stage_is_left_out():
    t = trace.Trace(make(), stages_missing=["_bp_one_basis"])
    assert t.stage_mean("bp", [7]) is None
    assert t.stage_mean("osd", [7]) is not None


def test_stage_ranges_wrap_and_restore():
    class Engine:
        @staticmethod
        def trial_batch():
            return 1
    eng = Engine()
    real = eng.trial_batch
    with trace.stage_ranges(eng) as missing:
        assert eng.trial_batch() == 1 and eng.trial_batch is not real
        assert set(missing) == {"_bp_one_basis", "_osd_fallback",
                                "_logical_readout"}
    assert eng.trial_batch is real
