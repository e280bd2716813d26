"""osd_dev_ms: mean device milliseconds per dispatch of the operations
launched inside the osd stage's profiler range (``engine._osd_fallback``;
device trace)."""


def read(run):
    if run.trace is None:
        return None
    v = run.trace.stage_mean("osd", [d.index for d in run.dispatches])
    return None if v is None else v * 1e3
