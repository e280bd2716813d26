"""osd_launches: mean kernel launches per dispatch inside the OSD stage's
profiler range (``engine._osd_fallback``; device trace)."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.stage_mean("osd", [d.index for d in run.dispatches], 1)
