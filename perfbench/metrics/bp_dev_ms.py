"""bp_dev_ms: mean device milliseconds per dispatch of the operations
launched inside the bp stage's profiler range (``engine._bp_one_basis``;
device trace)."""


def read(run):
    if run.trace is None:
        return None
    v = run.trace.stage_mean("bp", [d.index for d in run.dispatches])
    return None if v is None else v * 1e3
