"""sampling_dev_ms: mean device milliseconds per dispatch of the operations
launched inside the sampling stage's profiler range (``engine.trial_batch``;
device trace)."""


def read(run):
    if run.trace is None:
        return None
    v = run.trace.stage_mean("sampling", [d.index for d in run.dispatches])
    return None if v is None else v * 1e3
