"""issue_ms: mean milliseconds per dispatch that the host spends issuing it
(the draws and the round call, which returns before the card finishes;
host clock, in the traced window, so the profiler's cost is in it)."""


def read(run):
    return 1e3 * sum(d.issue_s for d in run.dispatches) / len(run.dispatches)
