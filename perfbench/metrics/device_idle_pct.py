"""device_idle_pct: the share of the traced window in which no device
operation runs (100 less the union of the operations' intervals over the
window; device trace)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
