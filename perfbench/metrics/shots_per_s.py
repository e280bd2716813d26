"""shots_per_s: decoded shots (each in both bases) of every dispatch
consumed in the window, over the window's seconds (host clock, from one
dispatch's completion to the last one's)."""


def read(run):
    return run.shots_per_dispatch * len(run.dispatches) / run.window_s
