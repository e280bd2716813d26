"""elim_empty_pct: the share of eliminator launches (``elim`` spans: K2,
or K4 / K5) whose gate [lo, hi) held no shot (``elim.live`` 0), over the
window's dispatches (``run.telemetry``; program counter)."""


def read(run):
    exp = getattr(run, "telemetry", None)
    if not exp:
        return None
    ids = {d.index for d in run.dispatches}
    lives = [s["counters"].get("elim.live", 0) for s in exp["spans"]
             if s["name"] == "elim" and s["dispatch"] in ids]
    if not lives:
        return None
    return 100.0 * sum(v == 0 for v in lives) / len(lives)
