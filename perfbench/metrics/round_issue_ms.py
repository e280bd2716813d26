"""round_issue_ms: mean host milliseconds per dispatch inside the program's
``round`` span (``engine.make_pooled_round_fn``'s call: sampling, BP and
every OSD chunk issued, the benchmark's draws excluded), over the pass of
dispatches run with the program's telemetry on and no profiler
(``run.telemetry_unprofiled``; program span)."""


def read(run):
    exp = getattr(run, "telemetry_unprofiled", None)
    if not exp:
        return None
    ids = {s["dispatch"] for s in exp["spans"] if s["name"] == "round"}
    if not ids:
        return None
    ns = sum(s["end_ns"] - s["start_ns"] for s in exp["spans"]
             if s["name"] == "round" and s["end_ns"] is not None)
    return ns / 1e6 / len(ids)
