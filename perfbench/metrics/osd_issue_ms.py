"""osd_issue_ms: mean host milliseconds per dispatch inside the program's
``osd`` spans (one a basis: the unconverged-first order and every OSD
chunk issued and merged), over the pass of dispatches run with the
program's telemetry on and no profiler (``run.telemetry_unprofiled``;
program span)."""


def read(run):
    exp = getattr(run, "telemetry_unprofiled", None)
    if not exp:
        return None
    ids = {s["dispatch"] for s in exp["spans"] if s["name"] == "round"}
    if not ids:
        return None
    ns = sum(s["end_ns"] - s["start_ns"] for s in exp["spans"]
             if s["name"] == "osd" and s["end_ns"] is not None)
    return ns / 1e6 / len(ids)
