"""osd_live_chunk_pct: the share of the OSD chunks issued that held at
least one BP-failed shot: ``osd.chunk`` spans whose ``osd.live`` count was
above 0 over the ``osd.chunks_issued`` counted, over the window's
dispatches (``run.telemetry``; program counter)."""


def read(run):
    exp = getattr(run, "telemetry", None)
    if not exp:
        return None
    ids = {d.index for d in run.dispatches}
    spans = [s for s in exp["spans"] if s["dispatch"] in ids]
    issued = sum(s["counters"].get("osd.chunks_issued", 0) for s in spans
                 if s["name"] == "osd")
    if not issued:
        return None
    live = sum(s["counters"].get("osd.live", 0) > 0 for s in spans
               if s["name"] == "osd.chunk")
    return 100.0 * live / issued
