"""One cell's program spans and counters beside its device trace.

    python3 perfbench/span_report.py --workload NAME --seed N
        [--dispatches D] [--pairs P] [--out PATH]

Run from the root of a checkout on a machine with the cell's GPU. It sets
the cell up as ``perfbench/run.py`` does and drives the same loop, with
the program's telemetry (``qldpc_tpu_torch.utils.telemetry``) on and each
issue and replay inside ``telemetry.dispatch(i)``:

1. a traced window of D dispatches (default: the configuration's
   ``trace_dispatches``) under the profiler and the stage ranges of
   ``trace.py``, telemetry on from the ranges' install to the window's
   close;
2. an unprofiled pass of D more dispatches with telemetry on;
3. optionally P pairs of unprofiled windows of D dispatches, telemetry off
   then on, for the dispatch period and the host's issue each way (the
   cost of tracing on);
4. the check of ``checks.py`` on a sample of the window's dispatches,
   with the reference's BP iterations held against the program's count.

It prints the per-span table (calls, host self ms from the unprofiled
pass, kernel launches, device ms and device idle ms while innermost from
the window, counters; each per dispatch) and ``idle_by_span`` on standard
error, and one JSON object last on standard output: the metrics of
``metrics/`` (the manifest's per-layer ones and this report's five), the
breakdowns, the table, the periods and the check. ``--out`` also writes the
object to a file. ``--device cpu`` runs a small cell without a trace.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import record_function  # noqa: E402

from perfbench import checks, harness, matrices, spans  # noqa: E402
from perfbench import trace as tracing  # noqa: E402

METRICS = ("round_issue_ms", "osd_issue_ms", "osd_live_chunk_pct",
           "elim_empty_pct", "bp_iters_per_shot")


class SpanLoop(harness.Loop):
    """``harness.Loop`` with each issue and replay inside the program's
    ``telemetry.dispatch``."""

    def __init__(self, *args, telemetry, **kwargs):
        super().__init__(*args, **kwargs)
        self.telemetry = telemetry

    def _issue(self):
        with self.telemetry.dispatch(self.next):
            super()._issue()

    def step(self) -> tuple:
        while len(self.inflight) < self.depth:
            self._issue()
        # the pipeline is full: the only round the step may call is the
        # oldest dispatch's replay
        with self.telemetry.dispatch(self.inflight[0][0], replay=True):
            return super().step()


def _steps(loop, n: int, t0=None) -> tuple:
    """``n`` dispatches through ``loop`` after the completion at ``t0``
    (None: one more dispatch's): (records, flags by index, seconds from
    that completion to the last)."""
    if t0 is None:
        _, _, t0 = loop.step()
    records, flags = [], {}
    for _ in range(n):
        d, f, done = loop.step()
        records.append(d)
        flags[d.index] = f
    return records, flags, done - t0


def report(workload: str, seed: int, dispatches=None, pairs: int = 0,
           device="cuda", man=None, log=print) -> dict:
    from qldpc_tpu_torch.parallel import engine
    from qldpc_tpu_torch.utils import telemetry

    device = torch.device(device)
    on_gpu = device.type == "cuda"
    man = harness.manifest() if man is None else man
    cell, config, traffic = harness.cell_of(man, workload)
    p = float(traffic["p"])
    shape, measure = config["dispatch"], config["measure"]
    n = dispatches or measure["trace_dispatches"]
    circ_matrices = [matrices.load(part, p)
                     for part in matrices.parts(config)]
    pooled, n_locs, decs = harness.program(config, circ_matrices, p, device)
    draws = harness.draws_of(config, seed, p, n_locs, device)
    loop = SpanLoop(pooled, draws, shape["pipeline_depth"], True,
                    telemetry=telemetry)
    for _ in range(measure["warmup_dispatches"]):
        loop.step()

    # 1. the traced window
    telemetry.reset()
    stack = contextlib.ExitStack()
    with stack:
        missing = stack.enter_context(tracing.stage_ranges(engine))
        telemetry.enable()
        prof = None
        if on_gpu:
            from torch.profiler import ProfilerActivity, profile
            prof = stack.enter_context(profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        _, _, t0 = loop.step()
        with record_function(tracing.WINDOW):
            records, flags, window_s = _steps(loop, n, t0)
        telemetry.disable()
    loop.drain()
    window = telemetry.export()
    trace = reduced = None
    if prof is not None:
        path = matrices.CACHE / f"spans-{workload}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        trace = tracing.Trace.from_file(path, missing)
        events, base = spans.load(path)
        reduced = spans.SpanTrace(events, base, window)
        path.unlink()
        del events
    del prof

    # 2. the unprofiled pass
    loop.label = False
    telemetry.reset()
    telemetry.enable()
    unprof_records, _, _ = _steps(loop, n)
    telemetry.disable()
    loop.drain()
    unprofiled = telemetry.export()

    # 3. the period with telemetry off and on, in alternating pairs
    periods = {"off": [], "on": []}
    issue = {"off": [], "on": []}
    for _ in range(pairs):
        for mode in ("off", "on"):
            telemetry.reset()
            if mode == "on":
                telemetry.enable()
            recs, _, secs = _steps(loop, n)
            telemetry.disable()
            periods[mode].append(1e3 * secs / n)
            issue[mode].append(1e3 * sum(d.issue_s for d in recs) / n)
            loop.drain()
    telemetry.reset()
    del pooled, decs, loop
    gc.collect()

    run = harness.Run(config=config, traffic=traffic, device=device,
                      setup_s=0.0, window_s=window_s,
                      shots_per_dispatch=(shape["batch"] * shape["rounds"]
                                          * len(n_locs)),
                      dispatches=records, trace=trace,
                      power_limit=harness.power_limit() if on_gpu else "cpu")
    run.telemetry, run.telemetry_unprofiled = window, unprofiled

    # 4. the check, with the reference's iterations
    picked = [records[k].index for k in checks.sample(
        seed, len(records), measure["check_dispatches"])]
    numbers = harness.judge(run, config, circ_matrices, p, draws, flags,
                            picked)

    names = [m["name"] for m in harness.metrics_of(man, cell, True)]
    metrics = {}
    for name in names + [m for m in METRICS if m not in names]:
        value = harness.reader(name)(run)
        if value is not None:
            metrics[name] = value
    window_ids = [d.index for d in records]
    rows = spans.table(window, unprofiled, reduced, window_ids,
                       [d.index for d in unprof_records])
    log(spans.format_table(rows), file=sys.stderr)
    for note in run.notes:
        log(note, file=sys.stderr)
    out = {"workload": workload, "seed": seed, "dispatches": n,
           "card": run.power_limit, "correct": checks.verdict(numbers),
           "checks": numbers, "metrics": metrics, "table": rows,
           "dropped": window["dropped"] + unprofiled["dropped"],
           "notes": run.notes}
    if trace is not None:
        out["breakdown"] = dict(trace.breakdown(),
                                idle_by_span=reduced.idle_by_span())
        off = sorted(reduced.clock_offsets_us)
        out["clock_offset_us"] = ({"median": off[len(off) // 2],
                                   "min": off[0], "max": off[-1],
                                   "n": len(off)} if off else None)
        out["osd_stage_idle_s"] = reduced.osd_stage_idle
        out["osd_stage_idle_in_osd_spans_s"] = \
            reduced.osd_stage_idle_in_osd_spans
        log("idle_by_span: " + json.dumps(out["breakdown"]["idle_by_span"]),
            file=sys.stderr)
    if pairs:
        out["period_ms"], out["issue_ms"] = periods, issue
        out["median_ms"] = {f"{name}_{k}": statistics.median(v)
                            for name, d in (("period", periods),
                                            ("issue", issue))
                            for k, v in d.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/span_report.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--dispatches", type=int, default=None)
    ap.add_argument("--pairs", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    out = report(args.workload, args.seed, args.dispatches, args.pairs,
                 args.device)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
