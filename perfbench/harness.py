"""One run of one cell: set-up, warm-up, the measured window, the check.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``,
the file its entry names) and a traffic mix (``traffic/<name>.json``); each
metric it reports is read by ``metrics/<name>.py``. Nothing here names a
cell, a configuration or a metric: a later cell or metric is files and
manifest entries.

The system under test is ``qldpc_tpu_torch``'s pooled decode round, built
from the benchmark's matrices: ``parallel.engine.make_pooled_round_fn``
for a configuration of one code, with the BP schedule its ``decoder.bp``
states (:data:`SCHEDULES`), ``make_multi_code_pooled_round_fn`` (what
``run_multi_code_simulation`` dispatches) for one of several
(``matrices.parts``). It is driven as the program's stopping loop drives
it on a GPU: ``pipeline_depth`` dispatches in flight, each dispatch's
flags (every code's, in code order) read to the host when it is consumed,
a dispatch whose OSD reprocess slice overflowed in any code replayed with
``replay=True`` (its shots credited once). Every dispatch decodes the
benchmark's own draws (``traffic.Draws``, one a code), passed through
``randoms=``.

The window starts at a dispatch's completion after the warm-up, runs for
``--seconds`` (a traced run: also at most the configuration's
``trace_dispatches``), and ends at the completion of the dispatch that
crosses it; every dispatch consumed in it counts.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import inspect
import json
import subprocess
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from . import checks, matrices, trace as tracing
from .reference import decode as reference
from .traffic import Draws

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "qldpc_tpu")
# a configuration's ``decoder.bp`` -> the pooled round's ``bp_variant``
SCHEDULES = {"flooding normalized min-sum": "minsum",
             "layered normalized min-sum": "layered"}


@dataclass
class Dispatch:
    """One dispatch of the window: its index, the host's seconds issuing it
    (draws and the round call), its seconds from the issue's start to its
    flags on the host, and whether it was replayed."""
    index: int
    issue_s: float
    latency_s: float
    replayed: bool


@dataclass
class Run:
    """What a metric reader reads (``metrics/<name>.py``: ``read(run)``)."""
    config: dict
    traffic: dict
    device: torch.device
    setup_s: float
    window_s: float
    shots_per_dispatch: int
    dispatches: list
    peak_window_bytes: Optional[int] = None
    trace: Optional[tracing.Trace] = None
    # per checked dispatch index: the reference's iterations per round, by
    # basis ("z"/"x" -> (rounds,) shot-iterations), and the edges and shape
    # of each basis's H; a configuration of several codes keys code c's
    # bases "z.c" and "x.c"
    iterations: dict = field(default_factory=dict)
    edges: dict = field(default_factory=dict)
    shape: dict = field(default_factory=dict)
    power_limit: str = "not read"
    notes: list = field(default_factory=list)


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(man: dict, workload: str, root: Path = ROOT) -> tuple:
    """(cell, configuration, traffic) of ``workload`` in the manifest."""
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return cell, config, traffic


def metrics_of(man: dict, cell: dict, traced: bool) -> list:
    """The metric entries this cell reports in a run of this kind."""
    group = man["per_layer"] if traced else man["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell["name"] in m["workloads"]]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out[0].strip() if out else "not read"


def _decoders(part: dict, circ_matrices: tuple, device) -> tuple:
    """One code's gate locations in the program's own circuit, and its two
    decode bases (Z, X) from the benchmark's matrices."""
    from qldpc_tpu_torch.models.bb import BBCode
    from qldpc_tpu_torch.models.circuit import SyndromeCircuit
    from qldpc_tpu_torch.ops.bp import alpha_schedule
    from qldpc_tpu_torch.parallel import engine

    circ_ref, M, _ = circ_matrices
    code = dict(part["code"])
    circ = SyndromeCircuit(BBCode(name=code.pop("name"), **code),
                           num_cycles=part["num_cycles"])
    if not np.array_equal(circ.loc_kind, circ_ref.loc_kind):
        raise RuntimeError("the program's circuit differs from the "
                           "benchmark's: its matrices do not apply")
    d = part["decoder"]
    seq = alpha_schedule(d["alpha"], d["max_iter"])
    bases = [engine._make_basis(circ, M, b, seq,
                                clip_channel=d["clip_channel"],
                                osd_margin=d["osd_margin"],
                                osd_order=d["osd_order"], device=device)
             for b in "ZX"]
    return circ.num_error_locs, bases


def schedule_refusals(config: dict, decs: list) -> list:
    """What a configuration of one code states of its BP schedule that the
    pooled round would not run: a ``bp`` outside :data:`SCHEDULES`, or the
    layered schedule where a decode basis has no lifted graph (the round
    would fall back to flooding, ``engine._round_defaults``)."""
    bp = config["decoder"]["bp"]
    if bp not in SCHEDULES:
        return [f"bp {bp!r}: the round runs one of {sorted(SCHEDULES)}"]
    if SCHEDULES[bp] == "layered" and any(
            z.lifted is None or x.lifted is None for z, x in decs):
        return [f"bp {bp!r}: the round runs the layered schedule only on a "
                "lifted decoding graph, and would run flooding here"]
    return []


def multi_code_refusals(config: dict, decs: list) -> list:
    """What a configuration of several codes states that the program's
    multi-code round does not run. That round builds each code's round
    with ``make_pooled_round_fn``'s defaults: flooding min-sum, damping 1,
    its ``clip_llr``, its default OSD chunk, and messages in float32 only
    where K1 runs (a lifted decoding graph)."""
    from qldpc_tpu_torch.parallel import engine

    fixed = {k: v.default for k, v in inspect.signature(
        engine.make_pooled_round_fn).parameters.items()}
    d, shape = config["decoder"], config["dispatch"]
    out = []
    if (d["bp"] != "flooding normalized min-sum"
            or fixed["bp_variant"] != "minsum" or fixed["damping"] != 1.0):
        out.append(f"bp {d['bp']!r}: the round runs flooding min-sum, "
                   f"damping {fixed['damping']}")
    if float(d["clip_llr"]) != fixed["clip_llr"]:
        out.append(f"clip_llr {d['clip_llr']}: the round clips at "
                   f"{fixed['clip_llr']}")
    if shape["osd_chunk"] is not None:
        out.append(f"osd_chunk {shape['osd_chunk']}: the round takes the "
                   "program's default chunk (null)")
    if d["msg_dtype"] != "float32" or any(z.lifted is None or x.lifted is None
                                          for z, x in decs):
        out.append(f"msg_dtype {d['msg_dtype']}: the round keeps float32 "
                   "messages only in K1, on a lifted decoding graph")
    return out


def program(config: dict, circ_matrices: list, p: float, device):
    """The system under test, set up from the benchmark's matrices
    (``circ_matrices``: each code's, in the order of ``matrices.parts``):
    the program's own circuit of each code, its decode bases and its pooled
    round, with the BP schedule the configuration states. Returns (pooled,
    n_locs, decs): ``pooled(randoms, replay=False)`` issues one dispatch of
    every code (``randoms[c]``: code c's rounds) and returns each code's
    flags; n_locs and decs (Z, X) per code."""
    from qldpc_tpu_torch.parallel import engine

    n_locs, decs = zip(*[_decoders(part, cm, device) for part, cm in
                         zip(matrices.parts(config), circ_matrices)])
    d, shape = config["decoder"], config["dispatch"]
    if len(decs) == 1:
        refused = schedule_refusals(config, decs)
        if refused:
            raise SystemExit("the configuration states what the round does "
                             "not run: " + "; ".join(refused))
        one = engine.make_pooled_round_fn(
            decs[0][0], decs[0][1], n_locs[0], p, shape["batch"],
            d["max_iter"], d["osd_order"], shape["rounds"],
            clip_llr=d["clip_llr"], bp_variant=SCHEDULES[d["bp"]],
            osd_chunk=shape["osd_chunk"], msg_dtype=torch.float32)

        def pooled(randoms, replay=False):
            return [one(None, randoms=randoms[0], replay=replay)]
        return pooled, n_locs, decs
    refused = multi_code_refusals(config, decs)
    if refused:
        raise SystemExit("the configuration states what the multi-code "
                         "round does not run: " + "; ".join(refused))
    multi = engine.make_multi_code_pooled_round_fn(
        [dict(dec_z=z, dec_x=x, n_locs=n, error_rate=p, batch=shape["batch"],
              maxIter=d["max_iter"], osd_order=d["osd_order"])
         for (z, x), n in zip(decs, n_locs)], shape["rounds"])

    def pooled(randoms, replay=False):
        return multi([None] * len(decs), randoms=randoms, replay=replay)
    return pooled, n_locs, decs


def draws_of(config: dict, seed: int, p: float, n_locs: list, device):
    """Each code's draws (``traffic.Draws``): code c's dispatch i from
    (seed, i, c)."""
    shape = config["dispatch"]
    return [Draws(seed, p, shape["batch"], shape["rounds"], n, device,
                  code=c) for c, n in enumerate(n_locs)]


def reference_bases(config: dict, circ_matrices: tuple, p: float, device):
    """The reference's two bases of the part ``config`` (one code of
    ``matrices.parts``), from the same matrices."""
    circ, M, idle = circ_matrices
    code = config["code"]
    out = []
    for b in "ZX":
        H = M[f"Hdec{b}"]
        cols = matrices.cached_array(
            config, p, f"basis{b}",
            lambda: reference.osd.column_basis(H, device))
        out.append(reference.Basis(
            b, H, M[f"H{b}_full"],
            matrices.channel_llrs(M[f"channel_probs{b}"],
                                  config["decoder"]["clip_channel"]),
            M[f"{b.lower()}_loc_gate_loc"], M[f"{b.lower()}_loc_role"],
            M[f"{b.lower()}_loc_class"], idle, (code["ell"], code["m"]),
            config["decoder"], device, basis_cols=cols))
    return out


def judge(run: Run, config: dict, circ_matrices: list, p: float, draws,
          flags: dict, picked: list) -> dict:
    """The check: each dispatch of ``picked`` drawn again and decoded by the
    reference code by code, with that code's bases, against the program's
    flags (``flags[i]``: (7, codes x shots) in code order). Sets
    ``run.iterations``, ``run.edges`` and ``run.shape``; returns the
    numbers compared, summed over codes."""
    rounds = config["dispatch"]["rounds"]
    parts = matrices.parts(config)
    numbers = dict.fromkeys(checks.LIMITS, 0)
    for c, (part, cm, draw) in enumerate(zip(parts, circ_matrices, draws)):
        bases = reference_bases(part, cm, p, run.device)
        tag = "" if len(parts) == 1 else f".{c}"
        for b in bases:
            run.edges[b.name.lower() + tag] = b.graph.edges
            run.shape[b.name.lower() + tag] = (b.graph.m, b.graph.n)
        for idx in picked:
            ref = reference.decode_round(bases, draw(idx))
            ref = {k: v.cpu().numpy() for k, v in ref.items()}
            n = ref["z_conv"].shape[0]
            mine = flags[idx][:, c * n:(c + 1) * n]
            for k, v in checks.compare(mine, ref).items():
                numbers[k] += v
            run.iterations.setdefault(idx, {}).update({
                b + tag: ref[f"{b}_iterations"].reshape(rounds, -1).sum(1)
                for b in "zx"})
        del bases
    return numbers


class Loop:
    """The pipelined loop: ``depth`` dispatches in flight, the oldest
    consumed by reading its flags (every code's, in code order) to the
    host."""

    def __init__(self, pooled, draws, depth: int, label: bool):
        self.pooled, self.draws, self.depth = pooled, draws, depth
        self.label = label          # a profiler range around each issue
        self.inflight: deque = deque()
        self.next = 0

    @staticmethod
    def _packed(outs):
        """Each code's flags as one (7, codes x shots) tensor (one code's
        stack as it is, with no copy)."""
        per = [torch.stack([o[k] for k in checks.FLAGS]) for o in outs]
        return per[0] if len(per) == 1 else torch.cat(per, 1)

    def _issue(self):
        i = self.next
        self.next += 1
        t0 = time.perf_counter()
        with (record_function(f"{tracing.DISPATCH}{i}") if self.label
              else contextlib.nullcontext()):
            rnd = [draw(i) for draw in self.draws]
            packed = self._packed(self.pooled(rnd))
        self.inflight.append((i, t0, time.perf_counter() - t0, rnd, packed))

    def step(self) -> tuple:
        """Fill the pipeline, consume the oldest dispatch. Returns
        (Dispatch, flags (7, N) bool, completion time)."""
        while len(self.inflight) < self.depth:
            self._issue()
        i, t0, issue_s, rnd, packed = self.inflight.popleft()
        flags = packed.cpu().numpy()
        replayed = bool(flags[checks.FLAGS.index("osd_overflow")].any())
        if replayed:
            flags = self._packed(self.pooled(rnd, replay=True)).cpu().numpy()
        done = time.perf_counter()
        return Dispatch(i, issue_s, done - t0, replayed), flags, done

    def drain(self):
        if self.inflight and self.inflight[0][4].is_cuda:
            torch.cuda.synchronize()
        self.inflight.clear()


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device, t_start: float, man: Optional[dict] = None,
             root: Path = ROOT, log=print) -> dict:
    """One run; returns the result line's object (``correct`` and the rest,
    the numbers compared last under ``checks``)."""
    device = torch.device(device)
    on_gpu = device.type == "cuda"
    man = manifest(root) if man is None else man
    cell, config, traffic = cell_of(man, workload, root)
    wanted = metrics_of(man, cell, traced)
    p = float(traffic["p"])
    shape, measure = config["dispatch"], config["measure"]

    marks = [("imports", time.time())]
    circ_matrices = [matrices.load(part, p)
                     for part in matrices.parts(config)]
    marks.append(("matrices", time.time()))
    pooled, n_locs, decs = program(config, circ_matrices, p, device)
    marks.append(("program set-up", time.time()))
    draws = draws_of(config, seed, p, n_locs, device)
    loop = Loop(pooled, draws, shape["pipeline_depth"], traced)
    shots = shape["batch"] * shape["rounds"] * len(n_locs)
    for _ in range(measure["warmup_dispatches"]):
        loop.step()
    marks.append(("warm-up", time.time()))
    log("set-up: " + ", ".join(
        f"{name} {t - prev:.2f} s" for (name, t), prev in
        zip(marks, [t_start] + [t for _, t in marks[:-1]])),
        file=sys.stderr)

    from qldpc_tpu_torch.parallel import engine
    stack = contextlib.ExitStack()
    missing, prof = [], None
    if traced:
        missing = stack.enter_context(tracing.stage_ranges(engine))
        for name in missing:
            log(f"trace: engine.{name} is gone; its stage's metrics are "
                "left out", file=sys.stderr)
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_gpu else [])
        prof = stack.enter_context(profile(activities=acts))
    with stack:
        _, _, t0 = loop.step()                 # the window's start
        setup_s = time.time() - t_start
        peak_setup = torch.cuda.max_memory_allocated(device) if on_gpu \
            else None
        if on_gpu:
            torch.cuda.reset_peak_memory_stats(device)
        limit = measure["trace_dispatches"] if traced else None
        records, flags = [], {}
        window = (record_function(tracing.WINDOW) if traced
                  else contextlib.nullcontext())
        with window:
            while True:
                d, f, done = loop.step()
                records.append(d)
                flags[d.index] = f
                if done - t0 >= seconds or (limit and len(records) >= limit):
                    break
        window_s = done - t0
        peak_window = (torch.cuda.max_memory_allocated(device) if on_gpu
                       else None)
    loop.drain()
    trace_path = None
    if traced:
        trace_path = matrices.CACHE / f"trace-{workload}.json"
        trace_path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_path))
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: "
                         f"{found}")
    del pooled, decs, loop, prof
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()

    run = Run(config=config, traffic=traffic, device=device,
              setup_s=setup_s, window_s=window_s, shots_per_dispatch=shots,
              dispatches=records, peak_window_bytes=peak_window,
              power_limit=power_limit() if on_gpu else "cpu")
    if trace_path is not None:
        if on_gpu:
            run.trace = tracing.Trace.from_file(trace_path, missing)
        trace_path.unlink()

    # the check: a sample of the window's dispatches against the reference
    picked = [records[i].index for i in checks.sample(
        seed, len(records), measure["check_dispatches"])]
    t_check = time.time()
    numbers = judge(run, config, circ_matrices, p, draws, flags, picked)
    correct = checks.verdict(numbers)
    log(f"check: {len(picked)} of {len(records)} dispatches judged in "
        f"{time.time() - t_check:.2f} s", file=sys.stderr)

    metrics = {}
    for m in wanted:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    for note in run.notes:
        log(note, file=sys.stderr)
    dev = {"platform": "gpu" if on_gpu else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_gpu else "cpu",
           "count": 1,
           "memory_peak_bytes": (max(peak_setup, peak_window) if on_gpu
                                 else None)}
    result = {"correct": correct,
              "attempted": shots * len(records),
              "failed": int(sum(int(flags[d.index][4:6].any(0).sum())
                                for d in records)),
              "metrics": metrics, "device": dev}
    if traced:
        if run.trace is not None:
            dev["busy_s"] = run.trace.busy_s
            dev["window_s"] = run.trace.window_s
            result["breakdown"] = run.trace.breakdown()
        else:
            dev["window_s"] = window_s
    result["replays"] = sum(d.replayed for d in records)
    result["checks"] = {k: {"value": v, "limit": checks.LIMITS[k]}
                        for k, v in numbers.items()}
    for k, v in numbers.items():
        log(f"check {k}: {v} (limit {checks.LIMITS[k]}, over "
            f"{len(picked)} dispatches of {shots} shots, both bases, "
            f"{len(n_locs)} code(s))",
            file=sys.stderr)
    return result


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    man = manifest()
    cell, _, _ = cell_of(man, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the program on a GPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} GPUs; "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start, man)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
