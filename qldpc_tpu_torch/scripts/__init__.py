"""Measurement entry points of the port, the counterparts of the JAX
package's scripts. Kernel studies (``scripts/pallas_gather_bench.py``,
``pallas_gather_probe.py``, ``bp_pallas_breakdown.py``):

    python -m qldpc_tpu_torch.scripts.gather_bench
    python -m qldpc_tpu_torch.scripts.gather_probe
    python -m qldpc_tpu_torch.scripts.bp_breakdown

the bench sweeps, each with the JAX script's arguments and result lines:

    python -m qldpc_tpu_torch.scripts.multicode_bench  # multicode_bench.py
    python -m qldpc_tpu_torch.scripts.pooled_ab        # pooled_ab.py
    python -m qldpc_tpu_torch.scripts.maxiter_sweep    # maxiter_sweep.py
    python -m qldpc_tpu_torch.scripts.bench288_sweep   # bench288_sweep.py
    python -m qldpc_tpu_torch.scripts.scaling_bench    # scaling_bench.py

and the OSD studies and stage costs:

    python -m qldpc_tpu_torch.scripts.osd144_stage_ab  # osd144_stage_ab.py
    python -m qldpc_tpu_torch.scripts.osd288_ab        # osd288_ab.py
    python -m qldpc_tpu_torch.scripts.osd288_probe     # osd288_probe.py
    python -m qldpc_tpu_torch.scripts.osd_margin_probe # osd_margin_probe.py
    python -m qldpc_tpu_torch.scripts.osd_microbench   # osd_microbench.py,
                                                       # osd_breakdown.py
    python -m qldpc_tpu_torch.scripts.bp_lift_bench    # bp_lift_bench.py;
                     # --layered: bp288_layered_lift_probe.py
    python -m qldpc_tpu_torch.scripts.osd_post_micro   # osd_post_micro.py
    python -m qldpc_tpu_torch.scripts.bp_microbench    # bp_microbench.py

the eliminators' block shape (``ops.osd_cuda``'s ``block_shots``,
``smem_budget`` and ``pick_block_shots``, ``QLDPC_OSD_TAIL_SMEM_KB``) and
the cycle-periodic BP layout:

    python -m qldpc_tpu_torch.scripts.osd_blockshots_sweep
    python -m qldpc_tpu_torch.scripts.osd288_tailblock_ab
    python -m qldpc_tpu_torch.scripts.osd_panel_probe
    python -m qldpc_tpu_torch.scripts.bp_grid_experiment

the decode of the reference-sampled trials of ``scripts/oracle_data/``
(``scripts/ler_oracle.py``'s ``ourdecode`` phase) and the evidence for
their logical basis:

    python -m qldpc_tpu_torch.scripts.ler_oracle ourdecode ...
    python -m qldpc_tpu_torch.scripts.ler_oracle basis ...

(``scripts/round_breakdown.py`` is ``python -m qldpc_tpu_torch.profile_round
--cumulative``.)

Each runs on ``cuda`` by default and raises without a GPU; ``--device cpu``
runs the plain versions (times are then host times, not device metrics).
Each prints the card's name and power limit first (:func:`card_line`).
``gather_timing.py`` times P1 and P2 alone on the card (CUDA graphs), for
this checkout or, with ``--root``, another one's package;
``handoff_timing.py`` does the same for the OSD's hand-off: G1 and K2, K4
and K5 on G1's output, and the host's time a call of G1 and K2.
"""
from __future__ import annotations

import statistics
import subprocess
import time

import torch


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or a
    note that the run is on the CPU."""
    if device.type != "cuda":
        return "device: cpu (plain versions; no device metric)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return f"card: {smi[0].strip() if smi else 'unknown'}"


def device_ms(fn, reps: int, device: torch.device) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls after one warm-up
    call: CUDA events around the run on a GPU, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int, device: torch.device) -> float:
    """Median host ms per call of ``fn`` over ``reps`` calls, the device
    synchronised after each (so each includes the fixed per-call floor),
    after one warm-up call. The median, because host clocks on a shared
    machine have outliers."""
    def call():
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) * 1e3
    call()
    return statistics.median(call() for _ in range(reps))


def timed(name: str, fn, reps: int, device: torch.device, stat: str = "min",
          width: int = 44):
    """Host ms of ``fn`` with the device synchronised after each call: one
    warm-up call, then ``reps`` calls; the least (``stat="min"``) or the
    mean (0 with no rep). Prints ``name`` and the ms; returns (the last
    output, ms)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    out = fn()
    sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync()
        ts.append((time.perf_counter() - t0) * 1e3)
    ms = (0.0 if not ts else min(ts) if stat == "min"
          else statistics.fmean(ts))
    print(f"{name:{width}s} {ms:9.2f} ms", flush=True)
    return out, ms


def reset_peak(device: torch.device):
    """Start a new reading of :func:`peak_gib` (nothing on the CPU)."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_gib(device: torch.device):
    """GiB of device memory allocated at the peak since the last
    :func:`reset_peak`; None on the CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def bases(circ, M, maxIter: int, osd_order: int, device,
          which: str = "ZX") -> list:
    """The decode bases ``which`` (Z, X) of a circuit's matrices with the
    dynamical schedule of ``maxIter`` iterations."""
    from ..ops.bp import alpha_schedule
    from ..parallel.engine import _make_basis
    seq = alpha_schedule("dynamical", maxIter)
    return [_make_basis(circ, M, b, seq, osd_order=osd_order, device=device)
            for b in which]


def build(code_name: str, p: float, maxIter: int, osd_order: int, device,
          cycles: int = None, which: str = "ZX") -> tuple:
    """The bench's set-up (``bench_cuda.py`` runs it): the registry code at
    its distance in cycles (or ``cycles``), its decoding matrices (cached in
    ``matrix_cache/`` in the working directory, the JAX package's format)
    and the bases ``which``. Returns (circuit, matrices, [dec_z, dec_x])
    (or the bases asked for)."""
    from .. import get_code
    from .bp_breakdown import cached_matrices
    code = get_code(code_name)
    circ, M = cached_matrices(code, cycles or code.distance, p)
    return circ, M, bases(circ, M, maxIter, osd_order, device, which)


def residual_order(dec, syndrome, values, hard) -> tuple:
    """The OSD's inputs as ``ops.osd.osd_batch`` forms them: the residual
    syndrome (B, m) int32 that the correction must reproduce and the
    columns in reliability order (B, n) (stable sort of |LLR|)."""
    from ..ops.osd_cuda import bp_residual
    residual = bp_residual(syndrome, hard, dec.HT, dec.col_index)[0]
    return residual, torch.sort(values.abs(), dim=1, stable=True).indices


def eliminate(dec, cols, residual, Kx: int, exit_on_valid: bool,
              reps: int, device: torch.device) -> tuple:
    """G1's pack of each shot's first ``Kx`` columns of ``cols``, then the
    eliminator ``ops.osd_cuda.eliminate_blocks`` selects (K2, or K4 / K5
    under ``QLDPC_OSD_KERNEL``), without the reduced matrix. Returns (s_red
    (B, M), used (B, M), colofrow (B, M), the eliminator's ms). On the card
    the ms is its launch alone (``handoff_timing.alone_ms``: ``reps``
    launches in a CUDA graph, a consumed input restored before each, the
    restore's time taken away); on the CPU the host's least ms of ``reps``
    calls of the plain version (0 when ``reps`` is 0)."""
    from ..ops import osd_cuda
    m = dec.H.shape[0]
    Kxp = -(-Kx // 32) * 32
    Hp = osd_cuda.gather_pack(dec.col_index, cols[:, :Kx], Kxp)
    if device.type != "cuda":
        def run():
            return osd_cuda.eliminate_blocks(Hp, residual, Kx, m,
                                             rank=dec.rank,
                                             exit_on_valid=exit_on_valid,
                                             want_matrix=False)
        out, ts = run(), []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = run()
            ts.append((time.perf_counter() - t0) * 1e3)
        return out[1], out[3], out[4], min(ts, default=0.0)
    from .handoff_timing import alone_ms
    pristine = Hp.clone()
    launch, finish = osd_cuda.prepare_elim_launch(
        Hp, residual, Kx, m, rank=dec.rank, exit_on_valid=exit_on_valid,
        kernel=osd_cuda.selected_kernel(), want_matrix=False)
    restore = ((lambda: launch.tensors[0].copy_(pristine))
               if launch.consumes_input else None)
    ms = alone_ms(launch, reps, device, restore) if reps else 0.0
    if restore is not None:
        restore()
    launch()
    out = finish()
    return out[1], out[3], out[4], ms


def unsatisfied(s_red, used, m: int):
    """(B,) unsatisfied checks after an elimination: reduced-syndrome bits
    on rows < m that hold no pivot (0: the residual lies in the pivot span,
    the shot is valid)."""
    return torch.where(used, 0, s_red)[:, :m].sum(1)


def exit_depth(used, colofrow):
    """(B,) the deepest column a shot pivoted on before its validity exit
    (-1: none)."""
    return torch.where(used, colofrow, -1).amax(1)
