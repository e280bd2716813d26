"""k3_roofline: kernel K3's (time-layered min-sum, ``bp_layered_kernel``)
share of its roofline on the checked dispatches of the traced window.

The least time of one K3 launch (one basis of one round, B shots) is the
larger of its float32 operations over the float32 peak outside the tensor
cores and its bytes over the memory bandwidth (``peaks.py``). Operations:
18 per edge of H and shot-sweep (the two half-sweeps' check updates and the
posterior rebuilt between them), the shot-sweeps counted by the layered
reference on the same draws (a shot's sweeps to convergence, or maxIter),
so the count does not depend on what implements BP. Bytes: each input read
once (syndromes, the prior, the alpha sequence) and each output written
once (posteriors, hard decisions, convergence flags, sweep counts). The
share is the sum of the least times over the sum of K3's device time on
those dispatches."""
from perfbench import peaks

KERNEL = "bp_layered_kernel"
OPS_PER_EDGE_SWEEP = 18


def launch_bound(B, m, n, max_iter, edges, shot_sweeps):
    flops = OPS_PER_EDGE_SWEEP * edges * shot_sweeps
    nbytes = B * m + 4 * n + 4 * max_iter + B * n * 5 + B * 5
    return peaks.roofline_s(flops, nbytes, peaks.F32_FLOPS)


def read(run):
    if run.trace is None or not run.iterations:
        return None
    B = run.config["dispatch"]["batch"]
    max_iter = run.config["decoder"]["max_iter"]
    bound, spent, kinds = 0.0, 0.0, set()
    for idx, per_basis in run.iterations.items():
        t = sum(s for name, s in run.trace.kernels[idx].items()
                if KERNEL in name)
        if t <= 0:
            continue
        for b, sweeps in per_basis.items():
            m, n = run.shape[b]
            for shot_sweeps in sweeps:
                s, kind = launch_bound(B, m, n, max_iter, run.edges[b],
                                       int(shot_sweeps))
                bound += s
                kinds.add(kind)
        spent += t
    if spent <= 0:
        return None
    run.notes.append(
        f"k3_roofline: {'/'.join(sorted(kinds))} bound "
        f"{bound * 1e3:.4f} ms against {spent * 1e3:.4f} ms of K3 over "
        f"{len(run.iterations)} dispatches; card {run.power_limit}")
    return 100.0 * bound / spent
