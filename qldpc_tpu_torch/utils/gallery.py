"""Explainer-figure gallery: the reference's ``info_vis/`` diagrams
regenerated from this framework's own objects.

The reference ships a 15-image pedagogical gallery (its
``info_vis/01_css_code_matrices.png`` ... ``12_decoder_performance.png``).
Each function here reproduces one diagram's subject from live framework
data — parity-check structure, the CNOT
schedule as a circuit drawing, the noise model's category weights, frame
propagation, a sampled syndrome trace, sparsification, the decoding
matrices, the Tanner graph, BP LLR evolution, the pipeline, and the
archived LER baselines. Drive with
``python -m qldpc_tpu_torch.scripts.info --gallery``.

The port's counterpart of the JAX package's ``utils/gallery.py``: the
figures that sample or decode (01c, 06, 07, 10) draw trials through
``ops.sampler.trial_batch`` with a seeded ``torch.Generator`` and decode
with ``ops.bp.decode_batch`` on the device the caller names (``cuda`` by
default; ``device="cpu"`` explicitly). All matplotlib, no qiskit/networkx
dependency.
"""
from __future__ import annotations

import os

import numpy as np
import torch

try:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
except ImportError:  # the figures need it; the sampling helpers do not
    plt = None

_C = dict(check="#b13f3f", data="#2f6fb1", edge="#9a9a9a", accent="#3a7d44")


def _save(fig, out_dir, name):
    path = os.path.join(out_dir, name)
    fig.savefig(path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return path


def fig_css_code_matrices(code, out_dir):
    """01: Hx/Hz sparsity + the CSS orthogonality certificate."""
    comm = (code.Hx @ code.Hz.T) % 2
    fig, axs = plt.subplots(1, 3, figsize=(12, 3.2),
                            gridspec_kw=dict(width_ratios=[2, 2, 1]))
    for ax, H, nm in ((axs[0], code.Hx, "$H_X$"), (axs[1], code.Hz, "$H_Z$")):
        ax.imshow(H, aspect="auto", cmap="Greys", interpolation="nearest")
        ax.set_title(f"{nm}  {H.shape}")
        ax.set_xlabel("data qubit")
        ax.set_ylabel("check")
    axs[2].imshow(comm, aspect="auto", cmap="Greys", vmin=0, vmax=1)
    axs[2].set_title(f"$H_X H_Z^T$ mod 2\n(all zero: CSS ok = "
                     f"{not comm.any()})")
    fig.suptitle(f"{code.name}: CSS parity-check structure")
    return _save(fig, out_dir, "01_css_code_matrices.png")


def fig_logical_operators(code, out_dir):
    """01b: Lx/Lz and the logical symplectic pairing."""
    pair = (code.Lx @ code.Lz.T) % 2
    fig, axs = plt.subplots(1, 3, figsize=(12, 2.6),
                            gridspec_kw=dict(width_ratios=[2, 2, 1]))
    axs[0].imshow(code.Lx, aspect="auto", cmap="Greys")
    axs[0].set_title(f"$L_X$  {code.Lx.shape}")
    axs[1].imshow(code.Lz, aspect="auto", cmap="Greys")
    axs[1].set_title(f"$L_Z$  {code.Lz.shape}")
    axs[2].imshow(pair, cmap="Greys", vmin=0, vmax=1)
    axs[2].set_title("$L_X L_Z^T = I_k$: "
                     f"{bool((pair == np.eye(len(pair))).all())}")
    fig.suptitle(f"{code.name}: logical operators (k = {code.Lx.shape[0]})")
    return _save(fig, out_dir, "01b_logical_operators.png")


def _trials(circ, matrices, device, p, seed, batch):
    """(syndrome_z, true_z) int8 tensors of ``batch`` sampled trials on
    ``device``, drawn from a ``torch.Generator`` seeded with ``seed``."""
    from ..ops.sampler import make_trial_maps, trial_batch
    maps = make_trial_maps(circ, matrices, "Z", device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = trial_batch(gen, p, maps, maps, circ.num_error_locs, batch)
    return out["syndrome_z"], out["true_z"]


def _bp_z(matrices, syn, maxIter):
    """Flooding min-sum on HdecZ (padded-CSR graph, float32) of the
    syndromes ``syn`` on their device."""
    from ..models.builder import channel_llrs
    from ..ops.bp import TannerGraph, alpha_schedule, decode_batch
    dev = syn.device
    H = (np.asarray(matrices["HdecZ"]) != 0).astype(np.uint8)
    prior = torch.as_tensor(channel_llrs(matrices["channel_probsZ"]),
                            dtype=torch.float32, device=dev)
    seq = torch.as_tensor(np.asarray(alpha_schedule("dynamical", maxIter),
                                     np.float32), device=dev)
    return decode_batch(TannerGraph.from_dense(H, device=dev), syn, prior,
                        seq, maxIter)


def fig_logical_error_flow(circ, matrices, out_dir, seed=5, device=None):
    """01c: a decoded trial — correction vs truth differ by a logical."""
    from .. import resolve_device
    syn_t, true_t = _trials(circ, matrices, resolve_device(device), 0.006,
                            seed, 8)
    syn = syn_t.cpu().numpy()
    true_log = true_t.cpu().numpy()
    hard = _bp_z(matrices, syn_t, 30)["hard"].cpu().numpy()
    k = matrices["k"]
    first = matrices["first_logical_rowZ"]
    HZ_log = (np.asarray(matrices["HZ_full"])[first:first + k] != 0)
    dec_log = (hard @ HZ_log.T) % 2
    fig, axs = plt.subplots(3, 1, figsize=(10, 4.2), sharex=False)
    axs[0].imshow(syn, aspect="auto", cmap="Greys")
    axs[0].set_ylabel("shot")
    axs[0].set_title("syndromes (8 sampled shots)")
    axs[1].imshow(dec_log, aspect="auto", cmap="Blues", vmin=0, vmax=1)
    axs[1].set_ylabel("shot")
    axs[1].set_title("decoded logical action  $L(\\hat e)$")
    err = dec_log ^ true_log
    axs[2].imshow(err, aspect="auto", cmap="Reds", vmin=0, vmax=1)
    axs[2].set_ylabel("shot")
    axs[2].set_title("logical ERROR = decoded $\\oplus$ true "
                     f"(any-mismatch rate {err.any(1).mean():.2f})")
    axs[2].set_xlabel("logical qubit")
    fig.tight_layout()
    return _save(fig, out_dir, "01c_logical_error_flow.png")


def fig_syndrome_detection(code, out_dir):
    """02: one physical X error fires exactly the Z-checks watching it."""
    j = int(np.argmax(code.Hz.sum(0)))  # a well-connected data qubit
    fired = code.Hz[:, j] != 0
    fig, ax = plt.subplots(figsize=(9, 2.8))
    ax.imshow(code.Hz, aspect="auto", cmap="Greys", alpha=0.35)
    ax.scatter([j] * int(fired.sum()), np.nonzero(fired)[0], s=60,
               color=_C["check"], zorder=3,
               label=f"checks fired by X on qubit {j}")
    ax.axvline(j, color=_C["data"], lw=1, ls="--")
    ax.set_xlabel("data qubit")
    ax.set_ylabel("Z check")
    ax.set_title(f"{code.name}: an X error on one qubit flips its "
                 f"{int(fired.sum())} incident Z checks")
    ax.legend(loc="upper right")
    return _save(fig, out_dir, "02_syndrome_detection.png")


def fig_syndrome_circuit(circ, out_dir, max_ops=64):
    """03: one measurement cycle as a circuit drawing — wires for one
    X check, one Z check, and every data qubit they touch; the depth-8
    CNOT schedule is read straight off the compiled gate tensors."""
    from ..models.circuit import (OP_CNOT, OP_IDLE, OP_MEAS_X, OP_MEAS_Z,
                                  OP_PREP_X, OP_PREP_Z)
    xq = circ.xcheck_off
    zq = circ.zcheck_off
    wires = [xq] + sorted(set(circ.nbs_x[0].tolist())
                          | set(circ.nbs_z[0].tolist())) + [zq]
    row = {q: i for i, q in enumerate(wires)}

    def label(q):
        n2 = circ.n2
        if q < circ.dl_off:
            return f"X{q}"
        if q < circ.dr_off:
            return f"dL{q - circ.dl_off}"
        if q < circ.zcheck_off:
            return f"dR{q - circ.dr_off}"
        return f"Z{q - circ.zcheck_off}"

    fig, ax = plt.subplots(figsize=(13, 0.55 * len(wires) + 1.2))
    col = 0
    for t in range(circ.cycle_len):
        op = int(circ.cycle_ops[t])
        q1 = int(circ.cycle_q1[t])
        q2 = int(circ.cycle_q2[t])
        if op == OP_CNOT:
            if not ((q1 in row and q1 in (xq, zq)) or
                    (q2 in row and q2 in (xq, zq))):
                continue
            if q1 not in row or q2 not in row:
                continue
            col += 1
            y1, y2 = row[q1], row[q2]
            ax.plot([col, col], [y1, y2], color="k", lw=1)
            ax.plot(col, y1, "o", color="k", ms=5)          # control
            ax.plot(col, y2, "o", mfc="white", mec="k", ms=9)
            ax.plot(col, y2, "+", color="k", ms=7)          # target
        elif op in (OP_PREP_X, OP_PREP_Z, OP_MEAS_X, OP_MEAS_Z):
            if q1 not in row:
                continue
            col += 1
            txt = {OP_PREP_X: "$|+\\rangle$", OP_PREP_Z: "$|0\\rangle$",
                   OP_MEAS_X: "$M_X$", OP_MEAS_Z: "$M_Z$"}[op]
            ax.text(col, row[q1], txt, ha="center", va="center",
                    fontsize=8, bbox=dict(boxstyle="round,pad=0.25",
                                          fc="#f2e8c9", ec="k", lw=0.7))
        if col >= max_ops:
            break
    for q, y in row.items():
        ax.plot([0, col + 1], [y, y], color=_C["edge"], lw=0.8, zorder=0)
        ax.text(-0.6, y, label(q), ha="right", va="center", fontsize=9)
    ax.set_ylim(len(wires) - 0.5, -0.5)
    ax.set_xlim(-2.5, col + 1.5)
    ax.axis("off")
    ax.set_title("one syndrome-extraction cycle around X-check 0 / "
                 "Z-check 0 (depth-8 CNOT schedule, "
                 "reference bb_code.py:153-189)")
    return _save(fig, out_dir, "03_syndrome_circuit.png")


def fig_noise_model(out_dir, p=0.006):
    """04: the circuit-level noise model's category weights."""
    fig, axs = plt.subplots(1, 2, figsize=(11, 3.2))
    axs[0].bar(["X", "Y", "Z"], [p / 3] * 3, color=_C["data"])
    axs[0].set_title("single-qubit fault (after prep / idle / before meas):"
                     "\neach Pauli w.p. p/3")
    axs[0].set_ylabel("probability")
    cats = ["IX", "IY", "IZ", "XI", "XX", "XY", "XZ", "YI", "YX", "YY",
            "YZ", "ZI", "ZX", "ZY", "ZZ"]
    axs[1].bar(cats, [p / 15] * 15, color=_C["check"])
    axs[1].set_title("two-qubit fault after CNOT: each of 15 Paulis "
                     "w.p. p/15\n(Z-frame marginals per fault class: "
                     "p, 2p/3, 4p/15 — builder.py)")
    axs[1].tick_params(axis="x", labelsize=7)
    fig.suptitle(f"noise model at p = {p} (reference model.py:41-54)")
    return _save(fig, out_dir, "04_noise_model.png")


def fig_error_propagation(out_dir):
    """05: the X/Z frame propagation rules through a CNOT."""
    fig, axs = plt.subplots(1, 2, figsize=(10, 2.8))
    for ax, (nm, src, dst, rule) in zip(axs, [
            ("X frame", "X on control", "X also on target",
             "control $\\to$ target (copy forward)"),
            ("Z frame", "Z on target", "Z also on control",
             "target $\\to$ control (copy backward)")]):
        for y, lbl in ((1, "control"), (0, "target")):
            ax.plot([0, 4], [y, y], color=_C["edge"])
            ax.text(-0.2, y, lbl, ha="right", va="center")
        ax.plot([2, 2], [0, 1], color="k", lw=1)
        ax.plot(2, 1, "o", color="k", ms=5)
        ax.plot(2, 0, "o", mfc="white", mec="k", ms=10)
        ax.plot(2, 0, "+", color="k", ms=8)
        ysrc = 1 if nm == "X frame" else 0
        ax.annotate(src.split(" on ")[0], (1.0, ysrc),
                    textcoords="offset points", xytext=(0, 10),
                    color=_C["check"], fontsize=11, ha="center")
        ax.annotate(src.split(" on ")[0], (3.0, 1 - ysrc),
                    textcoords="offset points", xytext=(0, 10),
                    color=_C["check"], fontsize=11, ha="center")
        ax.set_title(f"{nm}: {rule}", fontsize=10)
        ax.set_ylim(-0.8, 1.9)
        ax.axis("off")
    fig.suptitle("Pauli-frame propagation through CNOT "
                 "(reference simulation.py:132,181)")
    return _save(fig, out_dir, "05_error_propagation.png")


def _sample_syndrome(circ, matrices, p=0.006, seed=3, device=None):
    from .. import resolve_device
    syn, _ = _trials(circ, matrices, resolve_device(device), p, seed, 1)
    return syn.cpu().numpy()[0]


def fig_simulation_trace(circ, matrices, out_dir, device=None):
    """06: raw per-cycle measurement record of one sampled trial
    (recovered from the sparsified record by cumulative XOR over time)."""
    syn = _sample_syndrome(circ, matrices, device=device)
    n2 = circ.n2
    T = syn.size // n2
    sparse = syn.reshape(T, n2)
    raw = np.bitwise_xor.accumulate(sparse, axis=0)
    fig, ax = plt.subplots(figsize=(9, 3))
    ax.imshow(raw.T, aspect="auto", cmap="Greys", interpolation="nearest")
    ax.set_xlabel("measurement cycle")
    ax.set_ylabel("Z check")
    ax.set_title("one trial's raw measurement record: a fault flips a "
                 "check's outcomes for ALL later cycles")
    return _save(fig, out_dir, "06_simulation_trace.png")


def fig_sparsification(circ, matrices, out_dir, device=None):
    """07: consecutive-cycle XOR turns persistent flips into events."""
    syn = _sample_syndrome(circ, matrices, device=device)
    n2 = circ.n2
    T = syn.size // n2
    sparse = syn.reshape(T, n2)
    raw = np.bitwise_xor.accumulate(sparse, axis=0)
    fig, axs = plt.subplots(1, 2, figsize=(11, 3), sharey=True)
    axs[0].imshow(raw.T, aspect="auto", cmap="Greys")
    axs[0].set_title(f"raw record ({int(raw.sum())} ones)")
    axs[1].imshow(sparse.T, aspect="auto", cmap="Greys")
    axs[1].set_title(f"sparsified: XOR with previous cycle "
                     f"({int(sparse.sum())} ones)")
    for ax in axs:
        ax.set_xlabel("cycle")
    axs[0].set_ylabel("Z check")
    fig.suptitle("syndrome sparsification (reference simulation.py:212)")
    return _save(fig, out_dir, "07_sparsification.png")


def fig_decoding_matrix(matrices, out_dir):
    """08: the spatio-temporal decoding matrix + class probabilities."""
    H = np.asarray(matrices["HdecZ"]) != 0
    probs = np.asarray(matrices["channel_probsZ"])
    fig, axs = plt.subplots(2, 1, figsize=(10, 4.4), sharex=True,
                            gridspec_kw=dict(height_ratios=[4, 1]))
    axs[0].imshow(H, aspect="auto", cmap="Greys", interpolation="nearest")
    axs[0].set_ylabel("syndrome bit (cycle-major)")
    axs[0].set_title(f"HdecZ {H.shape}: columns = fault-equivalence "
                     "classes, rows = sparsified syndrome bits")
    axs[1].semilogy(probs, ",", color=_C["data"])
    axs[1].set_ylabel("class prob")
    axs[1].set_xlabel("fault class")
    return _save(fig, out_dir, "08_decoding_matrix.png")


def fig_augmented_decoding_matrix(matrices, out_dir):
    """08b: the augmented matrix — syndrome rows + logical-action rows."""
    full = np.asarray(matrices["HZ_full"]) != 0
    first = matrices["first_logical_rowZ"]
    k = matrices["k"]
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.imshow(full, aspect="auto", cmap="Greys", interpolation="nearest")
    ax.axhspan(first - 0.5, first + k - 0.5, color=_C["check"], alpha=0.25)
    ax.text(full.shape[1] * 0.995, first + k / 2,
            f"{k} logical rows", color=_C["check"], ha="right",
            va="center", fontsize=10)
    ax.set_xlabel("fault class")
    ax.set_ylabel("row")
    ax.set_title("augmented decoding matrix HZ_full: grouping faults by "
                 "(syndrome, logical action) signature")
    return _save(fig, out_dir, "08b_augmented_decoding_matrix.png")


def fig_tanner_graph(code, out_dir):
    """09: the code's Tanner graph (Z checks vs data qubits), bipartite."""
    H = np.asarray(code.Hz) != 0
    m, n = H.shape
    fig, ax = plt.subplots(figsize=(12, 3.6))
    xc = np.linspace(0, 1, m)
    xd = np.linspace(0, 1, n)
    rows, cols = np.nonzero(H)
    for r, c in zip(rows, cols):
        ax.plot([xd[c], xc[r]], [0, 1], color=_C["edge"], lw=0.25,
                alpha=0.5, zorder=0)
    ax.scatter(xc, np.ones(m), s=28, marker="s", color=_C["check"],
               zorder=2, label=f"{m} Z checks")
    ax.scatter(xd, np.zeros(n), s=18, color=_C["data"], zorder=2,
               label=f"{n} data qubits")
    ax.set_ylim(-0.25, 1.25)
    ax.axis("off")
    ax.legend(loc="center right", frameon=False)
    ax.set_title(f"{code.name} Tanner graph: every check touches "
                 f"{int(H.sum(1)[0])} qubits, every qubit "
                 f"{int(H.sum(0).max())} checks")
    return _save(fig, out_dir, "09_tanner_graph.png")


def fig_llr_evolution(circ, matrices, out_dir, seed=3, device=None):
    """10: BP posterior |LLR| trajectories across iterations."""
    from .. import resolve_device
    syn, _ = _trials(circ, matrices, resolve_device(device), 0.006, seed, 1)
    iters = list(range(1, 13))
    traj = []
    for it in iters:  # re-decode with growing maxIter: posterior after it
        traj.append(_bp_z(matrices, syn, it)["values"].cpu().numpy()[0])
    traj = np.stack(traj)                       # (iters, n)
    move = np.abs(traj[-1] - traj[0])
    sel = np.argsort(move)[-40:]                # the 40 most active columns
    fig, ax = plt.subplots(figsize=(9, 3.6))
    for j in sel:
        ax.plot(iters, traj[:, j], lw=0.8,
                color=_C["check"] if traj[-1, j] < 0 else _C["data"],
                alpha=0.7)
    ax.axhline(0, color="k", lw=0.6)
    ax.set_xlabel("BP iteration")
    ax.set_ylabel("posterior LLR")
    ax.set_title("min-sum posterior evolution (red: decided error; "
                 "blue: decided clean)")
    return _save(fig, out_dir, "10_llr_evolution.png")


def fig_complete_pipeline(out_dir):
    """11: the decode round as the framework actually executes it."""
    stages = [
        ("torch.Generator", "one stream a shard"),
        ("Pauli sampling", "(B, locs) categorical"),
        ("syndromes", "CUDA kernel S1: XOR of rows"),
        ("min-sum BP", "CUDA kernel K1 (or K3)"),
        ("sort by residual", "unconverged first"),
        ("OSD fallback", "CUDA kernel K2: GF(2) elim."),
        ("logical readout", "packed XOR reduce"),
        ("count all_reduce", "torch.distributed"),
    ]
    fig, ax = plt.subplots(figsize=(13, 2.2))
    for i, (a, b) in enumerate(stages):
        ax.text(i, 0.5, f"{a}\n{b}", ha="center", va="center", fontsize=8,
                bbox=dict(boxstyle="round,pad=0.45", fc="#eef3f8",
                          ec=_C["data"]))
        if i:
            ax.annotate("", (i - 0.42, 0.5), (i - 0.58, 0.5),
                        arrowprops=dict(arrowstyle="<-", color="k"))
    ax.set_xlim(-0.6, len(stages) - 0.4)
    ax.set_ylim(0, 1)
    ax.axis("off")
    ax.set_title("one pooled decode round on the GPU (thousands of shots "
                 "per dispatch; see parallel/engine.py)")
    return _save(fig, out_dir, "11_complete_pipeline.png")


def fig_decoder_performance(out_dir, validation_json=None):
    """12: archived reference LER baselines (BASELINE.md,
    output/run_20260123_141207) + this framework's validated points."""
    ref = {  # code -> (p, LER) from BASELINE.md's 200-error archive rows
        "[[72,12,6]]": [(0.006, 5.68e-1), (0.004, 1.70e-1)],
        "[[90,8,10]]": [(0.006, 7.43e-1), (0.004, 1.66e-1)],
        "[[108,8,10]]": [(0.006, 7.19e-1), (0.004, 1.52e-1)],
        "[[144,12,12]]": [(0.006, 8.77e-1), (0.005, 5.92e-1),
                          (0.004, 1.76e-1)],
        "[[288,12,18]]": [(0.006, 1.0), (0.005, 8.13e-1)],
    }
    fig, ax = plt.subplots(figsize=(7, 5))
    cmap = plt.get_cmap("tab10")
    for i, (nm, pts) in enumerate(ref.items()):
        ps, ls = zip(*pts)
        ax.loglog(ps, ls, "o--", color=cmap(i), label=f"{nm} (reference)")
    if validation_json and os.path.exists(validation_json):
        import json
        with open(validation_json) as f:
            val = json.load(f)  # list of {code, p, ler, ...} points
        by_code: dict = {}
        for q in val:
            if isinstance(q, dict) and "p" in q and "ler" in q:
                by_code.setdefault(q["code"].replace(" ", ""), []).append(
                    (q["p"], q["ler"]))
        names = list(ref)
        for nm, pts in by_code.items():
            pts = sorted(set(pts))
            ps, ls = zip(*pts)
            i = names.index(nm) if nm in names else len(names)
            ax.loglog(ps, ls, "s-", color=cmap(i % 10), mfc="none",
                      lw=1, label=f"{nm} (this framework)")
    ax.set_xlabel("physical error rate p")
    ax.set_ylabel("logical error rate")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend(fontsize=7)
    ax.set_title("decoder performance: archived reference baselines")
    return _save(fig, out_dir, "12_decoder_performance.png")


def generate_gallery(out_dir="info_vis", code_name="[[72, 12, 6]]",
                     num_cycles=4, p=0.006, validation_json=None,
                     verbose=True, device=None):
    """Regenerate the full explainer gallery (15 figures). Returns the list
    of written paths. Uses [[72,12,6]] at few cycles so the whole gallery
    builds in well under a minute; the sampled and decoded figures run on
    ``device`` (None = ``cuda``; raises without a GPU)."""
    from .. import resolve_device
    from ..models.bb import get_code
    from ..models.builder import build_decoding_matrices
    from ..models.circuit import SyndromeCircuit

    if plt is None:
        raise ImportError("the gallery's figures need matplotlib")
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    code = get_code(code_name)
    circ = SyndromeCircuit(code, num_cycles=num_cycles)
    matrices = build_decoding_matrices(circ, code.Lx, code.Lz, p)
    paths = [
        fig_css_code_matrices(code, out_dir),
        fig_logical_operators(code, out_dir),
        fig_logical_error_flow(circ, matrices, out_dir, device=dev),
        fig_syndrome_detection(code, out_dir),
        fig_syndrome_circuit(circ, out_dir),
        fig_noise_model(out_dir, p),
        fig_error_propagation(out_dir),
        fig_simulation_trace(circ, matrices, out_dir, device=dev),
        fig_sparsification(circ, matrices, out_dir, device=dev),
        fig_decoding_matrix(matrices, out_dir),
        fig_augmented_decoding_matrix(matrices, out_dir),
        fig_tanner_graph(code, out_dir),
        fig_llr_evolution(circ, matrices, out_dir, device=dev),
        fig_complete_pipeline(out_dir),
        fig_decoder_performance(out_dir, validation_json),
    ]
    if verbose:
        for p_ in paths:
            print("wrote", p_)
    return paths
