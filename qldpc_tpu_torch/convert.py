"""Carry a JAX ``BasisDecoder`` across into the port.

The JAX package's per-basis decode bundle (``qldpc_tpu.parallel.engine
.BasisDecoder``) is a pytree of device arrays plus static metadata. Its
leaves travel here as numpy arrays (``np.asarray`` of each leaf) and become
the port's :class:`~qldpc_tpu_torch.parallel.engine.BasisDecoder` on one
device. The 0/1 matrices the JAX bundle keeps in bfloat16 (signature
matrix, logical action) are exact in any type and arrive as float32 or
integers.

``arrays`` keys: ``sel``, ``gate_loc``, ``A_loc`` (L, R) from the trial
maps; ``prior_grid``, ``slot_mask``, ``cmask``, ``out_gather``,
``residual`` from the lifted graph; ``H`` (m, n), ``H_logical`` (n, k),
``logical_pack``, ``prior``, ``alpha_seq``, ``basis_cols``; ``row_cols``,
``row_mask``, ``col_edges``, ``col_mask`` from the padded-CSR Tanner graph
(:func:`tanner_from_jax`). The lifted graph's keys are absent when the JAX
bundle has no lift (``lifted`` None).

``meta`` keys: ``num_syn``, ``k`` (trial maps); ``eb_pb``, ``eb_o``,
``eb_cx``, ``eb_cy``, ``NB``, ``ell``, ``mm``, ``T``, ``n``, ``m`` (lifted
graph); ``K``, ``num_test``, ``rank``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .ops.bp import TannerGraph
from .ops.bp_lift import LiftedGraph
from .ops.osd_cuda import column_index
from .ops.sampler import trial_maps_from_arrays
from .parallel.engine import BasisDecoder

LIFT_STATICS = ("eb_pb", "eb_o", "eb_cx", "eb_cy", "NB", "ell", "mm", "T",
                "n", "m")


def _tensor(arrays: dict, name: str, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(
        np.asarray(arrays[name]).astype(dtype)), device=dev)


def tanner_from_jax(arrays: dict, device=None) -> TannerGraph:
    """The port's TannerGraph from the four arrays of a JAX one
    (``row_cols``, ``row_mask``, ``col_edges``, ``col_mask``)."""
    dev = resolve_device(device)
    row_cols = _tensor(arrays, "row_cols", np.int64, dev)
    col_edges = _tensor(arrays, "col_edges", np.int64, dev)
    return TannerGraph(
        row_cols=row_cols, row_mask=_tensor(arrays, "row_mask", np.bool_, dev),
        col_edges=col_edges,
        col_mask=_tensor(arrays, "col_mask", np.bool_, dev),
        m=row_cols.shape[0], n=col_edges.shape[0], dr=row_cols.shape[1],
        dc=col_edges.shape[1])


def basis_from_jax(arrays: dict, meta: dict, device=None) -> BasisDecoder:
    """The port's decode bundle from the leaves of a JAX BasisDecoder."""
    dev = resolve_device(device)

    def t(name, dtype):
        return _tensor(arrays, name, dtype, dev)

    maps = trial_maps_from_arrays(arrays["sel"], arrays["gate_loc"],
                                  arrays["A_loc"], meta["num_syn"], meta["k"],
                                  dev)
    statics = {k: (tuple(int(v) for v in meta[k])
                   if k.startswith("eb_") else int(meta[k]))
               for k in LIFT_STATICS if k in meta}
    lifted = None
    if "prior_grid" in arrays:
        lifted = LiftedGraph(
            prior_grid=t("prior_grid", np.float32),
            slot_mask=t("slot_mask", np.bool_),
            cmask=t("cmask", np.bool_),
            out_gather=t("out_gather", np.int64),
            residual=t("residual", np.bool_),
            **statics)
    H = np.asarray(arrays["H"]).astype(np.uint8)
    return BasisDecoder(
        maps=maps, graph=tanner_from_jax(arrays, dev), lifted=lifted,
        H=torch.as_tensor(H, device=dev),
        HT=torch.as_tensor(np.ascontiguousarray(H.T, np.float32),
                           device=dev),
        H_logical=t("H_logical", np.float32),
        logical_pack=t("logical_pack", np.int32),
        prior=t("prior", np.float32),
        alpha_seq=t("alpha_seq", np.float32),
        basis_cols=t("basis_cols", np.int64),
        K=int(meta["K"]), num_test=int(meta["num_test"]),
        rank=int(meta["rank"]), col_index=column_index(H, dev))
