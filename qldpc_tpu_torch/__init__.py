"""qldpc_tpu_torch — PyTorch/CUDA port of the qLDPC Monte-Carlo decoder.

The host layer (BB codes, circuits, decoding matrices) is NumPy; the decode
round (sampling, min-sum BP, OSD, logical readout) runs on an NVIDIA GPU
through hand-written CUDA kernels (``csrc/``), with a plain PyTorch twin of
each kernel for CPU tensors. Calibration and the BP variants the JAX package
runs as XLA (damped, tanh, graphs without a lift) are PyTorch ops on the
same device. ``run_simulation`` and ``run_multi_code_simulation`` run over
a shot mesh (``parallel/mesh.py``): one process per GPU in a
``torch.distributed`` group joined by ``distributed_init_from_env()`` from
the ``QLDPC_COORDINATOR``, ``QLDPC_NUM_PROCESSES`` and ``QLDPC_PROCESS_ID``
variables, or several shards in one process. ``BatchDecoder`` decodes
measured syndromes through the same path, ``parallel.code_capacity``
runs iid errors on a raw parity-check matrix, and ``python -m
qldpc_tpu_torch`` is the sweep driver.

Device rule: every entry point runs on ``cuda`` by default and raises when no
GPU is present unless the caller passes ``device="cpu"``. Nothing falls back
to the CPU silently.
"""
from __future__ import annotations

__version__ = "0.1.0"

import torch

from .models.bb import BBCode, CODE_REGISTRY, get_code
from .models.builder import build_decoding_matrices, channel_llrs
from .models.circuit import SyndromeCircuit


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a visible GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "qldpc_tpu_torch runs on a CUDA GPU and none is visible; pass "
            "device='cpu' to run the plain PyTorch versions explicitly")
    return dev


def __getattr__(name):
    # lazy: the engine pulls in the whole decode stack
    if name == "BatchDecoder":
        from .parallel.decoder import BatchDecoder
        return BatchDecoder
    if name in ("run_simulation", "run_multi_code_simulation"):
        from .parallel import engine
        return getattr(engine, name)
    raise AttributeError(name)
