"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, and loaded
with ``ctypes``. Libraries land in ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``), named by a hash of the source and the
flags and every shared header of ``csrc/`` (``*.cuh``: the BP kernels
include ``bp_lift_common.cuh``, the eliminators ``gf2_elim_common.cuh``), so
an edited source or header rebuilds and an unchanged one is reused.
``build_all`` starts one ``nvcc`` per source at once.

``-fmad=false`` keeps every multiply and add separately rounded: the BP
kernel must reproduce its plain PyTorch version bit for bit.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
SOURCES = ("bp_lift_flood", "bp_lift_layered", "gf2_elim", "gf2_elim_fused",
           "gf2_elim_pair", "gather_pack", "gather_iter", "take_along",
           "trial_syndromes", "bp_residual")
# shared memory one H100 block may opt in to (227 KB), in bytes
SMEM_PER_BLOCK = 232448

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "csrc/ on a machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    src = SRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for dep in sorted(SRC_DIR.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    (target, process, temporary output) with process None when reused."""
    out = _target(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    with open(BUILD_DIR / f"{name}.log", "w") as log:
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
             str(SRC_DIR / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
    return out, proc, tmp


def _finish(name: str, out: Path, proc, tmp) -> None:
    if proc is None:
        return
    rc = proc.wait()
    if rc != 0:
        text = (BUILD_DIR / f"{name}.log").read_text()
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (rc {rc}):\n"
                           f"{text[-4000:]}")
    os.replace(tmp, out)


def build_all(names=SOURCES) -> dict:
    """Compile every kernel source concurrently; returns {name: path}."""
    with _lock:
        started = {nm: _start(nm) for nm in names}
        for nm, (out, proc, tmp) in started.items():
            _finish(nm, out, proc, tmp)
    return {nm: out for nm, (out, _, _) in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all((name,))[name]
        with _lock:
            lib = _libs.setdefault(name, ctypes.CDLL(str(path)))
    return lib


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/shared-memory report) of the last build
    of ``name`` in this checkout, or '' when the library was reused."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
