"""A configuration's decoding matrices: built by the frozen copy of the
circuit-to-matrix arithmetic (``frozen/``), cached in ``build/perfbench/``
inside the checkout, and handed as the same arrays to the program's set-up
and to the reference.

A configuration holds one code (``code`` and ``num_cycles``) or several
(``codes``: a list of ``{"code": ..., "num_cycles": ...}``) that share its
``decoder``, ``dispatch`` and ``measure``. :func:`parts` turns either into
one part per code, and everything here works on a part."""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np

from .frozen.bb import BBCode
from .frozen.builder import build_decoding_matrices, channel_llrs  # noqa: F401
from .frozen.circuit import LOC_IDLE, SyndromeCircuit

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "perfbench"
_INT_KEYS = ("first_logical_rowZ", "first_logical_rowX", "num_cycles", "k")
_BIT_KEYS = ("HdecZ", "HdecX", "HZ_full", "HX_full")


def parts(config: dict) -> list:
    """One configuration per code: the configuration itself where it holds
    one code; else, for code i of ``codes``, the configuration with that
    code's ``code`` and ``num_cycles``, named ``<name>.<i>`` (its caches'
    name)."""
    if "codes" not in config:
        return [config]
    rest = {k: v for k, v in config.items() if k != "codes"}
    return [dict(rest, name=f"{config['name']}.{i}", code=c["code"],
                 num_cycles=c["num_cycles"])
            for i, c in enumerate(config["codes"])]


def code_of(config: dict) -> BBCode:
    c = dict(config["code"])
    return BBCode(name=c.pop("name"), **c)


def _key(config: dict, p: float) -> str:
    text = json.dumps([config["code"], config["num_cycles"], f"{p:.9g}"],
                      sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def _save(path: Path, arrays: dict) -> None:
    """Write ``arrays`` to ``path`` through a temporary name, so that a run
    cut short leaves no torn file behind."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)


def load(config: dict, p: float) -> tuple:
    """(circuit, matrices, idle) for the part ``config`` at noise rate
    ``p``: the frozen builder's circuit, its decoding matrices (the bit
    matrices as uint8) and, per gate location, whether it is an idle."""
    code = code_of(config)
    circ = SyndromeCircuit(code, num_cycles=config["num_cycles"])
    path = CACHE / "matrices" / f"{config['name']}-{_key(config, p)}.npz"
    if path.exists():
        with np.load(path) as data:
            M = {k: int(data[k]) if k in _INT_KEYS else data[k]
                 for k in data.files}
    else:
        M = build_decoding_matrices(circ, code.Lx, code.Lz, p)
        for k in _BIT_KEYS:
            M[k] = (np.asarray(M[k]) % 2).astype(np.uint8)
        _save(path, M)
    return circ, M, circ.loc_kind == LOC_IDLE


def cached_array(config: dict, p: float, tag: str, make) -> np.ndarray:
    """``make()`` cached beside the matrices under ``tag`` (the reference
    keeps what it derives from them here: its column bases)."""
    path = CACHE / "reference" / f"{config['name']}-{_key(config, p)}-{tag}.npz"
    if path.exists():
        with np.load(path) as data:
            return data["a"]
    a = np.asarray(make())
    _save(path, {"a": a})
    return a
