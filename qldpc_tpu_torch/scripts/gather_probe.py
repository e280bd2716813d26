"""P2, take-along-axis, at every form of the JAX package's gather probe.

Counterpart of ``scripts/pallas_gather_probe.py``, which mapped the
dynamic-gather forms the TPU compiler accepts: the same ladder of shapes,
axis 0 and 1, float32 and int32, and the same inputs (numpy's
``default_rng(0)`` per case). Each case runs ``ops.gather.take_along``
(kernel P2) and prints ``OK match=True`` when it equals
``torch.take_along_dim``. On Hopper every form is expected to build and
run: a case that fails to launch raises, and a mismatch makes the run exit
with status 1.

Usage (from the root of a checkout):

    python -m qldpc_tpu_torch.scripts.gather_probe [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import resolve_device
from ..ops.gather import take_along
from . import card_line

SHAPES = ((8, 128), (16, 128), (64, 128), (256, 128), (1024, 128), (8, 256),
          (64, 256))
DTYPES = (torch.float32, torch.int32)


def probe_inputs(shape, dtype, axis: int, device="cpu"):
    """(x, idx) of one case, drawn as the JAX probe draws them."""
    rng = np.random.default_rng(0)
    if dtype.is_floating_point:
        x = torch.as_tensor(rng.standard_normal(shape)).to(dtype)
    else:
        x = torch.as_tensor(rng.integers(0, 100, shape)).to(dtype)
    idx = torch.as_tensor(rng.integers(0, shape[axis], shape).astype(np.int32))
    return x.to(device), idx.to(device)


def cases():
    """(name, shape, dtype, axis) in the JAX probe's order."""
    for axis in (0, 1):
        for shape in SHAPES:
            for dtype in DTYPES:
                name = str(dtype).replace("torch.", "")
                yield f"axis={axis} {shape} {name}", shape, dtype, axis


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    results = []
    for name, shape, dtype, axis in cases():
        x, idx = probe_inputs(shape, dtype, axis, dev)
        out = take_along(x, idx, axis)
        ok = torch.equal(out, torch.take_along_dim(x, idx.long(), axis))
        print(f"{name:40s} OK  match={ok}", flush=True)
        results.append(dict(name=name, match=ok))
    if not all(r["match"] for r in results):
        sys.exit(1)
    return results


if __name__ == "__main__":
    main()
