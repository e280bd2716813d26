"""The benchmark of ``qldpc_tpu_torch``, the PyTorch and CUDA port: one run
of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout, on a machine with the cell's GPUs. Prints
the result as one JSON object, the last line of standard output; the
numbers the check compared, each beside its limit, are the last lines of
standard error. Without a CUDA device (or with fewer than the cell asks
for) it prints no result and exits with 2. Builds and caches stay inside
the checkout, under ``build/``.
"""
import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, ROOT)
    from perfbench import harness
    return harness.main(sys.argv[1:], T_START)


if __name__ == "__main__":
    sys.exit(main())
