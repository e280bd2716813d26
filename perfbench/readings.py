"""The control's readings of the check's numbers, on a card, at a cell's own
size: the limits of ``checks.py`` are set between the program's readings
(every run prints them) and these.

    python3 perfbench/readings.py --workload NAME --seeds S [S ...]
        [--dispatches K]

The control is the reference put in the program's place and computed one
precision below the configuration's float32 messages: bfloat16 messages
(posteriors still summed in float32). For each seed it decodes K dispatches
of the cell's draws (dispatch indices 0..K-1; K defaults to the cell's
``check_dispatches``) with the reference and with the control and prints
one JSON line per seed with the numbers ``checks.compare`` gives, summed
over the configuration's codes and per code. Run on the card only: the
benchmark's own runs never run it.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import argparse  # noqa: E402

import torch  # noqa: E402

from perfbench import checks, harness, matrices  # noqa: E402
from perfbench.reference import decode  # noqa: E402


def flags_of(out: dict):
    zero = torch.zeros_like(out["z_err"])
    return torch.stack([out.get(k, zero) for k in checks.FLAGS]).cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dispatches", type=int)
    args = ap.parse_args(argv)
    _, config, traffic = harness.cell_of(harness.manifest(), args.workload)
    p = float(traffic["p"])
    k = args.dispatches or config["measure"]["check_dispatches"]
    parts = matrices.parts(config)
    cms = [matrices.load(part, p) for part in parts]
    bases = [harness.reference_bases(part, cm, p, "cuda")
             for part, cm in zip(parts, cms)]
    n_locs = [cm[0].num_error_locs for cm in cms]
    for seed in args.seeds:
        draws = harness.draws_of(config, seed, p, n_locs, "cuda")
        total = dict.fromkeys(checks.LIMITS, 0)
        per_code = []
        t0 = time.time()
        for code_bases, draw in zip(bases, draws):
            mine = dict.fromkeys(checks.LIMITS, 0)
            for i in range(k):
                rnd = draw(i)
                ref = {key: v.cpu().numpy() for key, v in
                       decode.decode_round(code_bases, rnd).items()}
                ctl = flags_of(decode.decode_round(code_bases, rnd,
                                                   msg_dtype=torch.bfloat16))
                for key, v in checks.compare(ctl, ref).items():
                    mine[key] += v
                    total[key] += v
            per_code.append(mine)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dispatches": k, "control": total,
                          "per_code": per_code,
                          "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
