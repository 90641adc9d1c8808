#!/usr/bin/env python3
"""The readings a cell's limits are set from, many seeds in one process:

    python3 port_bench/readings.py --workload dtu.early \\
        --seeds 11,12,13 [--control] [--faults half_batch,altered] \\
        [--out chiprun_out/readings.jsonl]

For each seed: set-up as a benchmark run makes it (no measured window),
then the compared numbers of the program against the reference, and with
``--control`` those of the reference in float32 with TF32 matmuls (the
control, which has to fail); then, for each named fault
(``harness/faults.py``), the program's numbers with that fault planted.
One JSON line a reading. Needs the card, as a benchmark run does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import run as bench  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    bench.configure()
    import torch

    from port_bench.harness import cell as cell_mod
    from port_bench.harness import faults
    if not torch.cuda.is_available():
        print("readings need the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = cell_mod.load(args.workload)
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        runs = [("program", None)] + [
            (f, f) for f in args.faults.split(",") if f]
        for name, fault in runs:
            t0 = time.perf_counter()
            ctx = faults.FAULTS[fault]() if fault else \
                contextlib.nullcontext()
            with ctx:
                res = bench.measure(cell, seed, 0.0, False, device,
                                    control=args.control and not fault,
                                    window=False)
            for side, nums in res["readings"].items():
                rec = {"workload": args.workload, "seed": seed,
                       "side": side if not fault else fault,
                       "numbers": nums,
                       "seconds": time.perf_counter() - t0}
                line = json.dumps(rec)
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
            torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
