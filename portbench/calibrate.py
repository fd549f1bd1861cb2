"""Readings for the limits of ``correct`` and for the knee of an open-loop
mix, on the chip, in one process:

    python3 portbench/calibrate.py --workload <name> --seeds 11,12,13 \\
        [--control 11,12,13] [--fault-seeds 11,12,13] [--seconds 8] [--rate 6.5] \\
        [--out FILE]

runs the cell once per seed as ``run.py`` runs it (``--seconds`` long,
untraced) and prints, per seed, the numbers ``correct`` compares, the
cell's end-to-end metrics and, for the seeds in ``--control``, the
control's readings: the plain reference computed with float8 (e4m3)
matrix products in the program's place (serving: at each position of the
same prompts and served tokens, the gap of the token that the control puts
first; training: the control's three steps against the float32
reference's, the fault of a loss over half the rows, and of a mixture of
experts the program against the reference on its own routing).  For the
seeds in ``--fault-seeds`` a second run has a fault planted in the
program: the grouped matmul's weight gradient doubled.  ``--rate``
replaces an open-loop mix's arrival rate (the sweep for the knee).  The
benchmark's own runs never run the control or a fault.
"""

from __future__ import annotations

import json
import os
import sys
import time

T_START = time.monotonic()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import contextlib  # noqa: E402

from portbench import run, testing  # noqa: E402


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rate", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    bench = run.common.benchmark()
    control = {int(s) for s in args.control.split(",") if s}
    faulty = {int(s) for s in args.fault_seeds.split(",") if s}
    rates = [float(r) for r in args.rate.split(",") if r] or [None]
    rows = []
    runs = [(rate, int(s), None) for rate in rates for s in args.seeds.split(",")]
    runs += [(None, s, "grouped_matmul_dw_x2") for s in sorted(faulty)]
    for rate, seed, fault in runs:
        t = time.monotonic()
        ctx = run.context(bench, args.workload, seed, args.seconds, False, "cuda",
                          time.monotonic(), control=seed in control and fault is None)
        if rate is not None:
            ctx.mix["arrivals"]["rate_per_s"] = rate
        torch.cuda.reset_peak_memory_stats()
        with (testing.grouped_matmul_dw_scaled(2.0) if fault
              else contextlib.nullcontext()):
            res = run.execute(bench, ctx)
        row = {"seed": seed, "rate": rate, "fault": fault, "seconds": time.monotonic() - t,
               "correct": res["correct"], "attempted": res["attempted"],
               "failed": res["failed"],
               "checks": {k: v["value"] for k, v in res["checks"].items()},
               "metrics": {k: v["value"] for k, v in res["metrics"].items()},
               "extra": res["extra"], "memory_peak_bytes": res["memory_peak_bytes"]}
        rows.append(row)
        print(json.dumps(row, default=float), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "device": torch.cuda.get_device_name(0),
                       "rows": rows}, f, indent=1, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main())
