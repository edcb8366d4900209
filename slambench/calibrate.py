#!/usr/bin/env python3
"""Readings for the output check's limits, many seeds in one process.

    python3 slambench/calibrate.py --workload <name> --seeds 1,2,3
        [--seconds 5] [--faults] [--rehearse]

For each seed: the cell's set-up and a short window at its own load, then
the check frame, whose iterations are judged twice: the program's outputs
(the lower reading of each number is the largest over sound runs) and the
control, the plain reference computed with TF32 products in the program's
place (the upper reading is the smallest over seeds). With --faults, each
fault of `faults.py` is planted under a further check frame. One JSON line
a seed, with each iteration's loss gaps; the benchmark's runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args()
    from slambench.faults import FAULTS
    from slambench.run import Session

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ses = Session(args.workload, seed, rehearse=args.rehearse)
        win = ses.window(args.seconds)
        t1 = time.perf_counter()
        line = {"seed": seed, "frames": win["n"],
                **ses.check(("program", "control")),
                "borderline": ses.borderline, "loss_gaps": ses.loss_gaps,
                "check_s": time.perf_counter() - t1}
        if args.faults:
            for name, fault in FAULTS.items():
                with fault():
                    line[name] = ses.check()["program"]
        ses.close()
        line["s"] = time.perf_counter() - t0
        print("calib " + json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
