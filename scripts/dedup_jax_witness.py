#!/usr/bin/env python3
"""Tracking error of the JAX package (`unislam_tpu`) with the band row
dedup on (`rendering.dedup_band`), on the scene of `chip_smoke.py`.

    JAX_PLATFORMS=cpu python3 scripts/dedup_jax_witness.py [--frames 200]
        [--seeds 0,1,2,3] [--dedup 1.0] [--jobs 4] [--out DIR]

The reference witness for `chip_smoke.py`'s `brick_dedup` drive: the same
room0-scale procedural scene and configs/Replica/room0_tpu.yaml as
`scripts/lowp_jax_witness.py` (whose `setup` and `run` it uses), with
`rendering.dedup_band` set, driven frame by frame through the JAX
package's own `UniSLAM.step_frame` on the CPU. `--jobs` runs that many
seeds at once, each in its own process (they share nothing but the CPU).

It imports nothing of the PyTorch port. The two packages draw their rays
from different generators, so a seed here and the same seed in the port
are different runs. Prints one JSON line per run (ATE-RMSE in cm, each
frame's translation error in cm, wall s) and a `summary` line with the
median ATE and the bar it sets, max(3 cm, median), and writes them to
`--out`/dedup_jax_witness.json. About 8 s a frame on 4 CPU cores, 2 GiB
of host memory a process.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAR_FLOOR_CM = 3.0


def one_seed(frames: int, seed: int, dedup: float) -> dict:
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from lowp_jax_witness import run, setup

    t0 = time.perf_counter()
    cfg, ds = setup(frames, {"rendering": {"dedup_band": dedup}})
    frame_list = [ds[i] for i in range(frames)]
    render_s = time.perf_counter() - t0
    return {"dedup_band": dedup, "seed": seed, "render_s": render_s,
            **run(cfg, frame_list, seed)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--dedup", type=float, default=1.0)
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "dedup_jax_witness"))
    ap.add_argument("--child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]

    if args.child:                   # one seed, its record on stdout
        print("run " + json.dumps(one_seed(args.frames, seeds[0],
                                           args.dedup)), flush=True)
        return 0

    runs, pending = [], list(seeds)
    procs = []
    while pending or procs:
        while pending and len(procs) < max(1, args.jobs):
            s = pending.pop(0)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--child",
                 "--frames", str(args.frames), "--seeds", str(s),
                 "--dedup", str(args.dedup)],
                stdout=subprocess.PIPE, text=True))
        proc = procs.pop(0)
        out, _ = proc.communicate()
        if proc.returncode != 0:
            for p in procs:
                p.kill()
            raise SystemExit(f"a seed's run exited {proc.returncode}")
        line = [ln for ln in out.splitlines() if ln.startswith("run ")][-1]
        runs.append(json.loads(line[4:]))
        print(line, flush=True)

    ates = [r["ate_cm"] for r in runs]
    median = statistics.median(ates)
    summary = {"dedup_band": args.dedup, "frames": args.frames,
               "seeds": [r["seed"] for r in runs], "ate_cm": ates,
               "median": median, "bar_cm": max(BAR_FLOOR_CM, median)}
    print("summary " + json.dumps(summary), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "dedup_jax_witness.json"), "w") as f:
        json.dump({"runs": runs, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
