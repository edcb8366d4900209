#!/usr/bin/env python3
"""Tracking error of the JAX package (`unislam_tpu`) on the benchmark's
desk-scale stream with TUM RGB-D fr1/desk's settings.

    JAX_PLATFORMS=cpu python3 scripts/tum_desk_jax_witness.py [--frames 60]
        [--seeds 0,1,2,3] [--jobs 4] [--out DIR]

The trackability record of the `tum_fr1desk_hash` configuration: its
frozen config (`slambench/configs/tum_fr1desk_hash.json`: fr1/desk.yaml
over tum.yaml over UNISLAM.yaml, the bound set to the scene's box) and its
scene, the procedural room of the JAX package's `SyntheticRoom` with the
file's `scene` parameters, rendered at the config's cropped camera (368x496)
at the `holes` traffic's 0.75 degrees a frame, with the traffic's depth
dropouts: 16x16-pixel blocks over 5% of each frame, drawn as the benchmark
draws them for that seed and frame (`slambench/scene.py: frame_rng`,
`depth_holes`). Driven frame by frame through the JAX package's own
`UniSLAM.step_frame` on the CPU. `--jobs` runs that many seeds at once,
each in its own process.

It imports nothing of the PyTorch port (`slambench.scene` is the
benchmark's renderer module: numpy and torch only). The two packages draw
their rays from different generators, so a seed here and the same seed in
the port are different runs over the same frames. Prints one JSON line per
run (ATE-RMSE in cm, the error every 10 frames and every frame's
translation error in cm, wall s) and a `summary` line with each seed's
ATE, its largest frame error and whether every seed stayed under 3 cm,
and writes them to `--out`/tum_desk_jax_witness.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(HERE, "slambench", "configs", "tum_fr1desk_hash.json")
TRAFFIC = os.path.join(HERE, "slambench", "traffic", "holes.json")
BAR_CM = 3.0


def setup(n_frames: int, seed: int):
    """The config, and the frames with the traffic's dropouts for `seed`."""
    from slambench.scene import depth_holes, frame_rng
    from unislam_tpu.data.synthetic import SyntheticRoom
    from unislam_tpu.engine.slam import intrinsics_from_cfg

    with open(CONFIG) as f:
        spec = json.load(f)
    with open(TRAFFIC) as f:
        traffic = json.load(f)
    cfg = spec["slam"]
    cfg["data"]["prefetch"] = False
    sc = spec["scene"]
    ds = SyntheticRoom(n_frames=n_frames, intr=intrinsics_from_cfg(cfg),
                       half=sc["half"], orbit_r=sc["orbit_r"],
                       sphere_c=tuple(sc["sphere_c"]),
                       sphere_r=sc["sphere_r"], texture=sc["texture"],
                       deg_per_frame=traffic["deg_per_frame"])
    holes = traffic["depth_holes"]
    frames = []
    for i in range(n_frames):
        color, depth, c2w = ds[i]
        depth = depth_holes(depth, frame_rng(seed, i), holes["block_px"],
                            holes["share"])
        frames.append((color, depth, c2w))
    return cfg, frames


def one_seed(n_frames: int, seed: int) -> dict:
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, HERE)
    import numpy as np
    from unislam_tpu.engine.slam import UniSLAM
    from unislam_tpu.tools.eval_ate import pose_evaluation

    t0 = time.perf_counter()
    cfg, frames = setup(n_frames, seed)
    render_s = time.perf_counter() - t0
    slam = UniSLAM(cfg, frames, output=None, seed=seed)
    t0 = time.perf_counter()
    for i in range(n_frames):
        slam.step_frame(i)
    wall = time.perf_counter() - t0
    _, ate = pose_evaluation(slam.gt_c2w, slam.est_c2w)
    err = np.linalg.norm(np.asarray(slam.est_c2w)[:, :3, 3]
                         - np.asarray(slam.gt_c2w)[:, :3, 3], axis=1) * 100
    return {"seed": seed, "frames": n_frames,
            "ate_cm": float(ate["error.rmse"]),
            "max_err_cm": float(err.max()),
            "err_cm_every_10": [round(float(e), 3) for e in err[::10]],
            "err_cm": [round(float(e), 3) for e in err],
            "render_s": render_s, "wall_s": wall}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "tum_desk_jax_witness"))
    ap.add_argument("--child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]

    if args.child:                   # one seed, its record on stdout
        print("run " + json.dumps(one_seed(args.frames, seeds[0])),
              flush=True)
        return 0

    runs, pending, procs = [], list(seeds), []
    while pending or procs:
        while pending and len(procs) < max(1, args.jobs):
            s = pending.pop(0)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--child",
                 "--frames", str(args.frames), "--seeds", str(s)],
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

    summary = {"frames": args.frames, "seeds": [r["seed"] for r in runs],
               "ate_cm": [r["ate_cm"] for r in runs],
               "max_err_cm": [r["max_err_cm"] for r in runs],
               "bar_cm": BAR_CM,
               "tracked": all(r["ate_cm"] < BAR_CM for r in runs)}
    print("summary " + json.dumps(summary), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "tum_desk_jax_witness.json"), "w") as f:
        json.dump({"runs": runs, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
