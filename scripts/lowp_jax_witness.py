#!/usr/bin/env python3
"""Per-frame tracking error of the JAX package (`unislam_tpu`) with and
without the fused bias-free decoder, on the scene of `chip_smoke.py`.

    JAX_PLATFORMS=cpu python3 scripts/lowp_jax_witness.py [--frames 12]
        [--seeds 0,1,2,3] [--variants f32,fused] [--out DIR]

The reference witness for `scripts/lowp_ate_split.py`: the same
room0-scale procedural scene (1200x680, `chip_smoke.room0_setup`'s
arguments), configs/Replica/room0_tpu.yaml with only `mapping.bound` and
`marching_cubes_bound` set to the scene's bound, driven frame by frame
through the JAX package's own `UniSLAM.step_frame` on the CPU:

- `f32`: the config as it is (vanilla f32 decoders);
- `fused`: `grid.tcnn_network: true` (the bias-free bf16 decoders of
  `unislam_tpu/models/decoders.py`);
- `both`: `fused` plus `mapping.adam_state_dtype: bfloat16`.

It imports nothing of the PyTorch port. The two packages draw their rays
from different generators, so a seed here and the same seed in the port
are different runs: compare how each variant behaves over several seeds,
not one seed's trajectory. Prints one JSON line per run (ATE-RMSE in cm
over the frames, no alignment, as `lowp_ate_split.py`; each frame's
translation error in cm; wall s) and a `summary` line (ATE per variant
and seed, and the median), and writes them all to
`--out`/lowp_jax_witness.json. About 8 s a frame on 4 CPU cores (100
frames, one seed: 12-15 minutes), 2 GiB of host memory.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VARIANTS = {
    "f32": {},
    "fused": {"grid": {"tcnn_network": True}},
    "both": {"grid": {"tcnn_network": True},
             "mapping": {"adam_state_dtype": "bfloat16"}},
}


def setup(n_frames: int, overrides: dict):
    """The JAX package's room0_tpu config and the smoke's scene."""
    from unislam_tpu.config import load_config, update_recursive
    from unislam_tpu.data.synthetic import SyntheticRoom
    from unislam_tpu.engine.slam import intrinsics_from_cfg

    cfg = load_config(os.path.join(HERE, "configs/Replica/room0_tpu.yaml"),
                      os.path.join(HERE, "configs/UNISLAM.yaml"))
    ds = SyntheticRoom(n_frames=n_frames, intr=intrinsics_from_cfg(cfg),
                       half=3.5, orbit_r=1.2, sphere_c=(1.0, -1.0, 0.0),
                       sphere_r=0.8, texture="noise", deg_per_frame=0.75)
    update_recursive(cfg, {"mapping": {"bound": ds.bound,
                                       "marching_cubes_bound": ds.bound},
                           "data": {"prefetch": False}})
    update_recursive(cfg, overrides)
    return cfg, ds


def run(cfg, frames, seed: int) -> dict:
    import numpy as np
    from unislam_tpu.engine.slam import UniSLAM
    from unislam_tpu.tools.eval_ate import pose_evaluation

    slam = UniSLAM(cfg, frames, output=None, seed=seed)
    t0 = time.perf_counter()
    for i in range(len(frames)):
        slam.step_frame(i)
    wall = time.perf_counter() - t0
    _, ate = pose_evaluation(slam.gt_c2w, slam.est_c2w)
    err = np.linalg.norm(np.asarray(slam.est_c2w)[:, :3, 3]
                         - np.asarray(slam.gt_c2w)[:, :3, 3], axis=1) * 100
    return {"ate_cm": float(ate["error.rmse"]),
            "err_cm": [round(float(e), 3) for e in err], "wall_s": wall}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--variants", default="f32,fused")
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "lowp_jax_witness"))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, HERE)

    t0 = time.perf_counter()
    # rendered once, shared by every run
    _, ds = setup(args.frames, {})
    frames = [ds[i] for i in range(args.frames)]
    print(f"render: {args.frames} frames in {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    runs = []
    for v in args.variants.split(","):
        cfg, _ = setup(args.frames, VARIANTS[v])
        for seed in (int(s) for s in args.seeds.split(",")):
            rec = {"variant": v, "seed": seed, **run(cfg, frames, seed)}
            runs.append(rec)
            print("run " + json.dumps(rec), flush=True)
    summary = {}
    for rec in runs:
        summary.setdefault(rec["variant"], []).append(rec["ate_cm"])
    summary = {v: {"ate_cm": a, "median": statistics.median(a)}
               for v, a in summary.items()}
    print("summary " + json.dumps(summary), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "lowp_jax_witness.json"), "w") as f:
        json.dump({"device": str(jax.devices()[0]), "frames": args.frames,
                   "runs": runs, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
