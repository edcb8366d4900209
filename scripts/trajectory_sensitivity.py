#!/usr/bin/env python3
"""How far a tiny change moves a sequential drive's trajectory, on the card.

    python3 scripts/trajectory_sensitivity.py [--frames 40]
        [--configs hash,brick,brick_lowp] [--out DIR]

On the room0-scale scene and the first `--frames` frames of `chip_smoke.py`
(its `hash`, `brick` and `brick_lowp` set-ups), `UniSLAM.step_frame` runs
over the frames three times unchanged and once with each change:

- `pose_1um`: frame 1's tracked position moved by 1 um along x, after the
  frame (the next frames start from it);
- `table_ulp`: every element of the grid tables moved one f32 step up
  (`torch.nextafter`) after the scene's init.

A data-parallel run sums its gradients in another order than the
sequential run, a change of the same size as these. The unchanged runs
must agree bit for bit (else the comparison measures noise). For each
config and change it prints one JSON line: the largest per-frame position
difference to the unchanged run (cm), the first frame where it exceeds
1 cm, and both ATE-RMSEs (cm, no alignment). Everything also goes to
`--out`/trajectory_sensitivity.json, with the card line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHANGES = ("none", "pose_1um", "table_ulp")


def run(cfg, frames, device, change: str):
    """(est_c2w, ATE-RMSE cm, wall s) of one drive with `change`."""
    import torch
    from unislam_tpu_torch.engine.slam import UniSLAM
    from unislam_tpu_torch.parallel.sharding import TABLE_KEYS
    from unislam_tpu_torch.tools.eval_ate import pose_evaluation

    slam = UniSLAM(cfg, frames, seed=0, device=device)
    if change == "table_ulp":
        up = torch.tensor(float("inf"), device=device)
        for k in TABLE_KEYS:
            if k in slam.params:
                slam.params[k] = torch.nextafter(slam.params[k], up)
    if change == "pose_1um":
        def move(s, idx):
            if idx == 1:
                s.est_c2w[1][0, 3] += 1e-6
        slam.on_frame_done = move
    t0 = time.perf_counter()
    for idx in range(len(frames)):
        slam.step_frame(idx)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    _, ate = pose_evaluation(slam.gt_c2w, slam.est_c2w)
    slam.close()
    return slam.est_c2w.copy(), ate["error.rmse"], wall


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--configs", default="hash,brick,brick_lowp")
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out"))
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("trajectory_sensitivity: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke
    from unislam_tpu_torch.kernels import build

    device = torch.device("cuda")
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    build.build()
    setups = {"hash": ("room0.yaml", None),
              "brick": ("room0_tpu.yaml", None),
              "brick_lowp": ("room0_tpu.yaml", chip_smoke.LOWP)}
    frames = None
    results = []
    for name in args.configs.split(","):
        cfg, ds = chip_smoke.room0_setup(args.frames, *setups[name])
        if frames is None:
            frames = [ds[i] for i in range(args.frames)]
        base, base_ate, _ = run(cfg, frames, device, "none")
        for change in ("none", "none") + CHANGES[1:]:
            est, ate, wall = run(cfg, frames, device, change)
            cm = np.linalg.norm(est[:, :3, 3] - base[:, :3, 3], axis=1) * 100
            over = np.nonzero(cm > 1.0)[0]
            rec = {"config": name, "change": change, "frames": args.frames,
                   "bitwise": bool(np.array_equal(est, base)),
                   "max_frame_diff_cm": float(cm.max()),
                   "frame_of_max": int(cm.argmax()),
                   "first_frame_over_1cm": int(over[0]) if len(over)
                   else None,
                   "ate_cm": ate, "unchanged_ate_cm": base_ate,
                   "wall_s": wall}
            results.append(rec)
            print(json.dumps(rec), flush=True)
            torch.cuda.empty_cache()
    repeats = [r["bitwise"] for r in results if r["change"] == "none"]
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "trajectory_sensitivity.json"),
              "w") as f:
        json.dump({"card": card, "runs": results}, f, indent=1)
    print(card)
    return 0 if all(repeats) else 2


if __name__ == "__main__":
    sys.exit(main())
