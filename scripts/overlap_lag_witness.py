#!/usr/bin/env python3
"""How a tracker that lags the map by one mapping phase changes the
schedule, on the card, in one process.

    python3 scripts/overlap_lag_witness.py [--frames 40] [--seeds 0,1,2,3]
        [--out DIR]

On the room0-scale scene and the first `--frames` frames of
`chip_smoke.py` (its `hash` set-up, room0.yaml; the frames as float32, as
the ranks of its multi-device drives read them), each seed runs twice:

- `sequential`: `UniSLAM.step_frame`, every frame tracked against the
  scene of the last mapping phase;
- `lagged`: `LaggedSLAM`, the in-process overlapped driver held to the
  schedule that the tracking rank of `DistributedOverlappedSLAM` keeps
  when every mapping phase outlasts the frames up to the next mapping
  frame (as in the smoke's `overlap_dp_hash`): frames are tracked
  against the first phase's scene until the second phase, and after
  that against the scene of the phase before the last; the BA pose and
  the loss of a phase land at the next mapping frame.

Mapping runs on one device here, so `lagged` is not `overlap_dp_hash` bit
for bit (two mapping ranks sum their gradients in another order); it
shows what the lag alone does to the uncertainty trigger and so to the
number of mapping phases. For each run it prints one JSON line: the
mapping phases and the mapped frames, the keyframes, the tracking and
mapping iterations, each tracked frame's snapshot phase, the ATE-RMSE
(cm, no alignment) and the wall seconds. Everything also goes to
`--out`/overlap_lag_witness.json, with the card line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from unislam_tpu_torch.engine.overlap import OverlappedSLAM  # noqa: E402


class LaggedSLAM(OverlappedSLAM):
    """`OverlappedSLAM` with tracking and mapping on `device`, whose
    tracker adopts a phase's snapshot only at the next mapping frame
    (the first phase's at once), never earlier. `snapshot_phase[idx]` is
    the phase a tracked frame used (1 = the first)."""

    def __init__(self, cfg, dataset, seed: int = 0, device=None):
        super().__init__(cfg, dataset, seed=seed, track_device=device,
                         map_devices=[device])
        self.snapshot_phase = [-1] * self.n_img
        self._snapshot = 0

    def _tracking_params(self):
        return self._track_params

    def track_frame(self, idx, depth_img, color_img):
        self.snapshot_phase[idx] = self._snapshot
        return super().track_frame(idx, depth_img, color_img)

    def map_frame(self, idx, depth_img, color_img):
        if self._next_snapshot is not None:
            # sync() adopts the last phase's snapshot as this phase starts
            self._snapshot = self.mapping_cnt
        out = super().map_frame(idx, depth_img, color_img)
        if self.mapping_cnt == 1:
            # the tracker waits for the first phase's scene
            self._track_params = self._next_snapshot[0]
            self._next_snapshot = None
            self._snapshot = 1
        return out


def run(cfg, frames, device, seed: int, lagged: bool) -> dict:
    import torch
    from unislam_tpu_torch.engine.slam import UniSLAM
    from unislam_tpu_torch.tools.eval_ate import pose_evaluation

    slam = (LaggedSLAM(cfg, frames, seed=seed, device=device) if lagged
            else UniSLAM(cfg, frames, seed=seed, device=device))
    t0 = time.perf_counter()
    mapped = [idx for idx in range(len(frames)) if slam.step_frame(idx)]
    if lagged:
        slam.sync()
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    _, ate = pose_evaluation(slam.gt_c2w, slam.est_c2w)
    slam.close()
    return {"run": "lagged" if lagged else "sequential", "seed": seed,
            "frames": len(frames), "mapping_cnt": slam.mapping_cnt,
            "mapped_frames": mapped, "kf_count": slam.kf_count,
            "iters_run": dict(slam.iters_run),
            "snapshot_phase": getattr(slam, "snapshot_phase", None),
            "ate_cm": ate["error.rmse"], "wall_s": wall}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out"))
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("overlap_lag_witness: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from unislam_tpu_torch.kernels import build

    device = torch.device("cuda")
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    build.build()
    cfg, ds = chip_smoke.room0_setup(200, "room0.yaml")
    frames = [tuple(np.asarray(x, np.float32) for x in ds[i])
              for i in range(args.frames)]
    results = []
    for seed in (int(s) for s in args.seeds.split(",")):
        for lagged in (False, True):
            results.append(run(cfg, frames, device, seed, lagged))
            print(json.dumps(results[-1]), flush=True)
            torch.cuda.empty_cache()
    summary = {r: {"mapping_cnt": [x["mapping_cnt"] for x in results
                                   if x["run"] == r],
                   "track_iters": [x["iters_run"]["track"] for x in results
                                   if x["run"] == r]}
               for r in ("sequential", "lagged")}
    print("summary " + json.dumps(summary), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "overlap_lag_witness.json"), "w") as f:
        json.dump({"card": card, "runs": results, "summary": summary}, f,
                  indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
