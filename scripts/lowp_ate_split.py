#!/usr/bin/env python3
"""ATE of the low-precision mapping options, split by option and seed,
on the card.

    python3 scripts/lowp_ate_split.py [--frames 100] [--seeds 4]
        [--variants f32,fused,bf16_adam,both] [--out DIR]
        [--device cuda|cpu]

On the room0-scale scene of `chip_smoke.py` with the brick + LOD config
configs/Replica/room0_tpu.yaml (only `mapping.bound` and
`marching_cubes_bound` set to the scene's bound), `UniSLAM.step_frame`
runs over the first `--frames` rendered frames for seeds 0 .. --seeds - 1
in four variants:

- `f32`: the config as it is (vanilla f32 decoders, f32 Adam);
- `fused`: `grid.tcnn_network: true` (bias-free bf16 decoders, K4);
- `bf16_adam`: `mapping.adam_state_dtype: bfloat16` (bf16 moments by
  stochastic rounding for the table, K7);
- `both`: the two together (the smoke's `brick_lowp` drive);
- `fused_plain` (only when asked for with --variants): `fused` with K4's
  plain PyTorch version in place of the kernel, to tell the kernel's
  share of an ATE from the bf16 decoder's own;
- `fused_f32` (only when asked for): the fused decoder's architecture
  (bias-free, one hidden layer) in f32, the plain version without its
  bf16 roundings, to tell the architecture's share from bf16's.

One seed's ATE spreads by more than an option moves it (PERF.md, the hash
loop's 0.96-3.46 cm over four seeds), so each variant is read as its mean
and spread over the seeds. Prints the card line, one JSON line per run
(ATE-RMSE in cm over all frames, no alignment; the largest per-frame
error; the mean tracked-frame and mapping-phase ms; wall s) and a
`summary` line (ATE per variant and seed, and the mean); all of it goes to
`--out`/lowp_ate_split.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VARIANTS = {
    "f32": {},
    "fused": {"grid": {"tcnn_network": True}},
    "bf16_adam": {"mapping": {"adam_state_dtype": "bfloat16"}},
    "both": {"grid": {"tcnn_network": True},
             "mapping": {"adam_state_dtype": "bfloat16"}},
    "fused_plain": {"grid": {"tcnn_network": True}},
    "fused_f32": {"grid": {"tcnn_network": True}},
}
DEFAULT = "f32,fused,bf16_adam,both"


def route_k4(variant: str) -> None:
    """Route the fused decoder through kernel K4, or for the diagnostic
    variants through its plain version (with or without bf16)."""
    from unislam_tpu_torch.kernels import fused_mlp as fm

    if not hasattr(fm, "_kernel"):
        fm._kernel = (fm.mlp_fwd, fm.mlp_bwd, fm._bf16)
    plain = variant in ("fused_plain", "fused_f32")
    fm.mlp_fwd, fm.mlp_bwd = ((fm.mlp_fwd_plain, fm.mlp_bwd_plain) if plain
                              else fm._kernel[:2])
    fm._bf16 = (lambda x: x) if variant == "fused_f32" else fm._kernel[2]


def run(cfg, frames, seed, device) -> dict:
    """One drive; its ATE, errors and times."""
    import numpy as np
    import torch
    from unislam_tpu_torch.engine.slam import UniSLAM
    from unislam_tpu_torch.tools.eval_ate import pose_evaluation

    slam = UniSLAM(cfg, frames, seed=seed, device=device)
    t0 = time.perf_counter()
    for i in range(len(frames)):
        slam.step_frame(i)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    _, ate = pose_evaluation(slam.gt_c2w, slam.est_c2w)
    err = np.linalg.norm(slam.est_c2w[:, :3, 3] - slam.gt_c2w[:, :3, 3],
                         axis=1) * 100
    phases = [f["phases"] for f in slam.stats.frames]
    track = [p["tracking"] for p in phases if "tracking" in p]
    mapping = [p["mapping"] for p in phases if "mapping" in p]
    slam.close()
    return {"ate_cm": ate["error.rmse"], "err_max_cm": float(err.max()),
            "tracked_frame_ms": 1e3 * sum(track) / len(track),
            "mapping_phase_ms": 1e3 * sum(mapping) / len(mapping),
            "wall_s": wall, "err_cm": err.tolist()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--variants", default=DEFAULT)
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("lowp_ate_split: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line() if device.type == "cuda" else "cpu"
    print(f"card: {card}", flush=True)
    variants = args.variants.split(",")
    t0 = time.perf_counter()
    setups = {v: cs.room0_setup(args.frames, "room0_tpu.yaml", VARIANTS[v])
              for v in variants}
    ds = setups[variants[0]][1]
    frames = [ds[i] for i in range(args.frames)]
    print(f"render: {args.frames} frames in {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    runs, summary = [], {}
    for v in variants:
        route_k4(v)
        for seed in range(args.seeds):
            rec = {"variant": v, "seed": seed,
                   **run(setups[v][0], frames, seed, device)}
            runs.append(rec)
            print("run " + json.dumps({k: x for k, x in rec.items()
                                       if k != "err_cm"}), flush=True)
            summary.setdefault(v, []).append(rec["ate_cm"])
    summary = {v: {"ate_cm": a, "mean": sum(a) / len(a)}
               for v, a in summary.items()}
    print("summary " + json.dumps(summary), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "lowp_ate_split.json"), "w") as f:
        json.dump({"card": card, "frames": args.frames, "runs": runs,
                   "summary": summary}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
