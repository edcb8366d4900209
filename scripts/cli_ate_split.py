#!/usr/bin/env python3
"""Split the ATE of the port's CLI from that of the in-process SLAM drive
on the card: which of the data path, the runtime around the loop and the
checkpoint resume moves the trajectory.

    python3 scripts/cli_ate_split.py [--frames 100] [--resume_at 60]
        [--seeds 4] [--runs NAMES] [--out DIR] [--device cuda|cpu]

On the room0-scale scene of `chip_smoke.py` with hash
configs/Replica/room0.yaml (only `mapping.bound` and
`marching_cubes_bound` set to the scene's bound), each run goes to
`--frames` frames and reports its ATE-RMSE (cm, over all frames, no
alignment, as output.txt) and its per-frame position errors:

- `drive_float`: `UniSLAM.step_frame` on the rendered float frames (seed
  0 is the smoke's hash drive), for seeds 0 .. --seeds - 1;
- `drive_replica`: the same on the frames written in Replica's layout
  (`synthetic.write_replica`) and read back through `datasets.Replica`
  (8-bit colour, 16-bit depth); for each seed;
- `drive_colour8` / `drive_depth16`: the read-back colour with the float
  depth / the float colour with the read-back depth; for each seed;
- `resume_fresh`: on the read-back frames, a run over the first
  `--resume_at` frames (which maps its last frame), a checkpoint
  (`logger.save_checkpoint`), and a second `UniSLAM` over all frames
  resumed from it (`logger.load_into`) with a fresh seed stream, as the
  CLI's `--resume` does; for each seed;
- `resume_carried`: as `resume_fresh`, with the seed stream carried over
  from the first run, as if it had not stopped; for each seed;
- `cli_full`: `python -m unislam_tpu_torch.run` over all frames;
- `cli_resume`: the CLI over the first `--resume_at` frames, then
  `--resume` over all (the smoke's `cli` drive).

`--runs` picks some of these (comma-separated names). Before the runs a
`readback` line gives how far the read-back frames are from the rendered
ones (colour, depth, pose). The CLI runs mesh at 4 cm, not the config's 1 cm: the mesh is made after
the trajectory and does not change it. Prints the card line, one JSON line
per run, and a `summary` line (ATE per variant); the per-frame errors go
to `--out`/cli_ate_split.json.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def errors_cm(gt_c2w, est_c2w):
    import numpy as np
    return (np.linalg.norm(np.asarray(est_c2w)[:, :3, 3]
                           - np.asarray(gt_c2w)[:, :3, 3], axis=1)
            * 100).tolist()


def record(name, seed, gt_c2w, est_c2w, wall_s, resume_at):
    import numpy as np

    from unislam_tpu_torch.tools.eval_ate import pose_evaluation
    _, ate = pose_evaluation(gt_c2w, est_c2w)
    err = errors_cm(gt_c2w, est_c2w)
    rec = {"run": name, "seed": seed, "ate_cm": ate["error.rmse"],
           "rmse_before_cm": float(np.sqrt(np.mean(
               np.square(err[:resume_at])))),
           "rmse_after_cm": float(np.sqrt(np.mean(
               np.square(err[resume_at:])))),
           "err_last_cm": err[-1], "err_max_cm": max(err),
           "wall_s": wall_s}
    print("run " + json.dumps(rec), flush=True)
    return rec | {"err_cm": err}


def slam_run(cfg, frames, seed, device, start=0, ckpt=None, seeds_n=None):
    """UniSLAM over `frames` from frame `start`; with `ckpt` it first
    resumes from that checkpoint (and with `seeds_n` sets the seed stream
    to that position)."""
    from unislam_tpu_torch.engine.slam import UniSLAM
    from unislam_tpu_torch.utils.logger import load_into

    slam = UniSLAM(cfg, frames, seed=seed, device=device)
    if ckpt is not None:
        start = load_into(slam, ckpt)
        if seeds_n is not None:
            slam.seeds._n = seeds_n
    for idx in range(start, len(frames)):
        slam.step_frame(idx)
    slam.close()
    return slam


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--resume_at", type=int, default=60)
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", default="drive_float,drive_replica,"
                    "drive_colour8,drive_depth16,resume_fresh,"
                    "resume_carried,cli_full,cli_resume")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    import yaml

    import chip_smoke as cs
    from unislam_tpu_torch.config import update_recursive
    from unislam_tpu_torch.data.datasets import Replica
    from unislam_tpu_torch.data.synthetic import write_replica
    from unislam_tpu_torch.utils.logger import (load_checkpoint,
                                                latest_checkpoint,
                                                save_checkpoint)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("cli_ate_split: no CUDA device", file=sys.stderr)
        return 1
    on_cpu = [] if device.type == "cuda" else ["--device", "cpu"]
    card = cs.card_line() if device.type == "cuda" else "cpu"
    print(card, flush=True)
    n, k = args.frames, args.resume_at
    cfg, ds = cs.room0_setup(n, "room0.yaml")
    update_recursive(cfg, {"profiling": {"enabled": False}})
    frames = [ds[i] for i in range(n)]
    work = os.path.join(HERE, "build", "cli_ate_split")
    shutil.rmtree(work, ignore_errors=True)
    room, output = os.path.join(work, "room"), os.path.join(work, "output")
    write_replica(frames, room)
    rep = Replica({**cfg, "data": {"input_folder": room}}, room)
    readback = [rep[i] for i in range(n)]
    err = {"colour": [], "depth": [], "pose": []}
    for (c, d, p), (c0, d0, p0) in zip(readback, frames):
        err["colour"].append(np.asarray(c) - np.asarray(c0))
        err["depth"].append(np.asarray(d) - np.asarray(d0))
        err["pose"].append(np.abs(np.asarray(p) - np.asarray(p0)).max())
    print("readback " + json.dumps({
        "colour_err_min": float(np.min(err["colour"])),
        "colour_err_max": float(np.max(err["colour"])),
        "colour_err_mean": float(np.mean(err["colour"])),
        "depth_err_min_m": float(np.min(err["depth"])),
        "depth_err_max_m": float(np.max(err["depth"])),
        "depth_err_mean_m": float(np.mean(err["depth"])),
        "pose_err_max": float(np.max(err["pose"]))}), flush=True)
    del err
    variants = {
        "drive_float": frames, "drive_replica": readback,
        "drive_colour8": [(c, f[1], f[2]) for (c, _, _), f
                          in zip(readback, frames)],
        "drive_depth16": [(f[0], d, f[2]) for (_, d, _), f
                          in zip(readback, frames)]}
    runs = args.runs.split(",")
    recs = []

    def timed_run(name, seed, **kw):
        t0 = time.perf_counter()
        slam = slam_run(cfg, kw.pop("frames"), seed, device, **kw)
        if device.type == "cuda":
            torch.cuda.synchronize()
        recs.append(record(name, seed, slam.gt_c2w, slam.est_c2w,
                           time.perf_counter() - t0, k))
        return slam

    for seed in range(args.seeds):
        for name, fl in variants.items():
            if name in runs:
                timed_run(name, seed, frames=fl)
        if "resume_fresh" in runs or "resume_carried" in runs:
            first = slam_run(cfg, readback[:k], seed, device)
            ckpt = os.path.join(work, f"ckpt_{seed}.npz")
            save_checkpoint(ckpt, first, k - 1)
            if "resume_fresh" in runs:
                timed_run("resume_fresh", seed, frames=readback, ckpt=ckpt)
            if "resume_carried" in runs:
                timed_run("resume_carried", seed, frames=readback,
                          ckpt=ckpt, seeds_n=first.seeds._n)
            del first
        if device.type == "cuda":
            torch.cuda.empty_cache()

    bound = np.asarray(ds.bound, np.float64).tolist()
    cfg_path = os.path.join(work, "room0_split.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({
            "inherit_from": os.path.join(HERE, "configs/Replica/room0.yaml"),
            "mapping": {"bound": bound, "marching_cubes_bound": bound},
            "meshing": {"resolution": 0.04},
            "data": {"input_folder": room, "output": output}}, f)
    for name, calls in (("cli_full", [["--n_frames", str(n)]]),
                        ("cli_resume", [["--n_frames", str(k)],
                                        ["--resume", "--n_frames", str(n)]])):
        if name not in runs:
            continue
        shutil.rmtree(output, ignore_errors=True)
        t0 = time.perf_counter()
        for extra in calls:
            proc = subprocess.run(
                [sys.executable, "-m", "unislam_tpu_torch.run", cfg_path,
                 *extra, *on_cpu], cwd=HERE, capture_output=True, text=True,
                timeout=900)
            if proc.returncode != 0:
                print(proc.stdout[-2000:] + proc.stderr[-3000:],
                      file=sys.stderr)
                raise AssertionError(f"{name} {extra} exited "
                                     f"{proc.returncode}")
        ck = load_checkpoint(latest_checkpoint(os.path.join(output, "ckpts")))
        recs.append(record(name, 0, ck["gt_c2w"], ck["est_c2w"],
                           time.perf_counter() - t0, k))
    shutil.rmtree(work)

    summary = {}
    for r in recs:
        summary.setdefault(r["run"], []).append(r["ate_cm"])
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "cli_ate_split.json"), "w") as f:
        json.dump({"card": card, "runs": recs}, f)
    print("summary " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
