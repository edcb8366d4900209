"""Live state feed, the writer half of `unislam_tpu/utils/playback.py`.

The runtime atomically rewrites `<output>/live.json` after every
`live_freq`-th frame (current frame, trajectories so far, newest mesh
snapshot path); any process can poll it to follow a run. The viewer half
(renders of the evolving map) is not ported yet.
"""

from __future__ import annotations

import glob
import json
import os
import time

import numpy as np


def write_live_state(output: str, idx: int, n_img: int,
                     est_c2w: np.ndarray, gt_c2w: np.ndarray,
                     mesh_dir: str | None = None):
    """Atomically write `<output>/live.json` describing run progress.

    Kept small: trajectories are stored as (N, 3) translations plus the
    current frame's full pose (what a viewer's camera needs). Readers
    never see a torn file (write-to-tmp + rename).
    """
    mesh = newest_mesh(mesh_dir or os.path.join(output, "mesh"))
    state = {
        "frame": int(idx),
        "n_img": int(n_img),
        "timestamp": time.time(),
        "est_t": np.asarray(est_c2w[:idx + 1, :3, 3], np.float64
                            ).round(5).tolist(),
        "gt_t": np.asarray(gt_c2w[:idx + 1, :3, 3], np.float64
                           ).round(5).tolist(),
        "cur_c2w": np.asarray(est_c2w[idx], np.float64).tolist(),
        "mesh": mesh,
        "done": bool(idx == n_img - 1),
    }
    path = os.path.join(output, "live.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, path)
    return path


def read_live_state(output: str):
    """Read `<output>/live.json`; returns None if absent/unreadable."""
    path = os.path.join(output, "live.json")
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def newest_mesh(mesh_dir: str):
    """Most recent non-culled mesh snapshot path in `mesh_dir`, or None."""
    if not os.path.isdir(mesh_dir):
        return None
    meshes = sorted(glob.glob(os.path.join(mesh_dir, "*.ply")))
    meshes = [m for m in meshes if "culled" not in m]
    return meshes[-1] if meshes else None


def mesh_snapshot_for_frame(mesh_dir: str, frame: int):
    """The mesh snapshot taken at the latest mapping <= `frame` (snapshots
    are named `<idx:05d>_mesh.ply` by the runtime); falls back to the
    newest mesh when none precede `frame`."""
    best, best_idx = None, -1
    for m in sorted(glob.glob(os.path.join(mesh_dir, "*_mesh.ply"))):
        if "culled" in m:
            continue
        try:
            idx = int(os.path.basename(m).split("_")[0])
        except ValueError:
            continue
        if best_idx < idx <= frame:
            best, best_idx = m, idx
    return best or newest_mesh(mesh_dir)
