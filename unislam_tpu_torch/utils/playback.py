"""Headless map-evolution observability: live state feed + playback
renders, the port's counterpart of `unislam_tpu/utils/playback.py`.

Writer half: the runtime atomically rewrites `<output>/live.json` after
every `live_freq`-th frame (current frame, trajectories so far, newest mesh
snapshot path); any process can poll it to follow a run. Viewer half:
third-person views of the map (the native z-buffer rasterizer's depth
shading, the est/gt trajectory polylines and the current camera's
frustum), drawn with cv2, and `follow_live`, which renders one such view
per update of `live.json`. `view_layers` computes what the view shows,
exactly as the JAX package's `render_view` does; `render_view` draws it.
Neither needs matplotlib or a display.
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


# ---------------------------------------------------------------------------
# third-person render (native rasterizer + cv2 overlay)
# ---------------------------------------------------------------------------

# matplotlib's `bone` colormap: `_bone_data` of matplotlib/_cm.py, the
# (x, value, value) anchors of each channel, interpolated linearly
_BONE_DATA = {
    "red": ((0.0, 0.0, 0.0), (0.746032, 0.652778, 0.652778),
            (1.0, 1.0, 1.0)),
    "green": ((0.0, 0.0, 0.0), (0.365079, 0.319444, 0.319444),
              (0.746032, 0.777778, 0.777778), (1.0, 1.0, 1.0)),
    "blue": ((0.0, 0.0, 0.0), (0.365079, 0.444444, 0.444444),
             (1.0, 1.0, 1.0)),
}
# overlay colours (BGR): gt lime, est cyan, the frustum red
_GT_BGR, _EST_BGR, _FRUSTUM_BGR = (0, 255, 0), (255, 255, 0), (0, 0, 255)


def bone_lut(n: int = 256) -> np.ndarray:
    """The `bone` colormap as an (n, 3) RGB table in [0, 1], entry i at
    x = i / (n - 1), as matplotlib's LinearSegmentedColormap builds it."""
    x = np.linspace(0.0, 1.0, n)
    return np.stack([np.interp(x, [a[0] for a in _BONE_DATA[c]],
                               [a[1] for a in _BONE_DATA[c]])
                     for c in ("red", "green", "blue")], axis=-1)


def camera_frustum_lines(c2w, scale=0.1):
    """Wireframe frustum points in world space (visualizer_util's camera
    actor, reduced to line segments)."""
    pts_cam = np.array([
        [0, 0, 0], [1, 0.6, -1.5], [1, -0.6, -1.5], [-1, -0.6, -1.5],
        [-1, 0.6, -1.5]]) * scale
    pts = pts_cam @ c2w[:3, :3].T + c2w[:3, 3]
    segs = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    return pts, segs


def third_person_pose(center, extent, theta):
    """Turntable camera c2w looking at `center` from angle `theta`."""
    eye = center + np.array([np.cos(theta), 0.6, np.sin(theta)]) * extent * 1.1
    fwd = center - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0, 1, 0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye
    return c2w


def view_layers(verts, faces, est_traj, gt_traj, cur_c2w, theta=0.6,
                H=480, W=640):
    """What one third-person view shows: the mesh's shaded depth from the
    turntable pose (fx = fy = 500, 1 / (1 + 0.3 d) where the rasterizer
    hit, else 0), (H, W) float32; the trajectory polylines in pixel
    coordinates, [(label, (n, 2))] with gt before est, each only when two
    or more of its points lie in front of the camera; and the current
    camera's frustum, its 8 segments as (2, 2) pixel arrays, or [] unless
    all 5 of its points lie in front of the camera."""
    from unislam_tpu_torch.utils.native import rasterize_depth

    center = verts.mean(axis=0)
    extent = max((verts.max(0) - verts.min(0)).max(), 1e-3)
    c2w = third_person_pose(center, extent, theta)
    w2c = np.linalg.inv(c2w)
    fx = fy = 500.0
    cx, cy = W / 2 - 0.5, H / 2 - 0.5

    depth = rasterize_depth(verts.astype(np.float32),
                            faces.astype(np.int32),
                            w2c.astype(np.float32), fx, fy, cx, cy, W, H)
    img = np.where(depth > 0, 1.0 / (1.0 + 0.3 * depth), 0.0)

    def project(p):
        cam = (p - c2w[:3, 3]) @ c2w[:3, :3]
        cam[:, 0] *= -1
        z = cam[:, 2] - 1e-6
        return (np.stack([fx * cam[:, 0] / z + cx,
                          fy * cam[:, 1] / z + cy], -1), z < 0)

    lines = []
    for traj, label in [(np.asarray(gt_traj), "gt"),
                        (np.asarray(est_traj), "est")]:
        if len(traj) > 1:
            uv, vis = project(traj.copy())
            uv = uv[vis]
            if len(uv) > 1:
                lines.append((label, uv))
    pts, segs = camera_frustum_lines(np.asarray(cur_c2w),
                                     scale=extent * 0.03)
    uv, vis = project(pts.copy())
    frustum = [uv[[a, b]] for a, b in segs] if vis.all() else []
    return img, lines, frustum


def _px(uv) -> np.ndarray:
    """Pixel coordinates for cv2: rounded, int32, bounded far outside any
    image (a point just in front of the camera projects to ~1e9)."""
    return np.round(np.clip(uv, -1e6, 1e6)).astype(np.int32)


def render_view(out_png: str, verts, faces, est_traj, gt_traj, cur_c2w,
                frame: int, n_img: int, theta: float = 0.6,
                H: int = 480, W: int = 640):
    """Render one third-person view: mesh depth shading + est/gt trajectory
    polylines + current-camera frustum (`view_layers`), drawn with cv2 into
    an H x W PNG: the shading through the `bone` colormap normalised by the
    image's own min and max (as matplotlib's imshow), gt lime, est cyan,
    the frustum red, a `frame i/n  (V verts)` title and a gt/est legend.
    Pure CPU; returns `out_png`."""
    import cv2

    img, lines, frustum = view_layers(verts, faces, est_traj, gt_traj,
                                      cur_c2w, theta, H, W)
    lo, hi = float(img.min()), float(img.max())
    x = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
    idx = np.clip((x * 256).astype(np.int64), 0, 255)
    rgb = np.round(bone_lut()[idx] * 255).astype(np.uint8)
    canvas = np.ascontiguousarray(rgb[..., ::-1])          # BGR
    colour = {"gt": _GT_BGR, "est": _EST_BGR}
    for label, uv in lines:
        cv2.polylines(canvas, [_px(uv)], False, colour[label], 2)
    for seg in frustum:
        p, q = _px(seg)
        cv2.line(canvas, tuple(map(int, p)), tuple(map(int, q)),
                 _FRUSTUM_BGR, 1)
    def text(s, org, scale):        # white on a dark outline
        for bgr, width in (((0, 0, 0), 3), ((255, 255, 255), 1)):
            cv2.putText(canvas, s, org, cv2.FONT_HERSHEY_SIMPLEX, scale,
                        bgr, width, cv2.LINE_AA)

    text(f"frame {frame}/{n_img}  ({len(verts)} verts)", (8, 20), 0.55)
    for k, label in enumerate(("gt", "est")):
        y = 20 + 18 * k
        cv2.line(canvas, (W - 70, y - 5), (W - 46, y - 5), colour[label], 2)
        text(label, (W - 40, y), 0.5)
    if not cv2.imwrite(out_png, canvas):
        raise OSError(f"cv2 could not write {out_png}")
    return out_png


# ---------------------------------------------------------------------------
# live follower (reader side: python -m unislam_tpu_torch.visualizer --live)
# ---------------------------------------------------------------------------

def follow_live(output: str, poll_s: float = 2.0, max_wait_s: float = 600.0,
                once: bool = False):
    """Poll `<output>/live.json` and render a view per update into
    `<output>/live_view/`; returns the list of rendered PNGs. Exits when the
    run reports done (or after `max_wait_s` without updates).
    """
    from unislam_tpu_torch.utils.mesh_io import read_ply

    vis_dir = os.path.join(output, "live_view")
    os.makedirs(vis_dir, exist_ok=True)
    rendered = []
    last_frame, last_mesh = -1, None
    verts = faces = None
    waited = 0.0
    while True:
        state = read_live_state(output)
        if state is None or state["frame"] == last_frame:
            if once or state is not None and state.get("done"):
                break
            time.sleep(poll_s)
            waited += poll_s
            if waited > max_wait_s:
                break
            continue
        waited = 0.0
        last_frame = state["frame"]
        if state["mesh"] and state["mesh"] != last_mesh:
            try:
                verts, faces, _ = read_ply(state["mesh"])
                last_mesh = state["mesh"]
            except OSError:
                pass  # snapshot mid-write; reuse previous mesh
        if verts is not None and len(verts):
            png = os.path.join(vis_dir, f"{last_frame:05d}.png")
            render_view(png, verts, faces, state["est_t"], state["gt_t"],
                        state["cur_c2w"], last_frame, state["n_img"])
            rendered.append(png)
            print(f"[live] frame {last_frame}/{state['n_img']} "
                  f"mesh={os.path.basename(last_mesh or '-')} -> {png}",
                  flush=True)
        if state.get("done") or once:
            break
        time.sleep(poll_s)
    return rendered
