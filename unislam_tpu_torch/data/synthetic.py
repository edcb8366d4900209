"""Procedural RGB-D sequences for tests, examples, and benchmarks (a copy
of `unislam_tpu/data/synthetic.py`, numpy only).

The reference has no synthetic data source (its tests are "run a real
dataset end-to-end", SURVEY.md §4); this module provides one so the pipeline
is testable hermetically: an axis-aligned box room with colored walls and a
matte sphere, rendered analytically (exact depth, no network involved), with
a smooth camera orbit inside.

Yields frames in the same (color, depth, gt_c2w) convention as the real
loaders, OpenGL camera (+x right, +y up, -z forward).
"""

from __future__ import annotations

import os

import numpy as np

from unislam_tpu_torch.core.rays import Intrinsics


def _look_at(eye, target, up=(0.0, 1.0, 0.0)):
    """OpenGL c2w: camera -z looks from eye toward target."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -fwd
    c2w[:3, 3] = eye
    return c2w.astype(np.float32)


_FACE_COLORS = np.array([
    [0.9, 0.3, 0.3],   # +x wall
    [0.3, 0.9, 0.3],   # -x wall
    [0.9, 0.9, 0.3],   # +y ceiling
    [0.4, 0.4, 0.9],   # -y floor
    [0.9, 0.5, 0.2],   # +z wall
    [0.5, 0.9, 0.9],   # -z wall
], dtype=np.float32)

_SPHERE_COLOR = np.array([0.85, 0.2, 0.6], dtype=np.float32)


class SyntheticRoom:
    """Box room [-half, half]^3 with a sphere; orbit trajectory inside."""

    def __init__(self, n_frames: int = 32, intr: Intrinsics | None = None,
                 half: float = 1.0, sphere_c=(0.3, -0.4, 0.0),
                 sphere_r: float = 0.25, orbit_r: float = 0.45,
                 seed: int = 0, depth_noise: float = 0.0,
                 pose_noise: float = 0.0, deg_per_frame: float = 3.0,
                 texture: str = "checker"):
        self.n_frames = n_frames
        self.intr = intr or Intrinsics(H=60, W=80, fx=70.0, fy=70.0,
                                       cx=39.5, cy=29.5)
        self.half = half
        self.sphere_c = np.asarray(sphere_c, np.float32)
        self.sphere_r = sphere_r
        self.orbit_r = orbit_r
        self.rng = np.random.default_rng(seed)
        self.depth_noise = depth_noise
        self.pose_noise = pose_noise
        # realistic inter-frame motion (~3 deg/frame ~ a 30fps handheld pan);
        # large values break any frame-to-frame tracker
        self.rad_per_frame = np.deg2rad(deg_per_frame)
        self.texture = texture
        self._dirs = self._camera_dirs()
        self._poses = [self._pose(i) for i in range(n_frames)]

    def __len__(self):
        return self.n_frames

    @property
    def bound(self):
        h = self.half
        return [[-h - 0.2, h + 0.2]] * 3

    def _camera_dirs(self):
        intr = self.intr
        j, i = np.meshgrid(np.arange(intr.H, dtype=np.float32),
                           np.arange(intr.W, dtype=np.float32), indexing="ij")
        return np.stack([(i - intr.cx) / intr.fx, -(j - intr.cy) / intr.fy,
                         -np.ones_like(i)], axis=-1)

    def _pose(self, i):
        th = i * self.rad_per_frame
        eye = np.array([self.orbit_r * np.cos(th), 0.1 * np.sin(2 * th),
                        self.orbit_r * np.sin(th)])
        target = np.array([1.5 * np.cos(th + 2.2), 0.0,
                           1.5 * np.sin(th + 2.2)])
        return _look_at(eye, target)

    def gt_pose(self, i):
        return self._poses[i]

    def _render(self, c2w):
        """Analytic depth (ray parameter t, matching the renderer's z) and
        per-pixel colors for walls/sphere."""
        dirs = self._dirs.reshape(-1, 3) @ c2w[:3, :3].T
        o = c2w[:3, 3][None, :]
        h = self.half

        # exit of box interior: for each axis, t to the wall in front
        # (guard exactly-axis-parallel rays: 0-component dirs would divide
        # to +-inf with sign set by -0.0 vs +0.0 and poison depth with NaN)
        dirs_safe = np.where(np.abs(dirs) < 1e-9, 1e-9, dirs)
        t_walls = np.where(dirs_safe > 0, (h - o) / dirs_safe,
                           (-h - o) / dirs_safe)
        t_box = t_walls.min(axis=-1)
        axis = t_walls.argmin(axis=-1)
        sign_pos = np.take_along_axis(dirs, axis[:, None], -1)[:, 0] > 0
        face = axis * 2 + (~sign_pos).astype(int)
        color = _FACE_COLORS[face]

        # sphere intersection
        oc = o - self.sphere_c[None, :]
        b = np.sum(oc * dirs, -1)
        c = np.sum(oc * oc, -1) - self.sphere_r ** 2
        disc = b * b - c * np.sum(dirs * dirs, -1)
        t_sph = np.where(disc > 0,
                         (-b - np.sqrt(np.maximum(disc, 0)))
                         / np.sum(dirs * dirs, -1), np.inf)
        t_sph = np.where(t_sph > 0, t_sph, np.inf)

        hit_sph = t_sph < t_box
        depth = np.where(hit_sph, t_sph, t_box).astype(np.float32)
        color = np.where(hit_sph[:, None], _SPHERE_COLOR[None, :], color)

        # surface texture in world coordinates: without it the flat walls
        # leave the photometric term with near-ambiguous minima and any
        # tracker drifts.
        hit_pts = o + depth[:, None] * dirs
        if self.texture == "noise":
            # Non-periodic multi-octave texture: a 25 cm checker is
            # self-similar under one-period translations parallel to a wall
            # (depth does not constrain that direction), and long runs lock
            # onto aliased minima exactly one or two periods off (measured:
            # 0.5 m plateau = 2 periods on the room0-scale orbit). Summed
            # incommensurate sinusoids have a unique photometric minimum at
            # every scale, like real indoor texture.
            t = np.zeros(len(hit_pts), dtype=np.float32)
            for amp, freq in ((1.0, 2.3), (0.6, 6.1), (0.35, 15.7)):
                fx_ = np.array([freq, freq * 1.371, freq * 0.773],
                               np.float32)
                t += amp * (np.sin(hit_pts @ fx_ + 0.7 * freq)
                            * np.cos(hit_pts @ fx_[::-1] - 1.3 * freq))
            tex = (0.775 + 0.225 * np.tanh(1.2 * t))[:, None]
        else:
            checker = (np.floor(hit_pts * 4.0).sum(axis=-1).astype(int) % 2)
            tex = np.where(checker > 0, 1.0, 0.55)[:, None]
        # simple lambert-ish shading by depth for visual variety
        shade = (1.0 / (1.0 + 0.15 * depth))[:, None]
        color = np.clip(color * tex * shade, 0.0, 1.0).astype(np.float32)

        H, W = self.intr.H, self.intr.W
        return color.reshape(H, W, 3), depth.reshape(H, W)

    def __getitem__(self, i):
        c2w = self._poses[i]
        color, depth = self._render(c2w)
        if self.depth_noise > 0:
            depth = depth + self.rng.normal(
                0, self.depth_noise, depth.shape).astype(np.float32)
        return color, depth, c2w.copy()


def make_config(ds: SyntheticRoom, overrides=None):
    """A minimal merged config dict for running UniSLAM on a SyntheticRoom."""
    intr = ds.intr
    cfg = {
        "scale": 1, "verbose": False, "grid_mode": "hash_grid",
        "m_mask_mode": "original", "t_mask_mode": "original",
        "dataset": "synthetic_room",
        "planes_res": {"bound_dividable": 0.24},
        "meshing": {"level_set": 0, "resolution": 0.02, "eval_rec": False,
                    "mesh_bound_scale": 1.02},
        "grid": {"enc": "HashGrid", "hash_size_sdf": 13, "hash_size_color": 13,
                 "voxel_sdf": 0.02, "voxel_color": 0.02,
                 "tcnn_network": False},
        "tracking": {
            "ignore_edge_W": 4, "ignore_edge_H": 4, "const_speed_assumption": True,
            "gt_camera": False, "lr_T": 0.002, "lr_R": 0.001, "pixels": 512,
            "iters": 8, "w_sdf_fs": 10, "w_sdf_center": 200, "w_sdf_tail": 50,
            "w_depth": 1, "w_color": 5, "activated_mapping_mode": True,
            "uncertainty_ts": 0.001, "vis_freq": 50, "vis_inside_freq": 400,
            "vis_pose_freq": 100, "pose_alignment": False,
            "no_vis_on_first_frame": True,
        },
        "mapping": {
            "every_frame": 4, "joint_opt": True, "joint_opt_cam_lr": 0.001,
            "mesh_freq": 100000, "ckpt_freq": 500, "keyframe_every": 4,
            "mapping_window_size": 20, "keyframe_selection_method": "global",
            "lr_first_factor": 5, "lr_factor": 1, "pixels": 1024,
            "iters_first": 20, "iters": 10, "w_sdf_fs": 5, "w_sdf_center": 200,
            "w_sdf_tail": 10, "w_depth": 0.1, "w_color": 5, "LC": True,
            "LC_ts": 0.95,
            "lr": {"decoders_lr": 0.001, "hash_grids_lr": 0.05,
                   "c_hash_grids_lr": 0.05},
            "bound": ds.bound, "marching_cubes_bound": ds.bound,
            "no_vis_on_first_frame": True, "no_mesh_on_first_frame": True,
            "no_log_on_first_frame": True,
        },
        "cam": {"H": intr.H, "W": intr.W, "fx": intr.fx, "fy": intr.fy,
                "cx": intr.cx, "cy": intr.cy, "png_depth_scale": 6553.5,
                "crop_edge": 0},
        "rendering": {"n_stratified": 24, "n_importance": 8, "perturb": True,
                      "learnable_beta": True},
        "model": {"c_dim": 32, "truncation": 0.06},
        "data": {"output": "output/synthetic"},
    }
    if overrides:
        from unislam_tpu_torch.config import update_recursive
        update_recursive(cfg, overrides)
    return cfg


def write_replica(frames, folder: str, depth_scale: float = 6553.5) -> int:
    """Write (color, depth, c2w) frames to `folder` in Replica's layout, as
    `data/datasets.Replica` reads it: `results/frame%06d.jpg`,
    `results/depth%06d.png` (16-bit, meters * depth_scale) and `traj.txt`
    (one row-major c2w a line, with the loader's y/z axis flip undone).

    The colour files hold lossless PNG bytes under Replica's `.jpg` names,
    so the frames read back are the rendered ones up to 8-bit rounding:
    `cv2.imread` picks the decoder from the content. Returns the number of
    frames written."""
    import cv2

    res = os.path.join(folder, "results")
    os.makedirs(res, exist_ok=True)
    lines = []
    for i, (color, depth, c2w) in enumerate(frames):
        rgb = (np.asarray(color) * 255).astype(np.uint8)
        cv2.imencode(".png", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))[1].tofile(
            os.path.join(res, f"frame{i:06d}.jpg"))
        cv2.imwrite(os.path.join(res, f"depth{i:06d}.png"),
                    (np.asarray(depth) * depth_scale).astype(np.uint16))
        traj = np.array(c2w, np.float64)
        traj[:3, 1] *= -1
        traj[:3, 2] *= -1
        lines.append(" ".join(f"{v:.9f}" for v in traj.reshape(-1)))
    with open(os.path.join(folder, "traj.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return len(lines)
