"""The benchmark's RGB-D stream: a procedural room rendered on the device.

The room is the one the port's smoke drives use (a box room with coloured,
non-periodically textured walls and a matte sphere, an orbiting camera in
OpenGL convention: +x right, +y up, -z forward). Depth is the ray
parameter t at the first hit, exact up to f32 rounding. The renderer is a
PyTorch transcription of the port's numpy `SyntheticRoom._render`, so a
pool of frames is made on the card in a fraction of a second; the frames
are then handed to the program as host arrays, as a loader's are.

`depth_holes` zeroes square blocks of a depth image, the dropouts of a
structured-light sensor (ScanNet, TUM RGB-D): a copy of the smoke's
`chip_smoke.depth_holes`, with its random draw passed in.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_FACE_COLORS = ((0.9, 0.3, 0.3), (0.3, 0.9, 0.3), (0.9, 0.9, 0.3),
                (0.4, 0.4, 0.9), (0.9, 0.5, 0.2), (0.5, 0.9, 0.9))
_SPHERE_COLOR = (0.85, 0.2, 0.6)
# the non-periodic texture: (amplitude, frequency) octaves
_OCTAVES = ((1.0, 2.3), (0.6, 6.1), (0.35, 15.7))


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """OpenGL c2w (4, 4) float32: camera -z looks from eye toward target."""
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


def orbit_pose(i: int, orbit_r: float, deg_per_frame: float) -> np.ndarray:
    """Frame i's camera on the orbit: a circle of radius `orbit_r` with a
    small vertical wave, looking ahead and inward."""
    th = i * np.deg2rad(deg_per_frame)
    eye = np.array([orbit_r * np.cos(th), 0.1 * np.sin(2 * th),
                    orbit_r * np.sin(th)])
    target = np.array([1.5 * np.cos(th + 2.2), 0.0, 1.5 * np.sin(th + 2.2)])
    return look_at(eye, target)


def pool_size(deg_per_frame: float) -> int:
    """Frames in one closed orbit."""
    n = 360.0 / deg_per_frame
    if abs(n - round(n)) > 1e-9:
        raise ValueError(f"{deg_per_frame} degrees a frame does not close "
                         "the orbit in a whole number of frames")
    return int(round(n))


def camera_dirs(intr, device) -> torch.Tensor:
    """(H*W, 3) camera-frame directions [(i-cx)/fx, -(j-cy)/fy, -1]."""
    j, i = torch.meshgrid(torch.arange(intr["H"], dtype=torch.float32,
                                       device=device),
                          torch.arange(intr["W"], dtype=torch.float32,
                                       device=device), indexing="ij")
    d = torch.stack([(i - intr["cx"]) / intr["fx"],
                     -(j - intr["cy"]) / intr["fy"], -torch.ones_like(i)],
                    dim=-1)
    return d.reshape(-1, 3)


def render(scene: dict, dirs: torch.Tensor, c2w: torch.Tensor):
    """One frame: (color (N, 3), depth (N,)) for camera directions `dirs`
    (N, 3) under c2w (4, 4), both f32 on one device."""
    dev = dirs.device
    # elementwise sums, not a matmul: no TF32 path can touch them
    rays = torch.sum(dirs[:, None, :] * c2w[:3, :3][None], dim=-1)
    o = c2w[:3, 3][None, :]
    h = float(scene["half"])
    safe = torch.where(rays.abs() < 1e-9, torch.full_like(rays, 1e-9), rays)
    t_walls = torch.where(safe > 0, (h - o) / safe, (-h - o) / safe)
    t_box, axis = t_walls.min(dim=-1)
    sign_pos = torch.gather(rays, 1, axis[:, None])[:, 0] > 0
    face = axis * 2 + (~sign_pos).long()
    color = torch.tensor(_FACE_COLORS, dtype=torch.float32, device=dev)[face]

    sc = torch.tensor(scene["sphere_c"], dtype=torch.float32, device=dev)
    oc = o - sc[None, :]
    dd = torch.sum(rays * rays, -1)
    b = torch.sum(oc * rays, -1)
    c = torch.sum(oc * oc, -1) - float(scene["sphere_r"]) ** 2
    disc = b * b - c * dd
    inf = torch.full_like(b, math.inf)
    t_sph = torch.where(disc > 0, (-b - torch.sqrt(disc.clamp(min=0))) / dd,
                        inf)
    t_sph = torch.where(t_sph > 0, t_sph, inf)
    hit = t_sph < t_box
    depth = torch.where(hit, t_sph, t_box)
    color = torch.where(hit[:, None], torch.tensor(
        _SPHERE_COLOR, dtype=torch.float32, device=dev)[None, :], color)

    pts = o + depth[:, None] * rays
    if scene["texture"] != "noise":
        raise ValueError(f"texture {scene['texture']!r}: only 'noise'")
    t = torch.zeros_like(depth)
    for amp, freq in _OCTAVES:
        f = torch.tensor([freq, freq * 1.371, freq * 0.773],
                         dtype=torch.float32, device=dev)
        t = t + amp * (torch.sin(torch.sum(pts * f, -1) + 0.7 * freq)
                       * torch.cos(torch.sum(pts * f.flip(0), -1)
                                   - 1.3 * freq))
    tex = (0.775 + 0.225 * torch.tanh(1.2 * t))[:, None]
    shade = (1.0 / (1.0 + 0.15 * depth))[:, None]
    return torch.clamp(color * tex * shade, 0.0, 1.0), depth


def hole_blocks(H: int, W: int, block_px: int, share: float,
                rng: np.random.Generator) -> np.ndarray:
    """The ids of the zeroed blocks of a frame (row-major over the block
    grid), drawn as `chip_smoke.depth_holes` draws them."""
    bh, bw = -(-H // block_px), -(-W // block_px)
    n = int(round(share * H * W / block_px ** 2))
    return rng.choice(bh * bw, n, replace=False)


def depth_holes(depth, rng: np.random.Generator, block_px: int = 16,
                share: float = 0.05) -> np.ndarray:
    """A copy of `depth` (H, W) with 0 in the blocks of `hole_blocks`
    (blocks at the lower and right edges are cut by the image)."""
    depth = np.array(depth, dtype=np.float32, copy=True)
    H, W = depth.shape
    bw = -(-W // block_px)
    for blk in hole_blocks(H, W, block_px, share, rng):
        r, c = divmod(int(blk), bw)
        depth[r * block_px:(r + 1) * block_px,
              c * block_px:(c + 1) * block_px] = 0
    return depth


def hole_mask(H: int, W: int, blocks, block_px: int, device) -> torch.Tensor:
    """(H, W) bool, True inside the blocks: `depth_holes` on the device."""
    bh, bw = -(-H // block_px), -(-W // block_px)
    m = torch.zeros(bh * bw, dtype=torch.bool, device=device)
    m[torch.as_tensor(np.asarray(blocks, np.int64), device=device)] = True
    m = m.reshape(bh, bw).repeat_interleave(block_px, 0)
    return m.repeat_interleave(block_px, 1)[:H, :W]


def frame_rng(seed: int, idx: int) -> np.random.Generator:
    """The draw of pool frame `idx`'s holes under run seed `seed`."""
    return np.random.default_rng([seed & (2 ** 64 - 1), idx])


def render_pool(scene: dict, intr: dict, deg_per_frame: float, seed: int,
                holes, device):
    """Every frame of one orbit, rendered on `device` and copied into host
    arrays: color (P, H, W, 3), depth (P, H, W) float32 and the c2w poses
    (P, 4, 4). `holes`: None, or {"block_px", "share"} dropouts drawn by
    `frame_rng(seed, idx)`."""
    P = pool_size(deg_per_frame)
    H, W = intr["H"], intr["W"]
    poses = np.stack([orbit_pose(i, scene["orbit_r"], deg_per_frame)
                      for i in range(P)])
    color = torch.empty((P, H, W, 3), dtype=torch.float32)
    depth = torch.empty((P, H, W), dtype=torch.float32)
    dirs = camera_dirs(intr, device)
    c2w = torch.as_tensor(poses, device=device)
    for i in range(P):
        c, d = render(scene, dirs, c2w[i])
        d = d.reshape(H, W)
        if holes:
            blocks = hole_blocks(H, W, holes["block_px"], holes["share"],
                                 frame_rng(seed, i))
            d = d.masked_fill(hole_mask(H, W, blocks, holes["block_px"],
                                        device), 0.0)
        color[i].copy_(c.reshape(H, W, 3), non_blocking=False)
        depth[i].copy_(d, non_blocking=False)
    return color.numpy(), depth.numpy(), poses


class Stream:
    """The sequence the program reads: frame i is pool frame i mod P, with
    its ground-truth pose; `len` is the declared length of the sequence.
    Items are (color, depth, c2w) host arrays, as the port's loaders give
    them."""

    def __init__(self, color, depth, poses, n_frames: int):
        self.color, self.depth, self.poses = color, depth, poses
        self.n_frames = n_frames

    def __len__(self) -> int:
        return self.n_frames

    def pool_index(self, i: int) -> int:
        return i % len(self.poses)

    def __getitem__(self, i: int):
        if not 0 <= i < self.n_frames:
            raise IndexError(f"frame {i} is past the stream's "
                             f"{self.n_frames} frames")
        k = self.pool_index(i)
        return self.color[k], self.depth[k], self.poses[k].copy()
