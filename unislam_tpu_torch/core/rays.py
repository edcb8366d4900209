"""Ray generation and pixel sampling.

Counterpart of `unislam_tpu/core/rays.py`, same OpenGL convention: pixel
(i, j) (i = column, j = row) maps to the camera-frame direction
``[(i-cx)/fx, -(j-cy)/fy, -1]``. Pixel draws come from an explicit
`torch.Generator`, or enter as explicit index tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from unislam_tpu_torch import resolve_device


class Intrinsics(NamedTuple):
    H: int
    W: int
    fx: float
    fy: float
    cx: float
    cy: float


def camera_ray_dirs(intr: Intrinsics, device=None,
                    dtype=torch.float32) -> torch.Tensor:
    """Dense camera-frame ray directions (H, W, 3) on `device` (CUDA unless
    the caller asks for another)."""
    device = resolve_device(device)
    j, i = torch.meshgrid(torch.arange(intr.H, dtype=dtype, device=device),
                          torch.arange(intr.W, dtype=dtype, device=device),
                          indexing="ij")
    return torch.stack([(i - intr.cx) / intr.fx, -(j - intr.cy) / intr.fy,
                        -torch.ones_like(i)], dim=-1)


def dirs_to_world(dirs: torch.Tensor, c2w: torch.Tensor):
    """Rotate camera-frame dirs (..., 3) into the world frame; broadcast the
    origins. Returns (rays_o, rays_d) with dirs' shape."""
    rays_d = torch.sum(c2w[..., :3, :3] * dirs[..., None, :], dim=-1)
    rays_o = c2w[..., :3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays(intr: Intrinsics, c2w: torch.Tensor):
    """Full-image world-frame rays: (H, W, 3) origins and directions."""
    dirs = camera_ray_dirs(intr, device=c2w.device)
    return dirs_to_world(dirs, c2w.to(dirs.dtype))


def rays_from_uv(i: torch.Tensor, j: torch.Tensor, c2w: torch.Tensor,
                 intr: Intrinsics):
    """World rays for pixel coords i (cols), j (rows), (N,) float, under
    c2w (4, 4) or (N, 4, 4)."""
    dirs = torch.stack([(i - intr.cx) / intr.fx, -(j - intr.cy) / intr.fy,
                        -torch.ones_like(i)], dim=-1)
    return dirs_to_world(dirs, c2w)


def sample_pixels(n: int, h0: int, h1: int, w0: int, w1: int,
                  depth: torch.Tensor, color: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  ij: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """n pixels uniform over rows [h0, h1) x cols [w0, w1).

    depth (H, W), color (H, W, 3). Rows are drawn first, then columns, or
    both enter as `ij = (i, j)` integer tensors. Returns (i, j, depth_n,
    color_n) with i = cols, j = rows as float (N,)."""
    if ij is None:
        j = torch.randint(h0, h1, (n,), generator=generator,
                          device=depth.device)
        i = torch.randint(w0, w1, (n,), generator=generator,
                          device=depth.device)
    else:
        i, j = (t.to(device=depth.device, dtype=torch.int64) for t in ij)
    return (i.to(torch.float32), j.to(torch.float32), depth[j, i],
            color[j, i])


def ray_aabb_far(rays_o: torch.Tensor, rays_d: torch.Tensor,
                 bound: torch.Tensor) -> torch.Tensor:
    """Distance along each ray to its exit from the box `bound` (3, 2)."""
    t = (bound[None, :, :] - rays_o[..., None]) / rays_d[..., None]
    return torch.amin(torch.amax(t, dim=-1), dim=-1)
