"""Co-visibility keyframe selection and loop-closure detection.

Counterpart of `unislam_tpu/engine/selection.py`: cast `num_rays` rays from
the current frame, place `num_samples` points along each between
0.8*depth and depth+0.5, project them into every keyframe slot and measure
the fraction that lands inside the edge-margined image in front of the
camera. Returns masks; the driver turns them into sampling probabilities.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from unislam_tpu_torch.core import pose as pose_lib
from unislam_tpu_torch.core import rays as rays_lib
from unislam_tpu_torch.core.rays import Intrinsics
from unislam_tpu_torch.engine.keyframes import KeyframeBank
from unislam_tpu_torch.utils.profiling import fetch


class SelectionResult(NamedTuple):
    percent_inside: torch.Tensor  # (max_kf,) overlap with each keyframe slot
    normal_mask: torch.Tensor     # (max_kf,) bool: the non-LC window
    lc_mask: torch.Tensor         # (max_kf,) bool: loop-closure window
    lc_flag: torch.Tensor         # () bool: loop closure fired
    back_mask: torch.Tensor       # (max_kf,) bool: tracking-back top-k window


def make_selection_fn(intr: Intrinsics, max_kf: int, num_rays: int = 50,
                      num_samples: int = 8, lc_enabled: bool = True,
                      lc_ts: float = 0.95, lc_min_gap: int = 100,
                      window_size: int = 20, edge: int = 20):
    """select(bank, cur_depth, cur_color, cur_c2w, frame_idx, generator,
    ij=None) -> SelectionResult"""

    def select(bank: KeyframeBank, cur_depth, cur_color, cur_c2w,
               frame_idx: int, generator: Optional[torch.Generator] = None,
               ij=None) -> SelectionResult:
        dev = cur_depth.device
        # copies up from the host and the inverse's error check make the
        # host wait for the device (`fetch`)
        K = fetch(torch.tensor, [[intr.fx, 0.0, intr.cx],
                                 [0.0, intr.fy, intr.cy], [0.0, 0.0, 1.0]],
                  dtype=torch.float32, device=dev)
        i, j, gd, _ = rays_lib.sample_pixels(
            num_rays, 0, intr.H, 0, intr.W, cur_depth, cur_color, generator,
            ij)
        rays_o, rays_d = rays_lib.rays_from_uv(i, j, cur_c2w, intr)
        ray_valid = gd > 0

        t_vals = torch.linspace(0.0, 1.0, num_samples, device=dev)
        near = (gd * 0.8)[:, None]
        far = (gd + 0.5)[:, None]
        z = near * (1.0 - t_vals)[None, :] + far * t_vals[None, :]
        pts = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
               ).reshape(-1, 3)
        pt_valid = ray_valid.repeat_interleave(num_samples)

        w2c = fetch(torch.linalg.inv,
                    pose_lib.cam_pose_to_matrix(bank.pose7))
        homo = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=-1)
        cam = torch.einsum("kij,nj->kni", w2c, homo)[..., :3]
        cam = cam * fetch(torch.tensor, [-1.0, 1.0, 1.0], device=dev)
        uv = torch.einsum("ij,knj->kni", K, cam)
        zc = uv[..., 2:] + 1e-5
        uv = uv[..., :2] / zc

        inside = (uv[..., 0] < intr.W - edge) & (uv[..., 0] > edge) & \
                 (uv[..., 1] < intr.H - edge) & (uv[..., 1] > edge) & \
                 (zc[..., 0] < 0) & pt_valid[None, :]
        denom = torch.clamp(pt_valid.sum(), min=1)
        percent_inside = inside.sum(dim=1) / denom

        slots = torch.arange(max_kf, device=dev)
        # the last two keyframes are always in the window, not selected
        old = slots < bank.count - 2
        percent_inside = torch.where(old, percent_inside,
                                     torch.zeros_like(percent_inside))

        # the best slot read back once (an index by a device scalar would
        # read it back at each use)
        best = fetch(int, torch.argmax(percent_inside))
        best_gap = frame_idx - bank.frame_idx[best]
        lc_flag = (percent_inside[best] > lc_ts) & (best_gap > lc_min_gap) \
            & lc_enabled
        lc_mask = old & (slots >= best)

        # tracking-back: top-(window_size-1) slots by overlap among > 0
        order = torch.argsort(-percent_inside, stable=True)
        rank = torch.empty_like(slots)
        rank[order] = slots
        back_mask = (rank < window_size - 1) & (percent_inside > 0.0) & old
        return SelectionResult(percent_inside, old, lc_mask, lc_flag,
                               back_mask)

    return select


def window_probs(max_kf: int, count: int, sel_mask, extra_newest: int = 10,
                 use_extra_threshold: int = 20):
    """Host-side: a keyframe-slot mask -> (max_kf+1,) frame-sampling
    probabilities (slot max_kf = current frame): the mask plus the last two
    keyframes plus the current frame, uniformly weighted. Also returns the
    newest-`extra_newest` distribution for the extra rays, falling back to
    the main window when count <= use_extra_threshold."""
    mask = np.zeros(max_kf + 1, dtype=np.float64)
    mask[:max_kf] = np.asarray(sel_mask, dtype=np.float64)
    if count >= 1:
        mask[count - 1] = 1.0
    if count >= 2:
        mask[count - 2] = 1.0
    mask[max_kf] = 1.0  # current frame
    probs = mask / mask.sum()

    extra = np.zeros(max_kf + 1, dtype=np.float64)
    if count > use_extra_threshold:
        newest = np.arange(max(0, count - extra_newest), count)
        extra[newest] = 1.0
        extra /= extra.sum()
    else:
        extra = probs
    return probs, extra
