"""Camera tracking: per-frame 7-dof pose optimisation against the frozen map.

Counterpart of `unislam_tpu/engine/tracker.py`. One iteration samples
pixels in the inner image region, builds rays from the pose being
optimised, renders against the frozen scene, forms the masked SDF / color /
depth loss and takes an Adam step on (quat, trans) with separate learning
rates. `track_frame` runs a frame's iterations keeping the best-loss pose;
the best pose, the minimum loss and the uncertainty carry stay on the
device (no host sync per iteration). Iteration i draws from
`fold_in(seed, iter0 + i)`, so two chained calls equal one longer call.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from unislam_tpu_torch.core import losses as losses_lib
from unislam_tpu_torch.core import pose as pose_lib
from unislam_tpu_torch.core import rays as rays_lib
from unislam_tpu_torch.core import rng
from unislam_tpu_torch.core.rays import Intrinsics
from unislam_tpu_torch.models.scene import SceneConfig
from unislam_tpu_torch.render import renderer
from unislam_tpu_torch.render.renderer import RenderConfig


class TrackerConfig(NamedTuple):
    pixels: int = 2000
    iters: int = 8
    lr_T: float = 0.001
    lr_R: float = 0.001
    ignore_edge_W: int = 75
    ignore_edge_H: int = 75
    w_sdf_fs: float = 10.0
    w_sdf_center: float = 200.0
    w_sdf_tail: float = 50.0
    w_depth: float = 1.0
    w_color: float = 5.0
    const_speed_assumption: bool = True
    gt_camera: bool = False
    activated_mapping_mode: bool = True
    uncertainty_ts: float = 0.001
    mask_mode: str = "original"


def from_cfg(cfg) -> TrackerConfig:
    t = cfg["tracking"]
    return TrackerConfig(
        pixels=t["pixels"], iters=t["iters"], lr_T=t["lr_T"], lr_R=t["lr_R"],
        ignore_edge_W=t["ignore_edge_W"], ignore_edge_H=t["ignore_edge_H"],
        w_sdf_fs=t["w_sdf_fs"], w_sdf_center=t["w_sdf_center"],
        w_sdf_tail=t["w_sdf_tail"], w_depth=t["w_depth"],
        w_color=t["w_color"],
        const_speed_assumption=t.get("const_speed_assumption", True),
        gt_camera=t.get("gt_camera", False),
        activated_mapping_mode=t.get("activated_mapping_mode", True),
        uncertainty_ts=t.get("uncertainty_ts", 0.001),
        mask_mode=cfg.get("t_mask_mode", "original"),
    )


def make_pose(pose7: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A (7,) pose -> the optimised leaves {'R': (4,), 'T': (3,)}."""
    return {"R": pose7[:4].detach().clone().requires_grad_(True),
            "T": pose7[4:].detach().clone().requires_grad_(True)}


def make_optimizer(tc: TrackerConfig, pose) -> torch.optim.Adam:
    """Adam with betas (0.5, 0.999) and separate R/T learning rates."""
    return torch.optim.Adam([{"params": [pose["R"]], "lr": tc.lr_R},
                             {"params": [pose["T"]], "lr": tc.lr_T}],
                            betas=(0.5, 0.999))


class TrackState(NamedTuple):
    best7: torch.Tensor      # (7,) pose with the lowest loss so far
    min_loss: torch.Tensor   # ()
    unc_prev: torch.Tensor   # () mean uncertainty of the penultimate iter
    unc_last: torch.Tensor   # () mean uncertainty of the last iter


class Tracker:
    """The tracking loss, step and fused frame loop for one scene layout."""

    def __init__(self, sc: SceneConfig, rc: RenderConfig, tc: TrackerConfig,
                 intr: Intrinsics, device):
        self.sc, self.rc, self.tc, self.intr = sc, rc, tc, intr
        self.device = torch.device(device)
        self.bound = sc.bound_tensors(self.device)[0]
        self.w_sdf = losses_lib.SdfLossWeights(tc.w_sdf_fs, tc.w_sdf_center,
                                               tc.w_sdf_tail)

    def loss_fn(self, pose, params, depth_img, color_img,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None):
        """(loss, mean pixel uncertainty) at `pose`. `draws` may carry the
        pixel indices ("i", "j") and the renderer's draws."""
        tc, intr = self.tc, self.intr
        draws = draws or {}
        pose7 = torch.cat([pose["R"], pose["T"]])
        c2w = pose_lib.cam_pose_to_matrix(pose7[None])[0]

        ij = (draws["i"], draws["j"]) if "i" in draws else None
        i, j, gt_depth, gt_color = rays_lib.sample_pixels(
            tc.pixels, tc.ignore_edge_H, intr.H - tc.ignore_edge_H,
            tc.ignore_edge_W, intr.W - tc.ignore_edge_W, depth_img, color_img,
            generator, ij)
        rays_o, rays_d = rays_lib.rays_from_uv(i, j, c2w, intr)

        far = rays_lib.ray_aabb_far(rays_o.detach(), rays_d.detach(),
                                    self.bound)
        inside = (far >= gt_depth) & (gt_depth > 0)

        # excluded rays get a dummy depth, so every ray takes the
        # depth-guided path and the no-depth probe never runs; they are
        # masked out of all losses
        render_depth = torch.where(gt_depth > 0, gt_depth,
                                   torch.ones_like(gt_depth))
        out = renderer.render_rays(params, self.sc, self.rc, rays_o, rays_d,
                                   render_depth, generator, draws,
                                   probe=False)

        pixel_unc = out.pixel_unc.detach()
        alpha_mask = (1.0 - pixel_unc) > 0.99
        depth_err = torch.abs(gt_depth - out.depth.detach())
        err_median = losses_lib.masked_median(depth_err, inside)
        depth_mask = (depth_err < 10.0 * err_median) & alpha_mask & inside

        if tc.mask_mode == "original":
            m = depth_mask.to(torch.float32)
        else:  # "no_mask"
            m = inside.to(torch.float32)
        loss = losses_lib.sdf_losses(out.sdf, out.z_vals, gt_depth, m,
                                     self.sc.truncation, self.w_sdf)
        loss = loss + tc.w_color * losses_lib.color_loss(gt_color, out.rgb, m)
        loss = loss + tc.w_depth * losses_lib.depth_loss(gt_depth, out.depth,
                                                         m)
        mean_unc = losses_lib.masked_mean(out.pixel_unc.detach(), inside)
        return loss, mean_unc

    def step(self, params, pose, opt, depth_img, color_img,
             generator: Optional[torch.Generator] = None, draws=None):
        """One Adam step; pose is updated in place. Returns (loss, unc)
        evaluated at the input pose."""
        opt.zero_grad(set_to_none=True)
        loss, unc = self.loss_fn(pose, params, depth_img, color_img,
                                 generator, draws)
        loss.backward()
        opt.step()
        return loss.detach(), unc

    def track_frame(self, params, pose, opt, depth_img, color_img, seed: int,
                    n_iters: int, iter0: int = 0,
                    carry: Optional[TrackState] = None) -> TrackState:
        """`n_iters` iterations (draws of iteration i from
        fold_in(seed, iter0 + i)) keeping the best-loss pose; `carry`
        continues a frame from an earlier call with the same pose/opt."""
        if carry is None:
            zero = torch.zeros((), device=self.device)
            carry = TrackState(
                torch.cat([pose["R"], pose["T"]]).detach(),
                torch.full((), float("inf"), device=self.device), zero, zero)
        best7, min_loss, unc_prev, unc_last = carry
        for it in range(iter0, iter0 + n_iters):
            cur7 = torch.cat([pose["R"], pose["T"]]).detach()
            gen = rng.generator(rng.fold_in(seed, it), self.device)
            loss, unc = self.step(params, pose, opt, depth_img, color_img,
                                  gen)
            better = loss < min_loss
            best7 = torch.where(better, cur7, best7)
            min_loss = torch.where(better, loss, min_loss)
            unc_prev, unc_last = unc_last, unc
        return TrackState(best7, min_loss, unc_prev, unc_last)


def init_pose_const_speed(prev: torch.Tensor,
                          prev2: torch.Tensor) -> torch.Tensor:
    """Linear motion model in quat+trans space: 2*p[t-1] - p[t-2]."""
    p = pose_lib.matrix_to_cam_pose(torch.stack([prev2, prev]))
    return 2.0 * p[1] - p[0]
