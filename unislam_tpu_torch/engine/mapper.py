"""Map optimisation: scene parameters (+ keyframe poses, local BA) against
a keyframe-window ray batch.

Counterpart of `unislam_tpu/engine/mapper.py`. One iteration draws a
fixed-size (frame slot, pixel) batch from the keyframe bank and the current
frame, renders, forms the masked SDF / color / depth loss and takes an Adam
step over {grid tables, decoders, poses} with per-group learning rates.
Each mapping phase starts a fresh optimiser; the scene groups' learning
rates carry the phase's `lr_scale` (Adam's update is linear in its rate, so
this equals the JAX package's scaled updates), the pose group's does not.
Iteration i draws from `fold_in(seed, iter0 + i)`.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from unislam_tpu_torch.core import losses as losses_lib
from unislam_tpu_torch.core import pose as pose_lib
from unislam_tpu_torch.core import rays as rays_lib
from unislam_tpu_torch.core import rng
from unislam_tpu_torch.core.rays import Intrinsics
from unislam_tpu_torch.engine.keyframes import KeyframeBank
from unislam_tpu_torch.models.scene import SceneConfig
from unislam_tpu_torch.render import renderer
from unislam_tpu_torch.render.renderer import RenderConfig


class MapperConfig(NamedTuple):
    pixels: int = 4000
    iters: int = 15
    iters_first: int = 10
    every_frame: int = 4
    keyframe_every: int = 4
    mapping_window_size: int = 20
    joint_opt: bool = True
    joint_opt_cam_lr: float = 0.001
    lr_decoders: float = 0.001
    lr_hash: float = 0.05
    lr_c_hash: float = 0.05
    lr_factor: float = 1.0
    lr_first_factor: float = 5.0
    w_sdf_fs: float = 5.0
    w_sdf_center: float = 200.0
    w_sdf_tail: float = 10.0
    w_depth: float = 0.1
    w_color: float = 5.0
    extra_rays: int = 200
    mask_mode: str = "original"


def from_cfg(cfg) -> MapperConfig:
    m = cfg["mapping"]
    if m.get("adam_state_dtype", "float32") != "float32":
        raise NotImplementedError("mapping.adam_state_dtype other than "
                                  "float32 is not ported yet")
    return MapperConfig(
        pixels=m["pixels"], iters=m["iters"], iters_first=m["iters_first"],
        every_frame=m["every_frame"], keyframe_every=m["keyframe_every"],
        mapping_window_size=m["mapping_window_size"],
        joint_opt=m.get("joint_opt", True),
        joint_opt_cam_lr=m.get("joint_opt_cam_lr", 0.001),
        lr_decoders=m["lr"]["decoders_lr"], lr_hash=m["lr"]["hash_grids_lr"],
        lr_c_hash=m["lr"]["c_hash_grids_lr"],
        lr_factor=m.get("lr_factor", 1.0),
        lr_first_factor=m.get("lr_first_factor", 5.0),
        w_sdf_fs=m["w_sdf_fs"], w_sdf_center=m["w_sdf_center"],
        w_sdf_tail=m["w_sdf_tail"], w_depth=m["w_depth"],
        w_color=m["w_color"], mask_mode=cfg.get("m_mask_mode", "original"),
    )


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# scene leaf -> its learning-rate field; other leaves are decoder leaves.
# The brick encoding's one shared table trains at the SDF table's rate.
_TABLE_LR = {"sdf_table": "lr_hash", "table": "lr_hash",
             "color_table": "lr_c_hash"}


def make_optimizer(mc: MapperConfig, scene: Dict[str, Any],
                   poses: torch.Tensor, lr_scale: float = 1.0):
    """Per-group f32 Adam: decoders (with beta), each grid table (the SDF
    and color hash tables, or the one brick table), poses. The scene
    groups' rates are multiplied by `lr_scale`."""
    dec = [t for k, v in scene.items() if k not in _TABLE_LR
           for t in _leaves(v)]
    tables = [{"params": [scene[k]], "lr": getattr(mc, lr) * lr_scale}
              for k, lr in _TABLE_LR.items() if k in scene]
    return torch.optim.Adam(
        [{"params": dec, "lr": mc.lr_decoders * lr_scale}] + tables
        + [{"params": [poses], "lr": mc.joint_opt_cam_lr}])


def trainable(scene: Dict[str, Any], poses: torch.Tensor):
    """Fresh leaves that require gradients, for one mapping phase."""
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return v.detach().requires_grad_(True)
    return conv(scene), poses.detach().clone().requires_grad_(True)


def frozen(scene: Dict[str, Any]) -> Dict[str, Any]:
    """The scene's leaves detached (no gradient), sharing storage."""
    return {k: (frozen(v) if isinstance(v, dict) else v.detach())
            for k, v in scene.items()}


class MapBatch(NamedTuple):
    """What a mapping phase draws its rays from."""
    bank: KeyframeBank
    cur_depth: torch.Tensor      # (H, W)
    cur_color: torch.Tensor      # (H, W, 3)
    cur_rays_d: torch.Tensor     # (H, W, 3) camera-frame directions
    sel_probs: torch.Tensor      # (max_kf+1,) frame-slot distribution
    extra_probs: torch.Tensor    # (max_kf+1,) for the extra rays
    pose_grad_mask: torch.Tensor  # (max_kf+1, 1) 1 where BA moves the pose
    probe: bool = True           # whether some ray may lack depth


class Mapper:
    """The mapping loss, step and phase loop for one scene layout."""

    def __init__(self, sc: SceneConfig, rc: RenderConfig, mc: MapperConfig,
                 intr: Intrinsics, max_kf: int, bank_size: int, device):
        self.sc, self.rc, self.mc, self.intr = sc, rc, mc, intr
        self.max_kf, self.bank_size = max_kf, bank_size
        self.device = torch.device(device)
        self.bound = sc.bound_tensors(self.device)[0]
        self.w_sdf = losses_lib.SdfLossWeights(mc.w_sdf_fs, mc.w_sdf_center,
                                               mc.w_sdf_tail)

    def draw(self, batch: MapBatch, generator: torch.Generator):
        """The iteration's ray draws: frame slots (main, then extra),
        bank pixels, current-frame pixels."""
        mc, dev = self.mc, self.device
        n_rays = mc.pixels + mc.extra_rays
        slot_main = torch.multinomial(batch.sel_probs, mc.pixels,
                                      replacement=True, generator=generator)
        slot_extra = torch.multinomial(batch.extra_probs, mc.extra_rays,
                                       replacement=True, generator=generator)
        return {
            "slot": torch.cat([slot_main, slot_extra]),
            "pix_b": torch.randint(0, self.bank_size, (n_rays,),
                                   generator=generator, device=dev),
            "pix_c": torch.randint(0, self.intr.H * self.intr.W, (n_rays,),
                                   generator=generator, device=dev),
        }

    def loss_fn(self, scene, poses, batch: MapBatch,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None):
        """The mapping loss. `draws` may carry "slot", "pix_b", "pix_c" and
        the renderer's draws; what it lacks comes from `generator`."""
        mc, max_kf, bank = self.mc, self.max_kf, batch.bank
        draws = dict(draws or {})
        if "slot" not in draws:
            draws.update(self.draw(batch, generator))
        slot = draws["slot"].to(self.device)
        pix_b = draws["pix_b"].to(self.device)
        pix_c = draws["pix_c"].to(self.device)

        # BA gradient gating: fixed slots see only the detached value
        mask = batch.pose_grad_mask
        poses = poses * mask + poses.detach() * (1.0 - mask)

        is_cur = slot == max_kf
        kf_slot = torch.clamp(slot, max=max_kf - 1)
        gt_depth = torch.where(is_cur, batch.cur_depth.reshape(-1)[pix_c],
                               bank.depth[kf_slot, pix_b])
        gt_color = torch.where(is_cur[:, None],
                               batch.cur_color.reshape(-1, 3)[pix_c],
                               bank.color[kf_slot, pix_b])
        dir_cam = torch.where(is_cur[:, None],
                              batch.cur_rays_d.reshape(-1, 3)[pix_c],
                              bank.rays_d[kf_slot, pix_b])

        c2w = pose_lib.cam_pose_to_matrix(poses)          # (max_kf+1, 4, 4)
        rays_o, rays_d = rays_lib.dirs_to_world(dir_cam, c2w[slot])

        far = rays_lib.ray_aabb_far(rays_o.detach(), rays_d.detach(),
                                    self.bound)
        inside = far >= gt_depth

        out = renderer.render_rays(scene, self.sc, self.rc, rays_o, rays_d,
                                   gt_depth, generator, draws,
                                   probe=batch.probe)

        pixel_unc = out.pixel_unc.detach()
        alpha_mask = (1.0 - pixel_unc) > 0.99
        depth_mask = (gt_depth > 0) & alpha_mask & inside

        if mc.mask_mode == "original":
            m_sdf = depth_mask.to(torch.float32)
            m_col = inside.to(torch.float32)   # color loss over all rays
            m_dep = depth_mask.to(torch.float32)
        else:  # "no_mask"
            m_sdf = m_col = m_dep = inside.to(torch.float32)

        loss = losses_lib.sdf_losses(out.sdf, out.z_vals, gt_depth, m_sdf,
                                     self.sc.truncation, self.w_sdf)
        loss = loss + mc.w_color * losses_lib.color_loss(gt_color, out.rgb,
                                                         m_col)
        loss = loss + mc.w_depth * losses_lib.depth_loss(gt_depth, out.depth,
                                                         m_dep)
        return loss

    def step(self, scene, poses, opt, batch: MapBatch,
             generator: Optional[torch.Generator] = None, draws=None):
        """One Adam step on the (trainable) scene leaves and poses."""
        opt.zero_grad(set_to_none=True)
        loss = self.loss_fn(scene, poses, batch, generator, draws)
        loss.backward()
        opt.step()
        return loss.detach()

    def map_phase(self, scene, poses, opt, batch: MapBatch, seed: int,
                  n_iters: int, iter0: int = 0) -> torch.Tensor:
        """`n_iters` iterations, iteration i drawing from
        fold_in(seed, iter0 + i). Returns the last loss (on the device)."""
        loss = torch.zeros((), device=self.device)
        for it in range(iter0, iter0 + n_iters):
            gen = rng.generator(rng.fold_in(seed, it), self.device)
            loss = self.step(scene, poses, opt, batch, gen)
        return loss
