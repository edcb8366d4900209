"""Map optimisation: scene parameters (+ keyframe poses, local BA) against
a keyframe-window ray batch.

Counterpart of `unislam_tpu/engine/mapper.py`. One iteration draws a
fixed-size (frame slot, pixel) batch from the keyframe bank and the current
frame, renders, forms the masked SDF / color / depth loss and takes an Adam
step over {grid tables, decoders, poses} with per-group learning rates.
Each mapping phase starts a fresh optimiser; the scene groups' learning
rates carry the phase's `lr_scale` (Adam's update is linear in its rate, so
this equals the JAX package's scaled updates), the pose group's does not.
With `mapping.adam_state_dtype: bfloat16` the grid tables step with
`AdamLP` (bf16 moments by stochastic rounding, kernel K7), which scales
each update by `lr_scale` after `-lr` as the JAX mapper does; decoders,
beta and poses keep f32 Adam. Iteration i draws from
`fold_in(seed, iter0 + i)`.

On one CUDA device with one rank (the hash encoding, f32 decoders and f32
Adam) the iteration is a CUDA graph (`MapGraph`): the scene's and the
poses' leaves and their Adam persist (`phase_leaves` hands them out again
for each phase, reset in place), each iteration draws its rays and
gathers them from the keyframe bank and the current frame eagerly into
fixed buffers, and one graph launch runs the loss, its backward and the
Adam step. The CPU and the other layouts run the same iteration eagerly.

Under a ray group (`parallel/sharding.py`) every rank draws the whole
batch, as one rank would, and keeps its block of rays; the loss's means
take the batch's denominators, and the gradients of the replicated leaves
and the poses are summed over the ranks before the step. The tables named
in `table_rows` are row blocks: the render reads the full table through
`GatherRows`, and the step (Adam, or K7 with the block's element offset)
updates the block alone.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, NamedTuple, Optional

import torch

from unislam_tpu_torch.core import losses as losses_lib
from unislam_tpu_torch.core import pose as pose_lib
from unislam_tpu_torch.core import rays as rays_lib
from unislam_tpu_torch.core import rng
from unislam_tpu_torch.core.optim import AdamLP
from unislam_tpu_torch.core.rays import Intrinsics
from unislam_tpu_torch.engine.graphs import (GraphAdam, GraphedIteration,
                                            leaf_key)
from unislam_tpu_torch.engine.keyframes import KeyframeBank
from unislam_tpu_torch.kernels import fused_mlp
from unislam_tpu_torch.models.scene import SceneConfig
from unislam_tpu_torch.parallel import sharding
from unislam_tpu_torch.render import renderer
from unislam_tpu_torch.render.renderer import RenderConfig
from unislam_tpu_torch.utils.profiling import span


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
    # the grid tables' Adam moments: "float32" or "bfloat16" (AdamLP)
    adam_state_dtype: str = "float32"


def from_cfg(cfg) -> MapperConfig:
    m = cfg["mapping"]
    dtype = m.get("adam_state_dtype", "float32")
    if dtype not in ("float32", "bfloat16"):
        # a typo ("bf16", "float16", ...) is refused, not run as float32
        raise ValueError("mapping.adam_state_dtype must be 'bfloat16' or "
                         f"'float32', got {dtype!r}")
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
        adam_state_dtype=dtype,
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


class Optimizers:
    """Optimisers stepped together as one."""

    def __init__(self, *opts):
        self.opts = opts

    @property
    def param_groups(self):
        return [g for o in self.opts for g in o.param_groups]

    def zero_grad(self, set_to_none: bool = True):
        for o in self.opts:
            o.zero_grad(set_to_none=set_to_none)

    def step(self):
        for o in self.opts:
            o.step()


def make_optimizer(mc: MapperConfig, scene: Dict[str, Any],
                   poses: torch.Tensor, lr_scale: float = 1.0,
                   offsets: Optional[Dict[str, int]] = None):
    """Per-group Adam: decoders (with beta), each grid table (the SDF and
    color hash tables, or the one brick table), poses. The scene groups'
    updates are multiplied by `lr_scale`. f32 Adam throughout, or with
    `adam_state_dtype` "bfloat16" the tables on `AdamLP` (one group a
    table, as the JAX package's `multi_transform` groups them).
    `offsets`: a table's first element in the whole table when `scene`
    holds a row block of it (AdamLP's random bits follow the whole
    table's element index)."""
    offsets = offsets or {}
    dec = [t for k, v in scene.items() if k not in _TABLE_LR
           for t in _leaves(v)]
    tables = [(scene[k], getattr(mc, lr)) for k, lr in _TABLE_LR.items()
              if k in scene]
    dec_group = {"params": dec, "lr": mc.lr_decoders * lr_scale}
    pose_group = {"params": [poses], "lr": mc.joint_opt_cam_lr}
    if mc.adam_state_dtype == "bfloat16":
        return Optimizers(
            torch.optim.Adam([dec_group, pose_group]),
            AdamLP([{"params": [scene[k]], "lr": getattr(mc, lr),
                     "offset": offsets.get(k, 0)}
                    for k, lr in _TABLE_LR.items() if k in scene],
                   lr=mc.lr_hash, lr_scale=lr_scale))
    return torch.optim.Adam(
        [dec_group] + [{"params": [t], "lr": lr * lr_scale}
                       for t, lr in tables] + [pose_group])


def _as_leaves(tree):
    """Leaves that require gradients, sharing the storage of `tree`'s."""
    if isinstance(tree, dict):
        return {k: _as_leaves(v) for k, v in tree.items()}
    return tree.detach().requires_grad_(True)


def trainable(scene: Dict[str, Any], poses: torch.Tensor):
    """Fresh leaves that require gradients, for one mapping phase."""
    return _as_leaves(scene), poses.detach().clone().requires_grad_(True)


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
                 intr: Intrinsics, max_kf: int, bank_size: int, device,
                 group=None, table_rows: Optional[Dict[str, int]] = None):
        self.sc, self.rc, self.mc, self.intr = sc, rc, mc, intr
        self.max_kf, self.bank_size = max_kf, bank_size
        self.device = torch.device(device)
        # the ray group (None: one rank), and the row-sharded tables: key
        # -> the whole table's row count
        self.group = group
        self.table_rows = dict(table_rows or {}) if group is not None else {}
        self.bound = sc.bound_tensors(self.device)[0]
        self.w_sdf = losses_lib.SdfLossWeights(mc.w_sdf_fs, mc.w_sdf_center,
                                               mc.w_sdf_tail)
        # the graphed iteration (`graphed`, `phase_leaves`)
        self.graph: Optional[MapGraph] = None

    @property
    def graphed(self) -> bool:
        """Whether a phase's iterations replay a CUDA graph (`MapGraph`):
        on one CUDA device with one rank, the hash encoding, f32 decoders
        and f32 Adam."""
        return (self.device.type == "cuda" and self.group is None
                and self.sc.encoding == "hash"
                and self.sc.mlp_variant != "fused"
                and self.mc.adam_state_dtype == "float32")

    def phase_leaves(self, scene, poses7: torch.Tensor, lr_scale: float,
                     offsets: Optional[Dict[str, int]] = None):
        """(scene, poses, opt) for a mapping phase from the scene and the
        (max_kf + 1, 7) poses: where `graphed`, the graph's leaves and
        Adam, reset in place (`step` replays the graph on them); else
        fresh `trainable` leaves and `make_optimizer`'s Adam."""
        if not self.graphed:
            scene, poses = trainable(scene, poses7)
            return scene, poses, make_optimizer(self.mc, scene, poses,
                                                lr_scale, offsets)
        if self.graph is None:
            self.graph = MapGraph(self)
        return self.graph.bind(scene, poses7, lr_scale)

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

    def full_scene(self, scene):
        """`scene` with each row-sharded table gathered whole (through
        `GatherRows`, so its gradient reaches the block)."""
        if not self.table_rows:
            return scene
        return {k: (sharding.GatherRows.apply(v, self.table_rows[k],
                                              self.group)
                    if k in self.table_rows else v)
                for k, v in scene.items()}

    def replicated_leaves(self, scene, poses):
        """The leaves whose gradients are summed over the ranks: every
        scene leaf but the row-sharded tables, and the poses."""
        return [t for k, v in scene.items() if k not in self.table_rows
                for t in _leaves(v)] + [poses]

    def _shard_draws(self, batch: MapBatch, generator, draws):
        """Under a group: the whole batch's draws (`draws`, or all of them
        from `generator` in the order one rank draws them), then this
        rank's block of rays."""
        if "slot" not in draws:
            draws.update(self.draw(batch, generator))
            draws.update(renderer.draw(
                self.rc, self.mc.pixels + self.mc.extra_rays, batch.probe,
                generator, self.device))
        return {k: sharding.shard_rays(self.group, v.to(self.device))
                for k, v in draws.items()}

    def loss_fn(self, scene, poses, batch: MapBatch,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None):
        """The mapping loss (under a group, this rank's part of it).
        `draws` may carry "slot", "pix_b", "pix_c" and the renderer's
        draws for the whole batch; what it lacks comes from `generator`."""
        draws = dict(draws or {})
        if self.group is not None:
            draws = self._shard_draws(batch, generator, draws)
        elif "slot" not in draws:
            draws.update(self.draw(batch, generator))
        slot = draws["slot"].to(self.device)
        gt_depth, gt_color, dir_cam = self.gather(
            batch, slot, draws["pix_b"].to(self.device),
            draws["pix_c"].to(self.device))
        return self.ray_loss(self.full_scene(scene), poses,
                             batch.pose_grad_mask, slot, gt_depth, gt_color,
                             dir_cam, batch.probe, generator, draws)

    def gather(self, batch: MapBatch, slot, pix_b, pix_c):
        """The drawn rays' depth (R,), colour (R, 3) and camera-frame
        direction (R, 3): slot `max_kf` is the current frame (pixel
        `pix_c`), the others the bank's (pixel `pix_b`)."""
        bank, max_kf = batch.bank, self.max_kf
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
        return gt_depth, gt_color, dir_cam

    def ray_loss(self, scene, poses, pose_grad_mask, slot, gt_depth,
                 gt_color, dir_cam, probe: bool, generator=None, draws=None):
        """`loss_fn` on rays already drawn and gathered: the frame slot
        (R,) of each, its depth, colour and camera-frame direction
        (`gather`); `scene` whole (`full_scene`); `draws` may carry the
        renderer's."""
        mc, group = self.mc, self.group
        # BA gradient gating: fixed slots see only the detached value
        mask = pose_grad_mask
        poses = poses * mask + poses.detach() * (1.0 - mask)

        c2w = pose_lib.cam_pose_to_matrix(poses)          # (max_kf+1, 4, 4)
        rays_o, rays_d = rays_lib.dirs_to_world(dir_cam, c2w[slot])

        far = rays_lib.ray_aabb_far(rays_o.detach(), rays_d.detach(),
                                    self.bound)
        inside = far >= gt_depth

        out = renderer.render_rays(scene, self.sc, self.rc, rays_o, rays_d,
                                   gt_depth, generator, draws, probe=probe)

        with span("map.loss"):
            pixel_unc = out.pixel_unc.detach()
            alpha_mask = (1.0 - pixel_unc) > 0.99
            depth_mask = (gt_depth > 0) & alpha_mask & inside

            if mc.mask_mode == "original":
                m_sdf = depth_mask.to(torch.float32)
                m_col = inside.to(torch.float32)   # color loss over all rays
                m_dep = depth_mask.to(torch.float32)
            else:  # "no_mask"
                m_sdf = m_col = m_dep = inside.to(torch.float32)

            # under a group: the batch's denominators, in one all-reduce
            d = (None,) * 5 if group is None else sharding.all_reduce_sum(
                losses_lib.loss_counts(out.z_vals, gt_depth,
                                       self.sc.truncation, m_sdf, m_col,
                                       m_dep), group)
            loss = losses_lib.sdf_losses(out.sdf, out.z_vals, gt_depth,
                                         m_sdf, self.sc.truncation,
                                         self.w_sdf, d[:3])
            loss = loss + mc.w_color * losses_lib.color_loss(
                gt_color, out.rgb, m_col, d[3])
            loss = loss + mc.w_depth * losses_lib.depth_loss(
                gt_depth, out.depth, m_dep, d[4])
            return loss

    def backward(self, scene, poses, batch: MapBatch,
                 generator: Optional[torch.Generator] = None, draws=None):
        """The loss and its gradients on the leaves, summed over the
        ranks; returns the batch's loss (detached). The fused decoders'
        weight gradients come out of K4 as f32 sums and are rounded to
        bf16 here, after the ranks' sum, as one rank rounds the whole
        batch's."""
        with span("map.fwd"):
            loss = self.loss_fn(scene, poses, batch, generator, draws)
        with span("map.bwd"):
            loss.backward()
        loss = loss.detach().reshape(1)
        if self.group is not None:
            with span("map.allreduce"):
                loss = sharding.all_reduce_grads(
                    self.replicated_leaves(scene, poses), self.group, loss)
        if self.sc.mlp_variant == "fused":
            with span("map.opt"):
                fused_mlp.round_bf16_(t.grad
                                      for k in ("sdf_mlp", "color_mlp")
                                      for t in _leaves(scene[k]))
        return loss[0]

    def step(self, scene, poses, opt, batch: MapBatch,
             generator: Optional[torch.Generator] = None, draws=None):
        """One Adam step on the (trainable) scene leaves and poses; on the
        leaves of `phase_leaves` with a graph (`MapGraph`), a replay."""
        g = self.graph
        if g is not None and poses is g.poses and opt is g.adam:
            return g.step(scene, batch, generator, draws)
        with span("map.opt"):
            opt.zero_grad(set_to_none=True)
        loss = self.backward(scene, poses, batch, generator, draws)
        with span("map.opt"):
            opt.step()
        return loss

    def map_phase(self, scene, poses, opt, batch: MapBatch, seed: int,
                  n_iters: int, iter0: int = 0, on_iter=None) -> torch.Tensor:
        """`n_iters` iterations, iteration i drawing from
        fold_in(seed, iter0 + i). Returns the last loss (on the device).
        `on_iter(it, {"scene", "poses"})` (visualisation) is called before
        each iteration; it draws nothing from the iteration's generator."""
        loss = torch.zeros((), device=self.device)
        for it in range(iter0, iter0 + n_iters):
            with span("map.iter"):
                if on_iter is not None:
                    on_iter(it, {"scene": scene, "poses": poses})
                gen = rng.generator(rng.fold_in(seed, it), self.device)
                loss = self.step(scene, poses, opt, batch, gen)
        return loss


class MapGraph(GraphedIteration):
    """A mapper's iteration as one CUDA graph (one CUDA device, one rank;
    `GraphedIteration`, spans `map.replay` and `map.capture`, counter
    `map_graph`).

    The graph holds `run`: zero_grad, the loss at the scene's and the
    poses' leaves on fixed buffers (each ray's frame slot, depth, colour
    and camera-frame direction, the renderer's draws, the phase's pose
    mask), the backward and Adam's step (`GraphAdam`, torch's numbers).
    Each iteration first `take`s its draws eagerly, from its own
    generator (or the draws handed in) in the order `loss_fn` takes them,
    and gathers the rays from the keyframe bank and the current frame
    into the buffers; then one launch replays the graph. So the bank, the
    frame and the window's slot probabilities stay outside the graph.

    The leaves live while the scene's storage does: `bind` hands them out
    again, their Adam reset, for each phase, and makes new ones for a
    scene in new storage. A graph belongs to a key: the leaves (their
    generation and addresses) and whether the phase probes for rays
    without depth."""

    def __init__(self, mapper: "Mapper"):
        super().__init__(mapper.device, "map", "map_graph")
        # the mapper owns this graph: no reference cycle
        self.mapper = weakref.proxy(mapper)
        mc, dev = mapper.mc, mapper.device
        self.n = n = mc.pixels + mc.extra_rays
        self.slot = torch.zeros(n, dtype=torch.int64, device=dev)
        self.gt_depth = torch.zeros(n, device=dev)
        self.gt_color = torch.zeros(n, 3, device=dev)
        self.dir_cam = torch.zeros(n, 3, device=dev)
        self.mask = torch.zeros(mapper.max_kf + 1, 1, device=dev)
        # room for the probe's draws, which a phase without it leaves out
        self.render = {k: torch.zeros(shape, device=dev) for k, shape in
                       renderer.draw_shapes(mapper.rc, n, True).items()}
        self.poses = torch.zeros(mapper.max_kf + 1, 7, device=dev,
                                 requires_grad=True)
        self.scene = None         # the scene's leaves
        self.adam: Optional[GraphAdam] = None
        self.scene_key = None     # `leaf_key` of the scene they share
        self.generation = 0       # leaves made so far

    def bind(self, scene, poses7: torch.Tensor, lr_scale: float):
        """(scene, poses, opt: a `GraphAdam`) for a phase that starts at
        `scene` and `poses7`, the scene groups' learning rates scaled by
        `lr_scale` (`make_optimizer`'s groups and numbers)."""
        key = leaf_key(scene)
        if key != self.scene_key:
            self.scene, self.scene_key = _as_leaves(scene), key
            self.generation += 1
            self.adam = None
        torch_adam = make_optimizer(self.mapper.mc, self.scene, self.poses,
                                    lr_scale)
        groups = torch_adam.param_groups
        lrs = [g["lr"] for g in groups]
        if self.adam is None:
            mc = self.mapper.mc
            self.adam = GraphAdam(
                [p for g in groups for p in g["params"]],
                [k for k, g in enumerate(groups) for _ in g["params"]],
                lrs, torch_adam.defaults["betas"],
                max(mc.iters_first, 2 * mc.iters),
                torch_adam.defaults["eps"])
        self.adam.restart(lrs)
        with torch.no_grad():
            self.poses.copy_(poses7)
        return self.scene, self.poses, self.adam

    def draws_for(self, probe: bool) -> Dict[str, torch.Tensor]:
        """The renderer's draw buffers a phase takes, in its order."""
        return {k: self.render[k] for k in
                renderer.draw_shapes(self.mapper.rc, self.n, probe)}

    def take(self, batch: MapBatch, generator, draws) -> None:
        """An iteration's eager inputs: its draws (`draws`' entries, the
        rest from `generator` in `loss_fn`'s order: frame slots, bank
        pixels, current-frame pixels, then the renderer's), the rays
        gathered into the buffers, the phase's pose mask, and Adam's bias
        corrections for its step."""
        mapper = self.mapper
        self.adam.advance()
        draws = draws or {}
        if "slot" not in draws:
            draws = {**draws, **mapper.draw(batch, generator)}
        for k, t in self.draws_for(batch.probe).items():
            if k in draws:
                t.copy_(draws[k])
            else:
                torch.rand(t.shape, generator=generator, out=t)
        slot = draws["slot"].to(self.device)
        self.slot.copy_(slot)
        for buf, v in zip((self.gt_depth, self.gt_color, self.dir_cam),
                          mapper.gather(batch, slot,
                                        draws["pix_b"].to(self.device),
                                        draws["pix_c"].to(self.device))):
            buf.copy_(v)
        self.mask.copy_(batch.pose_grad_mask)

    def run(self, scene, probe: bool) -> torch.Tensor:
        """One iteration on the buffers: the loss at the leaves, its
        backward, Adam's update. Returns the loss (1,)."""
        with span("map.opt"):
            self.adam.zero_grad(set_to_none=True)
        with span("map.fwd"):
            loss = self.mapper.ray_loss(
                scene, self.poses, self.mask, self.slot, self.gt_depth,
                self.gt_color, self.dir_cam, probe, None,
                self.draws_for(probe))
        with span("map.bwd"):
            loss.backward()
        with span("map.opt"):
            self.adam.update()
        return loss.detach().reshape(1)

    def step(self, scene, batch: MapBatch, generator, draws):
        """`Mapper.step` on the leaves: the loss, a copy."""
        with span("map.draw"):
            self.take(batch, generator, draws)
        key = (self.generation, batch.probe, leaf_key(scene))
        return self.launch(key, lambda: self.run(scene, batch.probe))[0]
