"""Camera tracking: per-frame 7-dof pose optimisation against the frozen map.

Counterpart of `unislam_tpu/engine/tracker.py`. One iteration samples
pixels in the inner image region, builds rays from the pose being
optimised, renders against the frozen scene, forms the masked SDF / color /
depth loss and takes an Adam step on (quat, trans) with separate learning
rates. `track_frame` runs a frame's iterations keeping the best-loss pose;
the best pose, the minimum loss and the uncertainty carry stay on the
device (no host sync per iteration). Iteration i draws from
`fold_in(seed, iter0 + i)`, so two chained calls equal one longer call.

On one CUDA device with one rank the iteration is a CUDA graph
(`TrackGraph`): the frame's leaves and Adam persist (`frame_pose` resets
them in place), each iteration draws and gathers its pixels eagerly into
fixed buffers, and one graph launch runs the loss, its backward and the
Adam step. The CPU and ray groups run the same iteration eagerly.

Under a ray group (`parallel/sharding.py`) every rank draws the whole
pixel batch and keeps its block of rays; the depth-error median is taken
over the whole batch (gathered), the loss's means take the batch's
denominators, the pose gradient is summed over the ranks before the step,
and the loss and the mean uncertainty are the batch's, the same on every
rank, so every rank keeps the same best pose and takes the same branches.
"""

from __future__ import annotations

import weakref
from typing import Dict, NamedTuple, Optional

import torch

from unislam_tpu_torch.core import losses as losses_lib
from unislam_tpu_torch.core import pose as pose_lib
from unislam_tpu_torch.core import rays as rays_lib
from unislam_tpu_torch.core import rng
from unislam_tpu_torch.core.rays import Intrinsics
from unislam_tpu_torch.engine.graphs import (GraphAdam, GraphedIteration,
                                            leaf_key)
from unislam_tpu_torch.models.scene import SceneConfig
from unislam_tpu_torch.parallel import sharding
from unislam_tpu_torch.render import renderer
from unislam_tpu_torch.render.renderer import RenderConfig
from unislam_tpu_torch.utils.profiling import span


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


BETAS, EPS = (0.5, 0.999), 1e-8


def make_optimizer(tc: TrackerConfig, pose) -> torch.optim.Adam:
    """Adam with betas (0.5, 0.999) and separate R/T learning rates."""
    return torch.optim.Adam([{"params": [pose["R"]], "lr": tc.lr_R},
                             {"params": [pose["T"]], "lr": tc.lr_T}],
                            betas=BETAS)


class PoseLeaves(GraphAdam):
    """The pose leaves {'R', 'T'} and their Adam (`GraphAdam`: the
    numbers of `make_optimizer`, bit for bit) for the tracker's life,
    reset in place for each frame, so that a captured graph finds them
    where it recorded them. A reset gives the numbers of a fresh
    `make_pose` / `make_optimizer`."""

    def __init__(self, tc: TrackerConfig, device):
        device = torch.device(device)
        self.pose = {"R": torch.zeros(4, device=device, requires_grad=True),
                     "T": torch.zeros(3, device=device, requires_grad=True)}
        super().__init__(list(self.pose.values()), (0, 1),
                         (tc.lr_R, tc.lr_T), BETAS, 4 * tc.iters, EPS)

    def reset(self, pose7: torch.Tensor):
        """(pose, optimiser: this) at the start of a frame at pose7 (7,)."""
        with torch.no_grad():
            self.pose["R"].copy_(pose7[:4])
            self.pose["T"].copy_(pose7[4:])
        self.restart()
        return self.pose, self


class TrackState(NamedTuple):
    best7: torch.Tensor      # (7,) pose with the lowest loss so far
    min_loss: torch.Tensor   # ()
    unc_prev: torch.Tensor   # () mean uncertainty of the penultimate iter
    unc_last: torch.Tensor   # () mean uncertainty of the last iter


class Tracker:
    """The tracking loss, step and fused frame loop for one scene layout."""

    def __init__(self, sc: SceneConfig, rc: RenderConfig, tc: TrackerConfig,
                 intr: Intrinsics, device, group=None):
        self.sc, self.rc, self.tc, self.intr = sc, rc, tc, intr
        self.device = torch.device(device)
        self.group = group   # the ray group (None: one rank)
        self.bound = sc.bound_tensors(self.device)[0]
        self.w_sdf = losses_lib.SdfLossWeights(tc.w_sdf_fs, tc.w_sdf_center,
                                               tc.w_sdf_tail)
        # the graphed iteration (one CUDA device, one rank; `frame_pose`)
        self.graph: Optional[TrackGraph] = None

    def draw_pixels(self, generator, out=None) -> Dict[str, torch.Tensor]:
        """The batch's pixel draws from `generator` as `loss_fn` takes
        them: rows "j", then columns "i" (into `out`'s tensors, if
        given)."""
        tc, intr, out = self.tc, self.intr, out or {}
        kw = dict(generator=generator, device=self.device)
        j = torch.randint(tc.ignore_edge_H, intr.H - tc.ignore_edge_H,
                          (tc.pixels,), out=out.get("j"), **kw)
        i = torch.randint(tc.ignore_edge_W, intr.W - tc.ignore_edge_W,
                          (tc.pixels,), out=out.get("i"), **kw)
        return {"j": j, "i": i}

    def _shard_draws(self, generator, draws):
        """Under a group: the whole batch's draws (`draws`, or all of them
        from `generator` in the order one rank draws them: rows, columns,
        then the renderer's), then this rank's block of rays."""
        if "i" not in draws:
            draws.update(self.draw_pixels(generator))
            draws.update(renderer.draw(self.rc, self.tc.pixels, False,
                                       generator, self.device))
        return {k: sharding.shard_rays(self.group, v.to(self.device))
                for k, v in draws.items()}

    def frame_pose(self, pose7: torch.Tensor):
        """(pose, opt) for a frame that starts at pose7 (7,): on one CUDA
        device with one rank the graphed iteration's own leaves and Adam,
        reset in place (`step` replays the graph on them); else fresh
        `make_pose` / `make_optimizer`."""
        if self.device.type != "cuda" or self.group is not None:
            pose = make_pose(pose7)
            return pose, make_optimizer(self.tc, pose)
        if self.graph is None:
            self.graph = TrackGraph(self)
        return self.graph.leaves.reset(pose7)

    def loss_fn(self, pose, params, depth_img, color_img,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None):
        """(loss, mean pixel uncertainty) at `pose`; under a group, this
        rank's parts of both (`step` sums them over the ranks). `draws`
        may carry the pixel indices ("i", "j") and the renderer's draws
        for the whole batch."""
        tc, intr = self.tc, self.intr
        draws = dict(draws or {})
        if self.group is not None:
            draws = self._shard_draws(generator, draws)
        ij = (draws["i"], draws["j"]) if "i" in draws else None
        i, j, gt_depth, gt_color = rays_lib.sample_pixels(
            tc.pixels, tc.ignore_edge_H, intr.H - tc.ignore_edge_H,
            tc.ignore_edge_W, intr.W - tc.ignore_edge_W, depth_img, color_img,
            generator, ij)
        return self.pixel_loss(pose, params, i, j, gt_depth, gt_color,
                               generator, draws)

    def pixel_loss(self, pose, params, i, j, gt_depth, gt_color,
                   generator=None, draws=None):
        """`loss_fn` at pixels already drawn: columns i and rows j (R,)
        f32, their depth (R,) and colour (R, 3); `draws` may carry the
        renderer's."""
        tc, intr, group = self.tc, self.intr, self.group
        pose7 = torch.cat([pose["R"], pose["T"]])
        c2w = pose_lib.cam_pose_to_matrix(pose7[None])[0]
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
        with span("track.loss"):
            pixel_unc = out.pixel_unc.detach()
            alpha_mask = (1.0 - pixel_unc) > 0.99
            depth_err = torch.abs(gt_depth - out.depth.detach())
            if group is None:
                err_median = losses_lib.masked_median(depth_err, inside)
            else:
                # the whole batch's errors and mask, in one all-reduce
                both = sharding.gather_rows(torch.stack(
                    [depth_err, inside.to(depth_err.dtype)], 1), tc.pixels,
                    group)
                err_median = losses_lib.masked_median(both[:, 0],
                                                      both[:, 1] > 0)
            self.last_median = err_median   # the batch's, on every rank
            depth_mask = (depth_err < 10.0 * err_median) & alpha_mask & inside

            if tc.mask_mode == "original":
                m = depth_mask.to(torch.float32)
            else:  # "no_mask"
                m = inside.to(torch.float32)
            # under a group: the batch's denominators, in one all-reduce
            d = (None,) * 6 if group is None else sharding.all_reduce_sum(
                losses_lib.loss_counts(out.z_vals, gt_depth,
                                       self.sc.truncation, m, m, m, inside),
                group)
            loss = losses_lib.sdf_losses(out.sdf, out.z_vals, gt_depth, m,
                                         self.sc.truncation, self.w_sdf,
                                         d[:3])
            loss = loss + tc.w_color * losses_lib.color_loss(
                gt_color, out.rgb, m, d[3])
            loss = loss + tc.w_depth * losses_lib.depth_loss(
                gt_depth, out.depth, m, d[4])
            mean_unc = losses_lib.masked_mean(out.pixel_unc.detach(), inside,
                                              d[5])
            return loss, mean_unc

    def step(self, params, pose, opt, depth_img, color_img,
             generator: Optional[torch.Generator] = None, draws=None):
        """One Adam step; pose is updated in place. Returns (loss, unc)
        evaluated at the input pose (the batch's, under a group). On the
        leaves of `frame_pose` with a graph (`TrackGraph`), a replay."""
        g = self.graph
        if g is not None and pose is g.leaves.pose and opt is g.leaves:
            return g.step(params, depth_img, color_img, generator, draws)
        with span("track.opt"):
            opt.zero_grad(set_to_none=True)
        with span("track.fwd"):
            loss, unc = self.loss_fn(pose, params, depth_img, color_img,
                                     generator, draws)
        with span("track.bwd"):
            loss.backward()
        if self.group is not None:
            with span("track.allreduce"):
                # the pose gradient, the loss and the uncertainty in one
                loss, unc = sharding.all_reduce_grads(
                    [pose["R"], pose["T"]], self.group,
                    torch.stack([loss.detach(), unc]))
        with span("track.opt"):
            opt.step()
        return loss.detach(), unc

    def track_frame(self, params, pose, opt, depth_img, color_img, seed: int,
                    n_iters: int, iter0: int = 0,
                    carry: Optional[TrackState] = None,
                    on_iter=None, draws=None) -> TrackState:
        """`n_iters` iterations (draws of iteration i from
        fold_in(seed, iter0 + i)) keeping the best-loss pose; `carry`
        continues a frame from an earlier call with the same pose and
        optimiser. `on_iter(it, pose7)` (visualisation) is called before
        each iteration with the pose it starts from; it draws nothing from
        the iteration's generator, so the numerics do not change.
        `draws[k]`, if given, are iteration iter0 + k's draws (`step`)."""
        if carry is None:
            zero = torch.zeros((), device=self.device)
            carry = TrackState(
                torch.cat([pose["R"], pose["T"]]).detach(),
                torch.full((), float("inf"), device=self.device), zero, zero)
        best7, min_loss, unc_prev, unc_last = carry
        for it in range(iter0, iter0 + n_iters):
            with span("track.iter"):
                cur7 = torch.cat([pose["R"], pose["T"]]).detach()
                if on_iter is not None:
                    on_iter(it, cur7)
                gen = rng.generator(rng.fold_in(seed, it), self.device)
                loss, unc = self.step(params, pose, opt, depth_img,
                                      color_img, gen, None if draws is None
                                      else draws[it - iter0])
                better = loss < min_loss
                best7 = torch.where(better, cur7, best7)
                min_loss = torch.where(better, loss, min_loss)
                unc_prev, unc_last = unc_last, unc
        return TrackState(best7, min_loss, unc_prev, unc_last)


class TrackGraph(GraphedIteration):
    """A tracker's iteration as one CUDA graph (one CUDA device, one rank;
    `GraphedIteration`, spans `track.replay` and `track.capture`, counter
    `track_graph`).

    The graph holds `run`: zero_grad, the loss at the pose leaves
    (`PoseLeaves`) on fixed buffers (the pixels' columns and rows, their
    depth and colour, the renderer's jitter), the backward and Adam's
    step. Each iteration first `take`s its draws into the buffers eagerly,
    from its own generator (or the draws handed in) in the order
    `loss_fn` takes them, and gathers the frame's depth and colour there;
    then one launch replays the graph. The frame's images stay where they
    are. Its inputs are these buffers, the leaves and the scene's tensors,
    so a graph belongs to a key: the scene's leaves' addresses, shapes,
    dtypes and grad flags (the device and the encoding are the
    tracker's)."""

    def __init__(self, tracker: "Tracker"):
        super().__init__(tracker.device, "track", "track_graph")
        # the tracker owns this graph: no reference cycle, so a dropped
        # tracker's graph goes with it, and not in a later collection
        self.tracker = weakref.proxy(tracker)
        tc, dev = tracker.tc, tracker.device
        self.leaves = PoseLeaves(tc, dev)
        n = tc.pixels
        self.pixels = {k: torch.zeros(n, dtype=torch.int64, device=dev)
                       for k in ("j", "i")}
        self.gt_depth = torch.zeros(n, device=dev)
        self.gt_color = torch.zeros(n, 3, device=dev)
        self.render = {k: torch.zeros(shape, device=dev) for k, shape in
                       renderer.draw_shapes(tracker.rc, n, False).items()}

    def take(self, generator, draws, depth_img, color_img) -> None:
        """An iteration's eager inputs: its draws into the buffers
        (`draws`' entries, the rest from `generator` in `loss_fn`'s order:
        rows, columns, then the renderer's), the images' depth and colour
        there, and Adam's bias corrections for its step."""
        self.leaves.advance()
        draws = draws or {}
        px = self.pixels
        if "i" in draws:
            px["i"].copy_(draws["i"])
            px["j"].copy_(draws["j"])
        else:
            self.tracker.draw_pixels(generator, out=px)
        for k, t in self.render.items():
            if k in draws:
                t.copy_(draws[k])
            else:
                torch.rand(t.shape, generator=generator, out=t)
        self.gt_depth.copy_(depth_img[px["j"], px["i"]])
        self.gt_color.copy_(color_img[px["j"], px["i"]])

    def run(self, params) -> torch.Tensor:
        """One iteration on the buffers: the loss at the leaves, its
        backward, Adam's update. Returns [loss, unc, median] (3,)."""
        tr, pose, opt = self.tracker, self.leaves.pose, self.leaves
        with span("track.opt"):
            opt.zero_grad(set_to_none=True)
        with span("track.fwd"):
            loss, unc = tr.pixel_loss(
                pose, params, self.pixels["i"].to(torch.float32),
                self.pixels["j"].to(torch.float32), self.gt_depth,
                self.gt_color, None, self.render)
            out = torch.stack([loss.detach(), unc, tr.last_median])
        with span("track.bwd"):
            loss.backward()
        with span("track.opt"):
            opt.update()
        return out

    def step(self, params, depth_img, color_img, generator, draws):
        """`Tracker.step` on the leaves: (loss, unc), copies."""
        with span("track.draw"):
            self.take(generator, draws, depth_img, color_img)
        out = self.launch(leaf_key(params), lambda: self.run(params))
        self.tracker.last_median = out[2]
        return out[0], out[1]


def init_pose_const_speed(prev: torch.Tensor,
                          prev2: torch.Tensor) -> torch.Tensor:
    """Linear motion model in quat+trans space: 2*p[t-1] - p[t-2]."""
    p = pose_lib.matrix_to_cam_pose(torch.stack([prev2, prev]))
    return 2.0 * p[1] - p[0]
