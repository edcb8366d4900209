"""The SLAM driver: track each frame, map every few frames, keep keyframes.

Counterpart of `unislam_tpu/engine/slam.py` `UniSLAM`: the same scheduling
(activated mapping with the mid-frame iteration doubling, tracking-back,
keyframe cadence, compacting eviction, loop-closure windows) over one scene
parameter dict and a device-resident keyframe bank. Per tracked frame the
host fetches one scalar (the penultimate iteration's mean uncertainty) and
the best pose; per mapping phase, the window selection and the final loss.
Every call that makes the host wait for the device goes through
`profiling.fetch` and is counted in `iters_run["syncs"]`; `step_frame`
installs the run's `PhaseStats` (with `profiling.enabled`) for the spans
the layers open (`utils/profiling.py`).

The next frame's host-to-device copy is staged while the current frame
runs (`FramePrefetcher.try_get`, pinned memory, a non-blocking copy). The
runtime (`unislam_tpu_torch/runtime.py`) attaches its side work through
hooks: `on_frame_done` / `on_mapping_done`, called as f(slam, idx), and
the per-iteration visualisation hooks `tracking_iter_vis` /
`mapping_iter_vis` (objects with .wants(idx), .inside_freq and
__call__(slam, idx, it, x), x the current pose7 or {"scene", "poses"}). A
frame they claim runs the same per-iteration loop with the callback
between iterations, so its numerics equal the plain path's.

Several devices (`cfg["parallel"]`): with `data_parallel` the driver runs
on every rank of the process group (`parallel/distributed.py`, one
process a device) and each tracking and mapping iteration splits its ray
batch over the ranks (`parallel/sharding.py`); parameters, poses and the
keyframe bank are replicated (broadcast from rank 0 after init), and
every host decision reads values that are the same on every rank. With
`shard_tables` each rank trains a row block of every grid table and the
full tables are gathered once a mapping phase, for tracking, rendering,
meshing and checkpoints. `n_devices` may be null or the world size. The
overlapped tracker/mapper loops are `engine/overlap.py`, which this
class's hooks `_ray_group`, `_tracking_params`, `_writeback_ba_pose` and
`_finish_loss` serve.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from unislam_tpu_torch import resolve_device
from unislam_tpu_torch.core import pose as pose_lib
from unislam_tpu_torch.core import rng
from unislam_tpu_torch.core.rays import Intrinsics, camera_ray_dirs
from unislam_tpu_torch.engine import keyframes as kf_lib
from unislam_tpu_torch.engine import mapper as mapper_lib
from unislam_tpu_torch.engine import selection as selection_lib
from unislam_tpu_torch.engine import tracker as tracker_lib
from unislam_tpu_torch.models import scene as scene_lib
from unislam_tpu_torch.parallel import distributed as pdist
from unislam_tpu_torch.parallel import sharding
from unislam_tpu_torch.render.renderer import RenderConfig
from unislam_tpu_torch.utils import profiling
from unislam_tpu_torch.utils.profiling import fetch, span


def intrinsics_from_cfg(cfg) -> Intrinsics:
    """Apply the crop_size / crop_edge intrinsic updates."""
    cam = cfg["cam"]
    H, W = cam["H"], cam["W"]
    fx, fy, cx, cy = cam["fx"], cam["fy"], cam["cx"], cam["cy"]
    if "crop_size" in cam:
        sy = cam["crop_size"][0] / H
        sx = cam["crop_size"][1] / W
        fx, fy, cx, cy = sx * fx, sy * fy, sx * cx, sy * cy
        H, W = cam["crop_size"][0], cam["crop_size"][1]
    edge = cam.get("crop_edge", 0)
    if edge > 0:
        H, W = H - 2 * edge, W - 2 * edge
        cx, cy = cx - edge, cy - edge
    return Intrinsics(H=H, W=W, fx=fx, fy=fy, cx=cx, cy=cy)


class UniSLAM:
    """Sequential tracker + mapper over a frame source.

    `dataset[i]` gives (color (H,W,3) float [0,1], depth (H,W) float
    meters, gt_c2w (4,4)) numpy arrays; `len(dataset)` the frame count.
    Runs on `device` (CUDA unless asked otherwise)."""

    def __init__(self, cfg: Dict[str, Any], dataset, seed: int = 0,
                 device=None):
        # the ray group of a data-parallel run (None: one rank)
        par = cfg.get("parallel", {})
        self.group = self._ray_group(par)
        self.rank = 0 if self.group is None else self.group.rank
        # whether this process writes the run's files (runtime.py)
        self.writer = self.rank == 0
        self.device = resolve_device(device)
        if self.group is not None and self.device.type == "cuda" \
                and self.device.index is None:
            self.device = pdist.rank_device()
        self.cfg = cfg
        self.dataset = dataset
        self.n_img = len(dataset)
        if cfg.get("data", {}).get("prefetch", True):
            from unislam_tpu_torch.data.prefetch import FramePrefetcher
            self._frames = FramePrefetcher(dataset)
        else:
            self._frames = dataset
        # (idx, color, depth, gt_c2w) of the next frame, already on its way
        # to the device, or None
        self._staged_frame = None
        self.verbose = cfg.get("verbose", False)

        self.intr = intrinsics_from_cfg(cfg)
        self.sc = scene_lib.make_scene_config(cfg)
        r = cfg["rendering"]
        self.rc = RenderConfig(n_stratified=r["n_stratified"],
                               n_importance=r["n_importance"],
                               perturb=bool(r.get("perturb", True)),
                               n_fine=int(r.get("n_fine", 0)),
                               lod_split=str(r.get("lod_split", "cost")),
                               lod_select=str(r.get("lod_select", "depth")),
                               n_fine_mid=int(r.get("n_fine_mid", 0)),
                               dedup_band=float(r.get("dedup_band", 0.0)))
        # tracking may read the map at another LOD than mapping
        # (tracking.n_fine: -1 = coarse levels only, 0 = every level, > 0 =
        # the surface band; default: rendering's n_fine) and splits the
        # levels by its own lod_split (default "cost"); the band row dedup
        # serves table gradients only, which tracking never forms
        t = cfg["tracking"]
        t_nf = t.get("n_fine", None)
        self.rc_track = self.rc._replace(
            n_fine=int(self.rc.n_fine if t_nf is None else t_nf),
            lod_split=str(t.get("lod_split", "cost")),
            lod_select=str(t.get("lod_select", "depth")),
            dedup_band=0.0)
        self.tc = tracker_lib.from_cfg(cfg)
        self.mc = mapper_lib.from_cfg(cfg)

        self.seeds = rng.SeedStream(seed)
        gen = rng.generator(self.seeds.next())   # CPU: same init anywhere
        self.params = scene_lib.init_params(self.sc, gen, self.device)
        pdist.replicate(self.params, self.group)
        # row-sharded tables: key -> the whole table's row count
        self.table_rows = {k: self.params[k].shape[0]
                           for k in sharding.sharded_keys(
                               self.params, bool(par.get("shard_tables",
                                                         False)))} \
            if self.group is not None else {}
        # a data-parallel run's last mapping optimiser, and the ids of its
        # row blocks
        self.map_opt = None

        self.bank_size = max(1, int(self.intr.H * self.intr.W * 0.1))
        self.max_kf = min(self.n_img,
                          self.n_img // self.mc.keyframe_every + 65)
        self.bank = kf_lib.init_bank(self.max_kf, self.bank_size, self.device)
        # which slots hold cadence keyframes (vs tracking-back extras)
        self.kf_is_cadence = np.zeros(self.max_kf, dtype=bool)
        self._evict_warned = False

        self.tracker = tracker_lib.Tracker(self.sc, self.rc_track, self.tc,
                                           self.intr, self.device, self.group)
        self.mapper = mapper_lib.Mapper(self.sc, self.rc, self.mc, self.intr,
                                        self.max_kf, self.bank_size,
                                        self.device, self.group,
                                        self.table_rows)
        self.select_fn = selection_lib.make_selection_fn(
            self.intr, self.max_kf,
            lc_enabled=bool(cfg["mapping"].get("LC", True)),
            lc_ts=float(cfg["mapping"].get("LC_ts", 0.95)),
            window_size=self.mc.mapping_window_size)

        self.cam_rays_d = camera_ray_dirs(self.intr, device=self.device)

        self.est_c2w = np.zeros((self.n_img, 4, 4), dtype=np.float32)
        self.gt_c2w = np.zeros((self.n_img, 4, 4), dtype=np.float32)
        self.tracking_weights = np.zeros(self.n_img, dtype=np.float32)
        self.additional_map_records = np.zeros(self.n_img, dtype=np.int32)
        self.t_iters = self.tc.iters
        self.m_iters = self.mc.iters
        self.last_track_iters = 0   # iterations the LAST frame executed
        self.tracking_back = False
        self.lc_cnt = 0
        self.mapping_cnt = 0
        self.last_map_loss = None   # the last mapping phase's loss
        self.init_phase = True
        # the program's counter registry, every key declared here: the
        # iterations executed over the run (tracking, mapping, and mapping
        # iterations that ran the no-depth probe), the calls that made the
        # host wait for the device (`profiling.fetch`), and with
        # `profiling.enabled` each span's host time in integer
        # microseconds (`us.<span>`, `profiling.SPANS`); the tracking and
        # the mapping iterations replayed from a CUDA graph and the graphs
        # captured (`engine/tracker.py: TrackGraph`, `engine/mapper.py:
        # MapGraph`); the frames whose activated-
        # mapping trigger fired at the end of tracking, doubling the
        # iterations that follow, and those extended mid-frame from the
        # base count
        self.iters_run = {"track": 0, "map": 0, "probe": 0, "syncs": 0,
                          "track_graph": 0, "map_graph": 0,
                          "graph_captures": 0,
                          "activated": 0, "extended": 0,
                          **{"us." + n: 0 for n in profiling.SPANS}}

        # hooks (set by the runtime): f(self, idx)
        self.on_frame_done = None
        self.on_mapping_done = None
        # per-iteration visualisation hooks (see the module note)
        self.tracking_iter_vis = None
        self.mapping_iter_vis = None

        if cfg.get("profiling", {}).get("enabled", False):
            self.stats = profiling.PhaseStats(counters=self.iters_run)
        else:
            self.stats = None

    def _ray_group(self, par):
        """The group the tracker and the mapper split their ray batches
        over: every rank of the process group with `data_parallel`, else
        None (one rank). The multi-process overlapped driver hands its
        mapping ranks their own group instead."""
        if not par.get("data_parallel", False):
            return None
        group = pdist.global_ray_group()
        world = 1 if group is None else group.size
        n_dev = par.get("n_devices", None)
        if n_dev is not None and int(n_dev) != world:
            raise ValueError(f"parallel.n_devices is {n_dev} but the run "
                             f"has {world} rank(s) (one a device)")
        return group

    @property
    def kf_count(self) -> int:
        return self.bank.count

    # ------------------------------------------------------------------
    def _upload(self, color, depth):
        color_t = torch.as_tensor(np.asarray(color, np.float32))
        depth_t = torch.as_tensor(np.asarray(depth, np.float32))
        if self.device.type == "cuda":
            color_t = color_t.pin_memory().to(self.device, non_blocking=True)
            depth_t = depth_t.pin_memory().to(self.device, non_blocking=True)
        return color_t, depth_t

    def _frame(self, idx: int):
        if self._staged_frame is not None and self._staged_frame[0] == idx:
            _, color_t, depth_t, gt = self._staged_frame
            self._staged_frame = None
        else:
            color, depth, gt_c2w = self._frames[idx]
            color_t, depth_t = self._upload(color, depth)
            gt = np.asarray(gt_c2w, np.float32)
        # stage the NEXT frame's copy now if its decode already finished:
        # it is queued before this frame's work, so the next frame finds
        # its data on the device instead of copying it first
        try_get = getattr(self._frames, "try_get", None)
        if try_get is not None and self._staged_frame is None:
            nxt = try_get(idx + 1)
            if nxt is not None:
                c, d, g = nxt
                self._staged_frame = (idx + 1, *self._upload(c, d),
                                      np.asarray(g, np.float32))
        return color_t, depth_t, gt

    def _c2w(self, idx: int, device=None) -> torch.Tensor:
        # a copy from pageable host memory: the host waits for it
        return fetch(torch.as_tensor, self.est_c2w[idx],
                     device=device or self.device)

    # ------------------------------------------------------------------
    def track_frame(self, idx: int, depth_img, color_img) -> np.ndarray:
        """Optimise the frame's pose; returns the best 4x4 c2w."""
        with span("track.init"):
            dev = self.tracker.device
            if self.tc.const_speed_assumption and idx >= 2:
                pose7 = tracker_lib.init_pose_const_speed(
                    self._c2w(idx - 1, dev), self._c2w(idx - 2, dev))
            else:
                pose7 = pose_lib.matrix_to_cam_pose(
                    self._c2w(idx - 1, dev)[None])[0]
            params = self._tracking_params()

            pose, opt = self.tracker.frame_pose(pose7)
            seed = self.seeds.next()
            n1 = int(self.t_iters)
            self.last_track_iters = n1
            vis = self.tracking_iter_vis
            vis = vis if vis is not None and vis.wants(idx) else None
        state = self.tracker.track_frame(
            params, pose, opt, depth_img, color_img, seed, n1,
            on_iter=self._iter_vis(vis, idx, 0, n1))

        # activated mapping: checked with the PENULTIMATE iteration's
        # uncertainty. A first fire (the frame ran the base count) extends
        # the current frame 8 -> 16 with the draw schedule intact, and the
        # trigger is checked again at the new penultimate iteration, which
        # decides tracking-back and the doubled counts for what follows.
        if idx > 0:
            mean_unc = fetch(float, state.unc_prev)
            triggered = (self.tc.activated_mapping_mode
                         and mean_unc > self.tc.uncertainty_ts)
            if triggered and n1 == self.tc.iters:
                self.additional_map_records[idx] = 1
                self.iters_run["extended"] += 1
                self.last_track_iters = n1 + self.tc.iters
                state = self.tracker.track_frame(
                    params, pose, opt, depth_img, color_img, seed,
                    self.tc.iters, iter0=n1, carry=state,
                    on_iter=self._iter_vis(vis, idx, n1, self.tc.iters))
                mean_unc = fetch(float, state.unc_prev)
                triggered = mean_unc > self.tc.uncertainty_ts
            self.tracking_weights[idx] = mean_unc
            if triggered:
                self.iters_run["activated"] += 1
                self.t_iters = self.tc.iters * 2
                self.m_iters = self.mc.iters * 2
                self.tracking_back = True
                self.additional_map_records[idx] = 1
            else:
                self.t_iters = self.tc.iters
                self.m_iters = self.mc.iters
                self.tracking_back = False
        self.iters_run["track"] += self.last_track_iters
        return fetch(torch.Tensor.cpu, pose_lib.cam_pose_to_matrix(
            state.best7[None])[0]).numpy()

    def _iter_vis(self, vis, idx: int, iter0: int, n_iters: int):
        """The per-iteration callback of a loop over iterations iter0 ..
        iter0 + n_iters - 1, or None: `vis` fires every vis.inside_freq
        iterations and on the last one."""
        if vis is None:
            return None
        last = iter0 + n_iters - 1

        def on_iter(it, x):
            if it % vis.inside_freq == 0 or it == last:
                with span("vis"):
                    vis(self, idx, it, x)
        return on_iter

    # ------------------------------------------------------------------
    def map_frame(self, idx: int, depth_img, color_img) -> float:
        """One mapping phase over the keyframe window + current frame."""
        with span("map.select"):
            count = self.kf_count
            cur_c2w = self._c2w(idx)
            cur_pose7 = pose_lib.matrix_to_cam_pose(cur_c2w[None])[0]
            sel_seed, phase_seed = self._phase_seeds()

            if sel_seed is not None:
                res = self.select_fn(self.bank, depth_img, color_img,
                                     cur_c2w, idx,
                                     rng.generator(sel_seed, self.device))
                if self.tracking_back and self.tc.activated_mapping_mode:
                    sel_mask = fetch(torch.Tensor.cpu, res.back_mask).numpy()
                elif fetch(bool, res.lc_flag):
                    sel_mask = fetch(torch.Tensor.cpu, res.lc_mask).numpy()
                    self.lc_cnt += 1
                    if self.verbose:
                        print(f"[LC] loop closure at frame {idx}")
                else:
                    sel_mask = fetch(torch.Tensor.cpu,
                                     res.normal_mask).numpy()
            else:
                sel_mask = np.zeros(self.max_kf, dtype=bool)

        with span("map.setup"):
            probs, extra = selection_lib.window_probs(self.max_kf, count,
                                                      sel_mask)

            joint_opt = self.mc.joint_opt and count > 4
            pose_grad_mask = np.zeros((self.max_kf + 1, 1), dtype=np.float32)
            if joint_opt:
                window = probs[:self.max_kf] > 0
                slots = np.nonzero(window)[0]
                if len(slots):
                    window[slots[0]] = False  # oldest window frame stays fixed
                pose_grad_mask[:self.max_kf, 0] = window.astype(np.float32)
                pose_grad_mask[self.max_kf, 0] = 1.0  # current frame pose

            # whether any ray of this phase can lack depth: asked once per
            # phase, so the iterations never wait for the device
            probe = fetch(bool, (depth_img <= 0).any()) or (
                count > 0
                and fetch(bool, (self.bank.depth[:count] <= 0).any()))

            dev = self.device
            batch = mapper_lib.MapBatch(
                self.bank, depth_img, color_img, self.cam_rays_d,
                fetch(torch.as_tensor, probs, dtype=torch.float32, device=dev),
                fetch(torch.as_tensor, extra, dtype=torch.float32, device=dev),
                fetch(torch.as_tensor, pose_grad_mask, device=dev), probe)
            # a row-sharded table trains its rank's row block (a copy: the
            # gathered table stays as the other readers' view)
            blocks, offsets = {}, {}
            for k, n_rows in self.table_rows.items():
                a, b = sharding.group_block(n_rows, self.group)
                blocks[k] = self.params[k][a:b].clone()
                offsets[k] = a * self.params[k].shape[1]
            first = self.init_phase
            iters = int(self.mc.iters_first if first else self.m_iters)
            lr_scale = self.mc.lr_first_factor if first else self.mc.lr_factor
            scene, poses, opt = self.mapper.phase_leaves(
                {**self.params, **blocks},
                torch.cat([self.bank.pose7, cur_pose7[None]]), lr_scale,
                offsets)
            if self.group is not None:   # for replica_state
                self.map_opt = (opt, {id(scene[k]) for k in blocks})
            vis = self.mapping_iter_vis
            vis = vis if vis is not None and vis.wants(idx) else None
        loss = self.mapper.map_phase(scene, poses, opt, batch,
                                     phase_seed, iters,
                                     on_iter=self._iter_vis(vis, idx, 0,
                                                            iters))

        with span("map.gather"):
            # the row-sharded tables are gathered once a phase
            self.params = {k: (sharding.gather_rows(v, self.table_rows[k],
                                                    self.group)
                               if k in self.table_rows else v)
                           for k, v in mapper_lib.frozen(scene).items()}
            if joint_opt:
                poses = poses.detach()
                self.bank.pose7 = poses[:self.max_kf].clone()
                self._writeback_ba_pose(idx, poses[self.max_kf])
            self.mapping_cnt += 1
            self.init_phase = False
            self.iters_run["map"] += iters
            self.iters_run["probe"] += iters if probe else 0
        return self._finish_loss(loss)

    # -- the schedule's draws (a driver that skips the work keeps them) --
    def _phase_seeds(self):
        """A mapping phase's draws, in order: the keyframe selection's
        (None while the bank holds at most 2 keyframes, which selects
        none) and the phase's own."""
        sel = self.seeds.next() if self.kf_count > 2 else None
        return sel, self.seeds.next()

    def _keyframe_seed(self, idx: int):
        """The draw of the keyframe that mapped frame `idx` adds (on the
        keyframe cadence, or when tracking went back), else None."""
        if idx % self.mc.keyframe_every == 0 or self.tracking_back:
            return self.seeds.next()
        return None

    # -- hooks of the overlapped driver (engine/overlap.py) -------------
    def _writeback_ba_pose(self, idx: int, pose7: torch.Tensor) -> None:
        """Record the BA-refined current-frame pose in the trajectory (the
        overlapped driver defers this fetch)."""
        self.est_c2w[idx] = fetch(torch.Tensor.cpu,
                                  pose_lib.cam_pose_to_matrix(
                                      pose7[None])[0]).numpy()

    def _finish_loss(self, loss: torch.Tensor):
        """The mapping phase's loss as a float (the overlapped driver
        defers the fetch and returns the tensor)."""
        self.last_map_loss = fetch(float, loss)
        return self.last_map_loss

    def _tracking_params(self):
        """The scene the tracker optimises against (the overlapped driver's
        is a snapshot that lags by up to a mapping cadence)."""
        return self.params

    def replica_state(self) -> Dict[str, Any]:
        """What every rank of a data-parallel run holds alike: the scene
        (the full, gathered tables), the keyframe bank, the trajectory and
        the last mapping phase's optimiser state of the replicated leaves
        (a row block's state is its rank's own).
        `parallel.sharding.assert_replicas_agree` compares it."""
        adam = {}
        if self.map_opt is not None:
            opt, blocks = self.map_opt
            for i, o in enumerate(getattr(opt, "opts", (opt,))):
                for j, g in enumerate(o.param_groups):
                    for n, p in enumerate(g["params"]):
                        if id(p) not in blocks:
                            adam[f"{i}/{j}/{n}"] = dict(o.state.get(p, {}))
        return {"params": self.params, "bank": self.bank, "adam": adam,
                "est_c2w": torch.as_tensor(self.est_c2w),
                "kf_is_cadence": torch.as_tensor(self.kf_is_cadence),
                "host": torch.tensor([self.bank.count, self.mapping_cnt,
                                      self.t_iters, self.m_iters,
                                      int(self.tracking_back), self.lc_cnt])}

    # ------------------------------------------------------------------
    def _evict_slot(self) -> int:
        """The bank slot to recycle when full: the oldest tracking-back
        extra if any, else the oldest cadence keyframe after the slot-0
        anchor."""
        count = self.kf_count
        extras = np.nonzero(~self.kf_is_cadence[:count])[0]
        if len(extras):
            return int(extras[0])
        return 1 if count > 1 else 0

    def maybe_add_keyframe(self, idx: int, depth_img, color_img,
                           gt_c2w: np.ndarray):
        """Add a keyframe on cadence / tracking-back (evicting when full)."""
        with span("keyframes"):
            seed = self._keyframe_seed(idx)
            if seed is None:
                return
            if self.kf_count >= self.max_kf:
                slot = self._evict_slot()
                kf_lib.evict_keyframe(self.bank, slot)
                self.kf_is_cadence[slot:-1] = self.kf_is_cadence[slot + 1:]
                if not self._evict_warned:
                    print(f"[keyframes] bank full ({self.max_kf} slots) at "
                          f"frame {idx}: evicting (oldest-extra-first "
                          "policy). Raise max_kf headroom if this recurs.")
                    self._evict_warned = True
            kf_lib.add_keyframe(
                self.bank, depth_img, color_img, self.cam_rays_d,
                self._c2w(idx),
                fetch(torch.as_tensor, gt_c2w, device=self.device),
                idx, rng.generator(seed, self.device))
            self.kf_is_cadence[self.kf_count - 1] = (
                idx % self.mc.keyframe_every == 0)

    # ------------------------------------------------------------------
    def step_frame(self, idx: int) -> bool:
        """Process one frame end to end (track -> map -> keyframe)."""
        with profiling.installed(self.stats, self.iters_run):
            return self._step_frame(idx)

    def _step_frame(self, idx: int) -> bool:
        if self.stats is not None:
            self.stats.begin_frame(idx)
        with span("frame_fetch"):
            color, depth, gt_c2w = self._frame(idx)
        self.gt_c2w[idx] = gt_c2w

        if idx == 0 or self.tc.gt_camera:
            self.est_c2w[idx] = gt_c2w
        else:
            # track_frame fetches scalars, so the phase time is complete
            with span("tracking"):
                self.est_c2w[idx] = self.track_frame(idx, depth, color)
            if self.stats is not None:
                self.stats.add_rays("tracking",
                                    self.last_track_iters * self.tc.pixels)

        mapped = False
        if idx % self.mc.every_frame == 0 or self.tracking_back or \
                idx == self.n_img - 1:
            iters = self.mc.iters_first if self.init_phase else self.m_iters
            with span("mapping", rays=iters * (self.mc.pixels
                                               + self.mc.extra_rays)):
                self.map_frame(idx, depth, color)
            self.maybe_add_keyframe(idx, depth, color, gt_c2w)
            mapped = True
            if self.on_mapping_done is not None:
                with span("hooks"):
                    self.on_mapping_done(self, idx)
        if self.on_frame_done is not None:
            # hook time (vis, ATE plots, live feed, checkpoints, meshes) is
            # charged to a phase of its own
            with span("hooks"):
                self.on_frame_done(self, idx)
        if self.stats is not None:
            self.stats.end_frame(t_iters=int(self.last_track_iters),
                                 mapped=mapped, kf=self.kf_count)
        return mapped

    def run(self):
        for idx in range(self.n_img):
            self.step_frame(idx)
        return self.est_c2w

    def close(self) -> None:
        close = getattr(self._frames, "close", None)
        if close is not None:
            close()
