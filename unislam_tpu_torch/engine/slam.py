"""The SLAM driver: track each frame, map every few frames, keep keyframes.

Counterpart of `unislam_tpu/engine/slam.py` `UniSLAM`: the same scheduling
(activated mapping with the mid-frame iteration doubling, tracking-back,
keyframe cadence, compacting eviction, loop-closure windows) over one scene
parameter dict and a device-resident keyframe bank. Per tracked frame the
host fetches one scalar (the penultimate iteration's mean uncertainty) and
the best pose; per mapping phase, the window selection and the final loss.

Not ported yet: multi-device execution and the overlapped tracker/mapper
driver (`parallel.data_parallel` and `parallel.overlap` raise), and the
per-iteration visualisation hooks.
"""

from __future__ import annotations

import contextlib
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
from unislam_tpu_torch.render.renderer import RenderConfig


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
        for opt in ("data_parallel", "overlap"):
            if cfg.get("parallel", {}).get(opt, False):
                raise NotImplementedError(f"parallel.{opt} is not ported "
                                          "yet")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dataset = dataset
        self.n_img = len(dataset)
        if cfg.get("data", {}).get("prefetch", True):
            from unislam_tpu_torch.data.prefetch import FramePrefetcher
            self._frames = FramePrefetcher(dataset)
        else:
            self._frames = dataset
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

        self.bank_size = max(1, int(self.intr.H * self.intr.W * 0.1))
        self.max_kf = min(self.n_img,
                          self.n_img // self.mc.keyframe_every + 65)
        self.bank = kf_lib.init_bank(self.max_kf, self.bank_size, self.device)
        # which slots hold cadence keyframes (vs tracking-back extras)
        self.kf_is_cadence = np.zeros(self.max_kf, dtype=bool)
        self._evict_warned = False

        self.tracker = tracker_lib.Tracker(self.sc, self.rc_track, self.tc,
                                           self.intr, self.device)
        self.mapper = mapper_lib.Mapper(self.sc, self.rc, self.mc, self.intr,
                                        self.max_kf, self.bank_size,
                                        self.device)
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
        self.init_phase = True
        # iterations executed over the run: tracking, mapping, and mapping
        # iterations that ran the no-depth probe
        self.iters_run = {"track": 0, "map": 0, "probe": 0}


        if cfg.get("profiling", {}).get("enabled", False):
            from unislam_tpu_torch.utils.profiling import PhaseStats
            self.stats = PhaseStats()
        else:
            self.stats = None

    @property
    def kf_count(self) -> int:
        return self.bank.count

    # ------------------------------------------------------------------
    def _frame(self, idx: int):
        color, depth, gt_c2w = self._frames[idx]
        color_t = torch.as_tensor(np.asarray(color, np.float32))
        depth_t = torch.as_tensor(np.asarray(depth, np.float32))
        if self.device.type == "cuda":
            color_t = color_t.pin_memory().to(self.device, non_blocking=True)
            depth_t = depth_t.pin_memory().to(self.device, non_blocking=True)
        return color_t, depth_t, np.asarray(gt_c2w, np.float32)

    def _c2w(self, idx: int) -> torch.Tensor:
        return torch.as_tensor(self.est_c2w[idx], device=self.device)

    # ------------------------------------------------------------------
    def track_frame(self, idx: int, depth_img, color_img) -> np.ndarray:
        """Optimise the frame's pose; returns the best 4x4 c2w."""
        if self.tc.const_speed_assumption and idx >= 2:
            pose7 = tracker_lib.init_pose_const_speed(self._c2w(idx - 1),
                                                      self._c2w(idx - 2))
        else:
            pose7 = pose_lib.matrix_to_cam_pose(self._c2w(idx - 1)[None])[0]

        pose = tracker_lib.make_pose(pose7)
        opt = tracker_lib.make_optimizer(self.tc, pose)
        seed = self.seeds.next()
        n1 = int(self.t_iters)
        self.last_track_iters = n1
        state = self.tracker.track_frame(self.params, pose, opt, depth_img,
                                         color_img, seed, n1)

        # activated mapping: checked with the PENULTIMATE iteration's
        # uncertainty. A first fire (the frame ran the base count) extends
        # the current frame 8 -> 16 with the draw schedule intact, and the
        # trigger is checked again at the new penultimate iteration, which
        # decides tracking-back and the doubled counts for what follows.
        if idx > 0:
            mean_unc = float(state.unc_prev)
            triggered = (self.tc.activated_mapping_mode
                         and mean_unc > self.tc.uncertainty_ts)
            if triggered and n1 == self.tc.iters:
                self.additional_map_records[idx] = 1
                self.last_track_iters = n1 + self.tc.iters
                state = self.tracker.track_frame(
                    self.params, pose, opt, depth_img, color_img, seed,
                    self.tc.iters, iter0=n1, carry=state)
                mean_unc = float(state.unc_prev)
                triggered = mean_unc > self.tc.uncertainty_ts
            self.tracking_weights[idx] = mean_unc
            if triggered:
                self.t_iters = self.tc.iters * 2
                self.m_iters = self.mc.iters * 2
                self.tracking_back = True
                self.additional_map_records[idx] = 1
            else:
                self.t_iters = self.tc.iters
                self.m_iters = self.mc.iters
                self.tracking_back = False
        self.iters_run["track"] += self.last_track_iters
        return pose_lib.cam_pose_to_matrix(state.best7[None])[0].cpu().numpy()

    # ------------------------------------------------------------------
    def map_frame(self, idx: int, depth_img, color_img) -> float:
        """One mapping phase over the keyframe window + current frame."""
        count = self.kf_count
        cur_c2w = self._c2w(idx)
        cur_pose7 = pose_lib.matrix_to_cam_pose(cur_c2w[None])[0]

        if count > 2:
            res = self.select_fn(self.bank, depth_img, color_img, cur_c2w,
                                 idx, rng.generator(self.seeds.next(),
                                                    self.device))
            if self.tracking_back and self.tc.activated_mapping_mode:
                sel_mask = res.back_mask.cpu().numpy()
            elif bool(res.lc_flag):
                sel_mask = res.lc_mask.cpu().numpy()
                self.lc_cnt += 1
                if self.verbose:
                    print(f"[LC] loop closure at frame {idx}")
            else:
                sel_mask = res.normal_mask.cpu().numpy()
        else:
            sel_mask = np.zeros(self.max_kf, dtype=bool)

        probs, extra = selection_lib.window_probs(self.max_kf, count, sel_mask)

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
        probe = bool((depth_img <= 0).any()
                     or (count > 0 and (self.bank.depth[:count] <= 0).any()))

        dev = self.device
        batch = mapper_lib.MapBatch(
            self.bank, depth_img, color_img, self.cam_rays_d,
            torch.as_tensor(probs, dtype=torch.float32, device=dev),
            torch.as_tensor(extra, dtype=torch.float32, device=dev),
            torch.as_tensor(pose_grad_mask, device=dev), probe)
        scene, poses = mapper_lib.trainable(
            self.params, torch.cat([self.bank.pose7, cur_pose7[None]]))
        first = self.init_phase
        iters = int(self.mc.iters_first if first else self.m_iters)
        lr_scale = self.mc.lr_first_factor if first else self.mc.lr_factor
        opt = mapper_lib.make_optimizer(self.mc, scene, poses, lr_scale)
        loss = self.mapper.map_phase(scene, poses, opt, batch,
                                     self.seeds.next(), iters)

        self.params = mapper_lib.frozen(scene)
        if joint_opt:
            poses = poses.detach()
            self.bank.pose7 = poses[:self.max_kf].clone()
            self.est_c2w[idx] = pose_lib.cam_pose_to_matrix(
                poses[self.max_kf][None])[0].cpu().numpy()
        self.mapping_cnt += 1
        self.init_phase = False
        self.iters_run["map"] += iters
        self.iters_run["probe"] += iters if probe else 0
        return float(loss)

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
        if idx % self.mc.keyframe_every == 0 or self.tracking_back:
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
                self._c2w(idx), torch.as_tensor(gt_c2w, device=self.device),
                idx, rng.generator(self.seeds.next(), self.device))
            self.kf_is_cadence[self.kf_count - 1] = (
                idx % self.mc.keyframe_every == 0)

    # ------------------------------------------------------------------
    def _phase(self, name: str, rays: int = 0):
        if self.stats is None:
            return contextlib.nullcontext()
        return self.stats.phase(name, rays=rays)

    def step_frame(self, idx: int) -> bool:
        """Process one frame end to end (track -> map -> keyframe)."""
        if self.stats is not None:
            self.stats.begin_frame(idx)
        with self._phase("frame_fetch"):
            color, depth, gt_c2w = self._frame(idx)
        self.gt_c2w[idx] = gt_c2w

        if idx == 0 or self.tc.gt_camera:
            self.est_c2w[idx] = gt_c2w
        else:
            # track_frame fetches scalars, so the phase time is complete
            with self._phase("tracking"):
                self.est_c2w[idx] = self.track_frame(idx, depth, color)
            if self.stats is not None:
                self.stats.add_rays("tracking",
                                    self.last_track_iters * self.tc.pixels)

        mapped = False
        if idx % self.mc.every_frame == 0 or self.tracking_back or \
                idx == self.n_img - 1:
            iters = self.mc.iters_first if self.init_phase else self.m_iters
            with self._phase("mapping",
                             rays=iters * (self.mc.pixels
                                           + self.mc.extra_rays)):
                self.map_frame(idx, depth, color)
            self.maybe_add_keyframe(idx, depth, color, gt_c2w)
            mapped = True
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
