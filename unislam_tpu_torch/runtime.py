"""Full-system runtime: dataset + SLAM core + logging/meshing/eval/vis.

Counterpart of `unislam_tpu/runtime.py`. The SLAM core
(`engine/slam.py`) stays free of file IO; this wrapper attaches the side
subsystems through its hooks: periodic ATE plots and the live state feed
after each frame; checkpoints, periodic meshes and mapping panels after
each mapping phase; at the last frame the final rendering evaluation, the
final mesh and its culled copy.

Besides the JAX runtime's files it writes `runtime_stats.json` at the end:
wall seconds per runtime phase (the frame loop, rendering evaluation,
meshing by pass, culling), the kernel launches each made (counted on the
card only), `render_img` seconds per image, the frame it started at, how
often the frame loop read each frame, and the process's peak host memory.

With `parallel.overlap` the loop is, in a process group of two or more
ranks, `engine/overlap.DistributedOverlappedSLAM` (rank 0 tracks, the
others map data-parallel over their own group); else
`engine/overlap.OverlappedSLAM` (tracking and mapping on two devices of
this process) when two or more CUDA devices are visible, else the
sequential `UniSLAM` with an `INFO:` line, as the JAX runtime does. With
`parallel.data_parallel` over several ranks every rank runs the loop. One
process writes (`UniSLAM.writer`: rank 0 of a data-parallel run, the
mapping side's first rank of an overlapped one): checkpoints, meshes, the
visualisation panels, `live.json`, the evaluation and
`runtime_stats.json`.
"""

from __future__ import annotations

import json
import os
import resource
import time
from typing import Optional

from unislam_tpu_torch.data.datasets import get_dataset
from unislam_tpu_torch.engine.slam import UniSLAM
from unislam_tpu_torch.kernels import build
from unislam_tpu_torch.parallel import distributed as pdist
from unislam_tpu_torch.tools import eval_ate
from unislam_tpu_torch.utils.logger import Logger, latest_checkpoint, load_into
from unislam_tpu_torch.utils.mesher import Mesher
from unislam_tpu_torch.utils.visualizer import FrameVisualizer


class SLAMRuntime:
    def __init__(self, cfg, input_folder: Optional[str] = None,
                 output: Optional[str] = None, n_frames: Optional[int] = None,
                 dataset=None, seed: int = 0, device=None):
        self.cfg = cfg
        self.output = output or cfg["data"]["output"]
        os.makedirs(self.output, exist_ok=True)
        os.makedirs(os.path.join(self.output, "ckpts"), exist_ok=True)
        os.makedirs(os.path.join(self.output, "mesh"), exist_ok=True)

        if dataset is None:
            dataset = get_dataset(cfg, input_folder, cfg.get("scale", 1))
        if n_frames is not None:
            dataset = _Truncated(dataset, n_frames)
        self.dataset = dataset

        if cfg.get("parallel", {}).get("overlap", False):
            import torch
            world = pdist.global_ray_group()
            if world is not None and world.size >= 2:
                from unislam_tpu_torch.engine.overlap import \
                    DistributedOverlappedSLAM
                self.slam = DistributedOverlappedSLAM(cfg, dataset,
                                                      seed=seed,
                                                      device=device)
                devs = self.slam.rank_devices
                print(f"INFO: overlapped driver — tracking on rank 0 "
                      f"({devs[0]}), mapping on ranks 1..{len(devs) - 1} "
                      f"({', '.join(devs[1:])})")
            elif torch.cuda.device_count() >= 2:
                from unislam_tpu_torch.engine.overlap import OverlappedSLAM
                self.slam = OverlappedSLAM(cfg, dataset, seed=seed)
                print(f"INFO: overlapped driver — tracking on "
                      f"{self.slam.track_device}, mapping on "
                      f"{self.slam.map_device}")
            else:
                print("INFO: parallel.overlap requested but only one device "
                      "is visible; using the sequential driver")
                self.slam = UniSLAM(cfg, dataset, seed=seed, device=device)
        else:
            self.slam = UniSLAM(cfg, dataset, seed=seed, device=device)
        # one writer (every rank runs the loop)
        self.writer = self.slam.writer
        self.logger = Logger(self.slam, os.path.join(self.output, "ckpts"))
        self.mesher = Mesher(cfg, self.slam.sc, self.slam.intr)

        t, m = cfg["tracking"], cfg["mapping"]
        self.track_vis = FrameVisualizer(
            t.get("vis_freq", 50), os.path.join(self.output, "tracking_vis"),
            self.slam.sc, self.slam.rc, self.slam.intr)
        self.map_vis = FrameVisualizer(
            m.get("vis_freq", 50), os.path.join(self.output, "mapping_vis"),
            self.slam.sc, self.slam.rc, self.slam.intr)
        # per-iteration visualisation (vis_inside_freq; 0/absent disables)
        if self.writer and int(t.get("vis_inside_freq", 0)) > 0:
            self.slam.tracking_iter_vis = _InsideVis(
                self.track_vis.freq, int(t["vis_inside_freq"]),
                self._tracking_iter_panel)
        if self.writer and int(m.get("vis_inside_freq", 0)) > 0:
            self.slam.mapping_iter_vis = _InsideVis(
                self.map_vis.freq, int(m["vis_inside_freq"]),
                self._mapping_iter_panel)
        self.vis_pose_freq = t.get("vis_pose_freq", 100)
        self.mesh_freq = m.get("mesh_freq", 100000)
        # live state feed every N frames, 0 disables (mesh snapshots still
        # follow mesh_freq)
        self.live_freq = cfg.get("live_freq", 1)
        self.ckpt_freq = m.get("ckpt_freq", 500)
        self.eval_rec = cfg["meshing"].get("eval_rec", False)
        self._start_idx = 0
        self._vis_frame_cache = None
        self._t_run = time.perf_counter()
        self.stats = {"phases_s": {}, "launches": {}, "meshes": []}

        self.slam.on_frame_done = self._on_frame_done
        self.slam.on_mapping_done = self._on_mapping_done

        print(f"INFO: The output folder is {self.output}")
        print(f"INFO: tracking/mapping visualizations under "
              f"{self.output}/tracking_vis and {self.output}/mapping_vis")
        print(f"INFO: meshes under {self.output}/mesh, checkpoints under "
              f"{self.output}/ckpts")

    def resume(self):
        path = latest_checkpoint(os.path.join(self.output, "ckpts"))
        if path is None:
            print("INFO: no checkpoint found; starting fresh")
            return
        self._start_idx = load_into(self.slam, path)
        getattr(self.slam, "refresh_snapshot", lambda: None)()
        print(f"INFO: resumed from {path} at frame {self._start_idx}")

    # ------------------------------------------------------------------
    def _timed(self, name: str, fn, *args, **kwargs):
        """Run fn, adding its wall seconds and kernel launches to the
        phase `name` of `stats`. Returns fn's result and its launches."""
        before = dict(build.LAUNCHES)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        ph = self.stats["phases_s"]
        ph[name] = ph.get(name, 0.0) + dt
        launched = {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()
                    if v != before.get(k, 0)}
        la = self.stats["launches"].setdefault(name, {})
        for k, v in launched.items():
            la[k] = la.get(k, 0) + v
        return out, launched

    def _mesh(self, path: str, slam):
        out, launched = self._timed("mesh", self.mesher.get_mesh, path,
                                    slam.params, slam.bank, verbose=True)
        self.stats["meshes"].append(dict(
            self.mesher.stats, file=os.path.basename(path),
            launches=launched))
        return out

    # ------------------------------------------------------------------
    def _frame_for_vis(self, idx: int):
        """Decode-once cache for the per-iteration vis callbacks (several
        fire per frame)."""
        if self._vis_frame_cache is None or self._vis_frame_cache[0] != idx:
            color, depth, _ = self.dataset[idx]
            self._vis_frame_cache = (idx, color, depth)
        return self._vis_frame_cache[1], self._vis_frame_cache[2]

    def _tracking_iter_panel(self, slam: UniSLAM, idx: int, it: int, pose7):
        """Full diagnostic panel at the pose the iteration starts from."""
        from unislam_tpu_torch.core import pose as pose_lib
        color, depth = self._frame_for_vis(idx)
        c2w = pose_lib.cam_pose_to_matrix(pose7[None])[0].cpu().numpy()
        self.track_vis.save_imgs(idx, it, depth, color, c2w, slam.params)

    def _mapping_iter_panel(self, slam: UniSLAM, idx: int, it: int, state):
        """Render of the frame being mapped, with the mid-optimisation
        scene and BA pose."""
        from unislam_tpu_torch.core import pose as pose_lib
        color, depth = self._frame_for_vis(idx)
        cur7 = state["poses"][-1].detach()
        c2w = pose_lib.cam_pose_to_matrix(cur7[None])[0].cpu().numpy()
        self.map_vis.save_mapping_imgs(idx, it, color, c2w, state["scene"],
                                       gt_depth=depth)

    # ------------------------------------------------------------------
    def _on_frame_done(self, slam: UniSLAM, idx: int):
        if not self.writer:
            return
        n = slam.n_img
        if idx > 0 and (idx % self.vis_pose_freq == 0 or idx == n - 1):
            # the overlapped driver defers BA pose write-backs; land them
            # before reading the trajectory
            getattr(slam, "sync", lambda: None)()
            plot_path = os.path.join(self.output, "pose_vis",
                                     f"pose_{idx}.png")
            _, results = eval_ate.pose_evaluation(
                slam.gt_c2w[:idx + 1], slam.est_c2w[:idx + 1],
                slam.tracking_weights[:idx + 1], plot_path,
                scale=self.cfg.get("scale", 1),
                pose_alignment=self.cfg["tracking"].get("pose_alignment",
                                                        False))
            if idx == n - 1:
                with open(os.path.join(self.output, "output.txt"), "a") as f:
                    f.write(json.dumps(results) + "\n")
                    f.write(f"normal mapping frames: "
                            f"{n / slam.mc.every_frame}\n")
                    f.write(f"total mapping frames: {slam.mapping_cnt}\n")
                    f.write(f"total LC: {slam.lc_cnt}\n")
                eval_ate.vis_unc_mapstep(slam.tracking_weights,
                                         slam.additional_map_records,
                                         self.output)
        if idx > 0 and idx % self.track_vis.freq == 0:
            color, depth, _ = self.dataset[idx]
            self.track_vis.save_imgs(idx, 0, depth, color, slam.est_c2w[idx],
                                     slam.params)
        if self.live_freq and (idx % self.live_freq == 0 or idx == n - 1):
            from unislam_tpu_torch.utils import playback
            playback.write_live_state(
                self.output, idx, n, slam.est_c2w, slam.gt_c2w,
                mesh_dir=os.path.join(self.output, "mesh"))
            if slam.stats is not None and slam.stats.frames:
                # the per-frame series, refreshed while the run goes on
                slam.stats.dump_frames(
                    os.path.join(self.output, "frame_times.json"))

    def _on_mapping_done(self, slam: UniSLAM, idx: int):
        if not self.writer:
            return
        n = slam.n_img
        if (idx % self.ckpt_freq == 0 and idx > 0) or idx == n - 1:
            self._timed("checkpoint", self.logger.log, idx)
        if idx % self.mesh_freq == 0 and idx > 0:
            self._mesh(os.path.join(self.output, "mesh",
                                    f"{idx:05d}_mesh.ply"), slam)
        if idx > 0 and idx % self.map_vis.freq == 0:
            color, depth, _ = self.dataset[idx]
            self.map_vis.save_imgs(idx, 0, depth, color, slam.est_c2w[idx],
                                   slam.params)
        if idx == n - 1:
            self._finalize()

    def _finalize(self):
        from unislam_tpu_torch.tools.cull_mesh import cull_mesh
        from unislam_tpu_torch.tools.eval_recon import eval_rendering

        slam = self.slam
        self.stats["phases_s"]["frames"] = time.perf_counter() - self._t_run
        if slam.stats is not None:
            print(slam.stats.summary())
            with open(os.path.join(self.output, "output.txt"), "a") as f:
                f.write(json.dumps({"profile": slam.stats.report()}) + "\n")
            if slam.stats.frames:
                slam.stats.dump_frames(
                    os.path.join(self.output, "frame_times.json"))
        render = {}
        self._timed("eval_rendering", eval_rendering, slam, self.output,
                    timings=render)
        self.stats["render_img"] = render
        name = ("final_mesh_eval_rec.ply" if self.eval_rec
                else "final_mesh.ply")
        out = self._mesh(os.path.join(self.output, "mesh", name), slam)
        if out is not None:
            self._timed("cull", cull_mesh, out, self.cfg, slam.intr,
                        frames=self.dataset, estimate_c2w_list=slam.est_c2w,
                        eval_rec=self.eval_rec)

    # ------------------------------------------------------------------
    def run(self):
        n = self.slam.n_img
        frames = range(self._start_idx, n)
        try:
            from tqdm import tqdm
            frames = tqdm(frames, smoothing=0.05, desc="uni-slam-torch")
        except ImportError:
            pass
        self._t_run = time.perf_counter()
        before = dict(build.LAUNCHES)
        for idx in frames:
            self.slam.step_frame(idx)
        reads = getattr(self.slam._frames, "reads", None)
        self.stats.update(
            # the process's peak resident memory (Linux reports KiB)
            host_max_rss_gb=resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1e6,
            launches_run={k: v - before.get(k, 0)
                          for k, v in build.LAUNCHES.items()},
            iters_run=dict(self.slam.iters_run),
            start_frame=self._start_idx, n_frames=n,
            # the writing process's rank in the process group
            rank=pdist.global_rank(),
            frame_reads=({"frames": len(reads),
                          "max": max(reads.values(), default=0)}
                         if reads is not None else None))
        getattr(self.slam, "sync", lambda: None)()
        self.slam.close()
        if self.writer:
            with open(os.path.join(self.output, "runtime_stats.json"),
                      "w") as f:
                json.dump(self.stats, f, indent=1)
        return self.slam.est_c2w


class _InsideVis:
    """Per-iteration visualisation policy: which frames get the callback
    inside their iteration loop, and how often it fires there."""

    def __init__(self, frame_freq: int, inside_freq: int, fn):
        self.frame_freq = max(1, frame_freq)
        self.inside_freq = max(1, inside_freq)
        self._fn = fn

    def wants(self, idx: int) -> bool:
        return idx > 0 and idx % self.frame_freq == 0

    def __call__(self, slam, idx, it, x):
        self._fn(slam, idx, it, x)


class _Truncated:
    def __init__(self, ds, n):
        self._ds = ds
        self._n = min(n, len(ds))

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        return self._ds[i]

    def __getattr__(self, name):
        return getattr(self._ds, name)
