"""Tracking and mapping on separate devices, with a deferred sync.

Counterpart of `unislam_tpu/engine/overlap.py`. The reference overlaps
tracking and mapping as two processes over shared CUDA memory: the tracker
reads a map snapshot that lags by up to `every_frame` frames while the
mapper optimises. Here one host process queues both on their devices:

  * the scene, the keyframe bank and the mapping phases live on the
    mapping device;
  * tracking runs on `track_device` against a snapshot of the scene: a
    copy queued with `non_blocking=True` right after each mapping phase,
    adopted once a CUDA event recorded after the copy reports that it is
    done (on the CPU it is done at once);
  * the mapping loss and the BA pose write-back are deferred to the next
    `map_frame`, and `sync()` lands them, so the host never waits for a
    mapping phase to finish.

Scheduling (cadence, activated mapping, iteration doubling, loop closure,
keyframe policy) is the sequential driver's.

Not ported: a mapping side of several devices (JAX's ray-sharded mapping
sub-mesh inside one process). PyTorch's data parallelism is one process a
device, so this raises `NotImplementedError` for more than one mapping
device (ROADMAP.md §1).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from unislam_tpu_torch.engine import tracker as tracker_lib
from unislam_tpu_torch.engine.slam import UniSLAM


def _copy(tree, device):
    """A copy of every tensor of the scene on `device` (a copy even on the
    same device: the mapper steps its leaves in place), queued without
    waiting."""
    if isinstance(tree, dict):
        return {k: _copy(v, device) for k, v in tree.items()}
    return torch.empty_like(tree, device=device).copy_(tree,
                                                       non_blocking=True)


class OverlappedSLAM(UniSLAM):
    """UniSLAM with tracking on `track_device` and mapping on
    `map_devices` (one device). Without devices given it takes the first
    two CUDA devices, and needs two."""

    def __init__(self, cfg: Dict[str, Any], dataset, seed: int = 0,
                 track_device=None, map_devices=None):
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        if track_device is None and map_devices is None and len(devs) < 2:
            raise ValueError(
                f"OverlappedSLAM needs >= 2 devices, found {len(devs)}; "
                "use the sequential UniSLAM driver on one device")
        map_devs = [torch.device(d) for d in map_devices] \
            if map_devices is not None else devs[1:]
        if len(map_devs) > 1:
            raise NotImplementedError(
                "OverlappedSLAM with several mapping devices (a ray-sharded "
                "mapping side) is not ported yet (ROADMAP.md §1)")
        self.map_device = map_devs[0]
        self.track_device = torch.device(track_device) \
            if track_device is not None else devs[0]
        super().__init__(cfg, dataset, seed=seed, device=self.map_device)
        self.tracker = tracker_lib.Tracker(self.sc, self.rc_track, self.tc,
                                           self.intr, self.track_device)
        self._track_params = _copy(self.params, self.track_device)
        self._next_snapshot = None     # (scene copy, event or None)
        self._pending_ba = None
        self._pending_loss = None
        self.last_map_loss: Optional[float] = None

    # -- deferred-fetch hooks ------------------------------------------
    def _tracking_params(self):
        # adopt the newest snapshot whose copy has finished, never waiting
        if self._next_snapshot is not None:
            snap, event = self._next_snapshot
            if event is None or event.query():
                self._track_params = snap
                self._next_snapshot = None
        return self._track_params

    def _writeback_ba_pose(self, idx: int, pose7: torch.Tensor) -> None:
        self._pending_ba = (idx, pose7)

    def _finish_loss(self, loss: torch.Tensor):
        self._pending_loss = loss
        return loss   # a device scalar; fetched at the next sync

    def sync(self) -> None:
        """Land everything deferred from the last mapping phase."""
        if self._pending_ba is not None:
            idx, pose7 = self._pending_ba
            super()._writeback_ba_pose(idx, pose7)
            self._pending_ba = None
        if self._pending_loss is not None:
            self.last_map_loss = float(self._pending_loss)
            self._pending_loss = None
        if self._next_snapshot is not None:
            self._track_params = self._next_snapshot[0]
            self._next_snapshot = None

    def refresh_snapshot(self) -> None:
        """Take the tracker's snapshot anew (after the scene was replaced,
        as a checkpoint resume replaces it)."""
        self._track_params = _copy(self.params, self.track_device)
        self._next_snapshot = None

    # -- device placement -------------------------------------------------
    def track_frame(self, idx: int, depth_img, color_img) -> np.ndarray:
        d = depth_img.to(self.track_device, non_blocking=True)
        c = color_img.to(self.track_device, non_blocking=True)
        return super().track_frame(idx, d, c)

    def map_frame(self, idx: int, depth_img, color_img):
        self.sync()   # the previous phase's loss and BA pose land here
        out = super().map_frame(idx, depth_img, color_img)
        # the tracker's next snapshot: queued now, so it runs the moment
        # the phase's work ends, while the host goes on
        snap = _copy(self.params, self.track_device)
        event = None
        if self.track_device.type == "cuda":
            # recorded where the copy lands, after it
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.track_device))
        self._next_snapshot = (snap, event)
        return out

    def run(self):
        out = super().run()
        self.sync()
        return out

