"""Tracking and mapping on separate devices, with a deferred sync.

Counterpart of `unislam_tpu/engine/overlap.py`. The reference overlaps
tracking and mapping as two processes over shared CUDA memory: the tracker
reads a map snapshot that lags by up to `every_frame` frames while the
mapper optimises. Two drivers here:

`OverlappedSLAM`, one process and one mapping device:

  * the scene, the keyframe bank and the mapping phases live on the
    mapping device;
  * tracking runs on `track_device` against a snapshot of the scene: a
    copy queued with `non_blocking=True` right after each mapping phase,
    adopted once a CUDA event recorded after the copy reports that it is
    done (on the CPU it is done at once);
  * the mapping loss and the BA pose write-back are deferred to the next
    `map_frame`, and `sync()` lands them, so the host never waits for a
    mapping phase to finish.

`DistributedOverlappedSLAM`, a ray-sharded mapping side (JAX's mapping
sub-mesh). PyTorch's data parallelism is one process a device, so the
run is N >= 2 ranks of a process group (`parallel/distributed.py`,
`overlap_groups`): rank 0 tracks, against all of a frame's rays; ranks
1..N-1 map, each mapping batch split over their own group as
`parallel.data_parallel` splits it (`parallel.shard_tables` row-shards the
tables over that group only). Every rank runs the same host schedule
(`UniSLAM.step_frame`: cadence, activated mapping, tracking-back, keyframe
policy) and draws the same seeds; each does only its own work:

  * the tracking rank tracks each frame against the newest snapshot whose
    transfer has finished (polled, never waited for), and sends the
    frame's record (pose, uncertainty, the decisions it took) to every
    rank without waiting; at a mapping frame `sync()` waits for the
    previous phase's reply (its loss, its BA pose, its snapshot) and
    posts the receives for this phase's;
  * the mapping ranks receive each record, map on mapping frames, keep
    the keyframe bank and the trajectory, and after a phase the group's
    rank 0 (global rank 1) starts the reply's broadcast to rank 0 and
    goes on;
  * each tracked frame records the mapping phase whose snapshot it
    tracked against (`snapshot_phase`, 0 = the initial scene) and how many
    phases had started by then (`snapshot_age` is their difference, at
    most 1).

Scheduling (cadence, activated mapping, iteration doubling, loop closure,
keyframe policy) is the sequential driver's in both.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from unislam_tpu_torch import resolve_device
from unislam_tpu_torch.core import pose as pose_lib
from unislam_tpu_torch.engine import tracker as tracker_lib
from unislam_tpu_torch.engine.slam import UniSLAM
from unislam_tpu_torch.parallel import distributed as pdist
from unislam_tpu_torch.parallel.sharding import tensor_leaves


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
            raise ValueError(
                f"OverlappedSLAM maps on one device, got {len(map_devs)}: a "
                "ray-sharded mapping side is one process a device. Start "
                "one process a device with UNISLAM_COORDINATOR (host:port "
                "of rank 0), UNISLAM_NUM_PROCESSES and UNISLAM_PROCESS_ID "
                "set and parallel.overlap: true (python -m "
                "unislam_tpu_torch.run <config>): rank 0 tracks, the "
                "others map (DistributedOverlappedSLAM)")
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


# ---------------------------------------------------------------------------
# the multi-process driver

# a segment of the snapshot buffer starts at a multiple of this (the
# kernels' vector loads want aligned tables)
_ALIGN = 256
# a tracked frame's record (float64, exact for the f32 pose and the
# counts): idx, the 4x4 pose, tracking weight, additional-map record,
# t_iters, m_iters, tracking_back, last_track_iters
_RECORD = 23
# a mapping phase's reply after its snapshot (float32): loss, has-BA, the
# BA frame, its 4x4 pose
_REPLY = 19


def _meta(tree):
    """`tree`'s structure, dtypes and shapes, without its storage."""
    return {k: (_meta(v) if isinstance(v, dict) else
                torch.empty(v.shape, dtype=v.dtype, device="meta"))
            for k, v in tree.items()}


def _segment(t: torch.Tensor) -> int:
    return -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN


def packed_bytes(tree) -> int:
    """The size of `tree` packed by `pack` (bytes)."""
    return sum(_segment(t) for _, t in tensor_leaves(tree))


def pack(tree, out: torch.Tensor) -> torch.Tensor:
    """Copy every tensor of `tree` (nested dicts), bit for bit, into the
    uint8 buffer `out` (one aligned segment a leaf, in `tensor_leaves`'
    order); returns `out`."""
    off = 0
    for _, t in tensor_leaves(tree):
        n = t.numel() * t.element_size()
        out[off:off + n].copy_(t.detach().reshape(-1).view(torch.uint8))
        off += _segment(t)
    return out


def unpack(buf: torch.Tensor, like) -> Dict[str, Any]:
    """The tree of `like`'s structure, dtypes and shapes whose tensors are
    views into `buf` (as `pack` lays them out)."""
    out: Dict[str, Any] = {}
    off = 0
    for path, t in tensor_leaves(like):
        n = t.numel() * t.element_size()
        *keys, leaf = path.split("/")[1:]
        d = out
        for k in keys:
            d = d.setdefault(k, {})
        d[leaf] = buf[off:off + n].view(t.dtype).view(t.shape)
        off += _segment(t)
    return out


class DistributedOverlappedSLAM(UniSLAM):
    """The overlapped driver over the ranks of a process group of N >= 2
    (see the module note): rank 0 tracks on its device, ranks 1..N-1 map
    data-parallel over their own group. Every rank constructs it and runs
    `step_frame` over the same frames. `device` as `UniSLAM`'s (a CUDA
    device without an index is the rank's card)."""

    def __init__(self, cfg: Dict[str, Any], dataset, seed: int = 0,
                 device=None):
        groups = pdist.overlap_groups()
        if groups is None:
            raise ValueError("DistributedOverlappedSLAM needs a process "
                             "group of >= 2 ranks (parallel/distributed.py)")
        self.groups = groups
        self.role = "track" if groups.rank == 0 else "map"
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = pdist.rank_device()
        super().__init__(cfg, dataset, seed=seed, device=dev)
        # every rank starts from the mapping side's initial scene
        with torch.no_grad():
            for _, t in tensor_leaves(self.params):
                dist.broadcast(t, 1)
        self.writer = self.role == "map" and self.rank == 0
        # each rank's device, for the runtime's INFO line
        self.rank_devices = [None] * groups.world
        dist.all_gather_object(self.rank_devices, str(self.device),
                               group=groups.records)
        self.snapshot_phase = np.full(self.n_img, -1, dtype=np.int64)
        self.snapshot_age = np.full(self.n_img, -1, dtype=np.int64)
        self._pending_ba = None        # mapping: (idx, 4x4 on the device)
        self._pending_loss = None      # mapping: the loss on the device
        # the reply's layout: the scene's leaves, then the reply's floats
        self._reply_like = {
            "params": _meta(self.params),
            "reply": torch.empty(_REPLY, device="meta")}
        n = packed_bytes(self._reply_like)
        self._send = None              # rank 1: the reply's work
        self._records = []             # rank 0: record sends in flight
        self._recv = None              # rank 0: (work, buffer, phase)
        self._reply = None             # rank 0: the adopted reply's tail
        if self.role == "track":
            # the snapshot the tracker reads, and the spare a transfer
            # writes into: never the same buffer
            self._live = torch.empty(n, dtype=torch.uint8, device=dev)
            self._spare = torch.empty_like(self._live)
            self.refresh_snapshot()
        elif groups.rank == 1:
            self._send_buf = torch.empty(n, dtype=torch.uint8, device=dev)

    def _ray_group(self, par):
        return self.groups.map

    # -- the tracking rank ---------------------------------------------
    def _tracking_params(self):
        # adopt the newest snapshot whose transfer has finished, never
        # waiting for one, but for the first: the untrained initial scene
        # is no map to track against (the reference's tracker waits for
        # the first mapped frame too)
        if self._recv is not None and (self._snapshot == 0
                                       or self._recv[0].is_completed()):
            self._adopt()
        return self.params

    def _adopt(self) -> None:
        work, buf, phase = self._recv
        self._recv = None
        work.wait()   # the copy into `buf` comes before later device work
        self._live, self._spare = buf, self._live
        tree = unpack(buf, self._reply_like)
        self.params, self._reply = tree["params"], tree["reply"]
        self._snapshot = phase

    def sync(self) -> None:
        """The tracking rank: wait for the last mapping phase's reply and
        land its loss, its BA pose and its snapshot. A mapping rank: land
        its own deferred loss and BA pose."""
        if self.role == "map":
            if self._pending_ba is not None:
                idx, c2w = self._pending_ba
                self.est_c2w[idx] = c2w.cpu().numpy()
                self._pending_ba = None
            if self._pending_loss is not None:
                self.last_map_loss = float(self._pending_loss)
                self._pending_loss = None
            return
        if self._recv is not None:
            self._adopt()
        if self._reply is not None:
            r = self._reply.cpu().numpy()
            self._reply = None
            self.last_map_loss = float(r[0])
            if r[1]:
                self.est_c2w[int(r[2])] = r[3:].reshape(4, 4)

    def refresh_snapshot(self) -> None:
        """The tracking rank takes its snapshot anew from `params` (after
        the scene was replaced, as a checkpoint resume replaces it)."""
        if self.role != "track":
            return
        pack({"params": self.params}, self._live)
        self.params = unpack(self._live, self._reply_like)["params"]
        self._snapshot = self.mapping_cnt
        self._recv = self._reply = None

    def track_frame(self, idx: int, depth_img, color_img) -> np.ndarray:
        if self.role == "map":
            return self._receive_record(idx)
        c2w = super().track_frame(idx, depth_img, color_img)
        self.snapshot_phase[idx] = self._snapshot
        self.snapshot_age[idx] = self.mapping_cnt - self._snapshot
        rec = torch.tensor(
            [idx, *c2w.reshape(-1).tolist(),
             float(self.tracking_weights[idx]),
             int(self.additional_map_records[idx]), int(self.t_iters),
             int(self.m_iters), int(self.tracking_back),
             int(self.last_track_iters)], dtype=torch.float64)
        self._records = [(w, t) for w, t in self._records
                         if not w.is_completed()]
        self._records.append((dist.broadcast(
            rec, 0, group=self.groups.records, async_op=True), rec))
        return c2w

    def map_frame(self, idx: int, depth_img, color_img):
        if self.role == "map":
            self.sync()   # the previous phase's loss and BA pose
            loss = super().map_frame(idx, depth_img, color_img)
            if self.groups.rank == 1:
                self._send_reply(idx)
            return loss
        self.sync()   # the previous phase's reply lands here
        self._phase_seeds()   # drawn and dropped, in step with the mappers
        self.mapping_cnt += 1
        self.init_phase = False
        work = dist.broadcast(self._spare, 1, group=self.groups.snapshot,
                              async_op=True)
        self._recv = (work, self._spare, self.mapping_cnt)
        return None

    def maybe_add_keyframe(self, idx: int, depth_img, color_img,
                           gt_c2w: np.ndarray):
        if self.role == "map":
            return super().maybe_add_keyframe(idx, depth_img, color_img,
                                              gt_c2w)
        # the tracking rank keeps the bank's count and the draw in step
        if self._keyframe_seed(idx) is not None:
            self.bank.count = min(self.bank.count + 1, self.max_kf)

    # -- the mapping ranks -----------------------------------------------
    def _receive_record(self, idx: int) -> np.ndarray:
        self.seeds.next()   # the tracking rank's draw for this frame
        rec = torch.empty(_RECORD, dtype=torch.float64)
        dist.broadcast(rec, 0, group=self.groups.records)
        r = rec.numpy()
        if int(r[0]) != idx:
            raise RuntimeError(f"rank {self.groups.rank}: the record of "
                               f"frame {int(r[0])} came at frame {idx}")
        self.tracking_weights[idx] = r[17]
        self.additional_map_records[idx] = int(r[18])
        self.t_iters, self.m_iters = int(r[19]), int(r[20])
        self.tracking_back = bool(r[21])
        self.last_track_iters = int(r[22])
        return r[1:17].reshape(4, 4).astype(np.float32)

    def _writeback_ba_pose(self, idx: int, pose7: torch.Tensor) -> None:
        self._pending_ba = (idx, pose_lib.cam_pose_to_matrix(pose7[None])[0])

    def _finish_loss(self, loss: torch.Tensor):
        self._pending_loss = loss
        return loss   # a device scalar; fetched at the next sync

    def _send_reply(self, idx: int) -> None:
        """Start the phase's reply to the tracking rank: the scene, the
        loss and the BA pose, packed into one buffer, broadcast without
        waiting."""
        if self._send is not None:
            self._send.wait()   # the last reply left long ago
        reply = torch.zeros(_REPLY, device=self.device)
        reply[0] = self._pending_loss.detach()
        if self._pending_ba is not None:
            reply[1], reply[2] = 1.0, float(self._pending_ba[0])
            reply[3:] = self._pending_ba[1].reshape(-1)
        pack({"params": self.params, "reply": reply}, self._send_buf)
        self._send = dist.broadcast(self._send_buf, 1,
                                    group=self.groups.snapshot,
                                    async_op=True)

    # ------------------------------------------------------------------
    def run(self):
        out = super().run()
        self.sync()
        return out

    def close(self) -> None:
        """Wait for every transfer this rank started, then close."""
        for w, _ in self._records:
            w.wait()
        self._records = []
        if self._send is not None:
            self._send.wait()
            self._send = None
        if self._recv is not None:
            self._adopt()
        super().close()
