"""Device-resident keyframe pixel bank (preallocated arrays).

Counterpart of `unislam_tpu/engine/keyframes.py`:

    depth   (max_kf, B)       sampled sensor depths
    color   (max_kf, B, 3)    sampled RGB
    rays_d  (max_kf, B, 3)    camera-frame ray dirs of the sampled pixels
    pose7   (max_kf, 7)       estimated c2w (quat+trans); BA updates these
    gt_c2w  (max_kf, 4, 4)    ground-truth poses (eval only)
    frame_idx (max_kf,)       source frame id, -1 = empty slot

Unlike the JAX bank, `add` writes its slot in place (no copy of the bank
per keyframe), and `count` is a host integer: the driver always knows it,
so reading it never waits for the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from unislam_tpu_torch import resolve_device
from unislam_tpu_torch.core import pose as pose_lib


@dataclass
class KeyframeBank:
    depth: torch.Tensor
    color: torch.Tensor
    rays_d: torch.Tensor
    pose7: torch.Tensor
    gt_c2w: torch.Tensor
    frame_idx: torch.Tensor
    count: int = 0

    @property
    def max_kf(self) -> int:
        return self.depth.shape[0]


def init_bank(max_kf: int, bank_size: int, device=None) -> KeyframeBank:
    """An empty bank on `device` (CUDA unless the caller asks for
    another)."""
    device = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    return KeyframeBank(
        depth=torch.zeros(max_kf, bank_size, **f32),
        color=torch.zeros(max_kf, bank_size, 3, **f32),
        rays_d=torch.zeros(max_kf, bank_size, 3, **f32),
        pose7=torch.tensor([1, 0, 0, 0, 0, 0, 0], **f32).repeat(max_kf, 1),
        gt_c2w=torch.eye(4, **f32).repeat(max_kf, 1, 1),
        frame_idx=torch.full((max_kf,), -1, dtype=torch.int64, device=device),
    )


def add_keyframe(bank: KeyframeBank, depth: torch.Tensor, color: torch.Tensor,
                 rays_d: torch.Tensor, est_c2w: torch.Tensor,
                 gt_c2w: torch.Tensor, frame_idx: int,
                 generator: Optional[torch.Generator] = None,
                 perm: Optional[torch.Tensor] = None) -> KeyframeBank:
    """Subsample a frame's pixels without replacement (a random
    permutation, or `perm` given) into the next free slot."""
    B = bank.depth.shape[1]
    if perm is None:
        perm = torch.randperm(depth.numel(), generator=generator,
                              device=depth.device)
    perm = perm[:B].to(depth.device)
    slot = min(bank.count, bank.max_kf - 1)
    bank.depth[slot] = depth.reshape(-1)[perm]
    bank.color[slot] = color.reshape(-1, 3)[perm]
    bank.rays_d[slot] = rays_d.reshape(-1, 3)[perm]
    bank.pose7[slot] = pose_lib.matrix_to_cam_pose(est_c2w[None])[0]
    bank.gt_c2w[slot] = gt_c2w
    bank.frame_idx[slot] = frame_idx
    bank.count = min(bank.count + 1, bank.max_kf)
    return bank


def evict_keyframe(bank: KeyframeBank, slot: int) -> KeyframeBank:
    """Compacting eviction: remove `slot`, shift newer keyframes down one
    (slot order stays temporal order, which window selection relies on)."""
    n = bank.max_kf
    idx = torch.arange(n, device=bank.depth.device)
    src = torch.clamp(torch.where(idx < slot, idx, idx + 1), max=n - 1)
    for name in ("depth", "color", "rays_d", "pose7", "gt_c2w", "frame_idx"):
        setattr(bank, name, getattr(bank, name)[src])
    bank.frame_idx[n - 1] = -1
    bank.count = max(bank.count - 1, 0)
    return bank
