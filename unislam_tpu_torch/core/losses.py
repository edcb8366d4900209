"""SDF / color / depth losses as weighted means with 0/1 masks.

Counterpart of `unislam_tpu/core/losses.py`; no boolean-mask indexing, so
nothing here waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over elements where mask is truthy (0 if mask empty)."""
    mask = mask.to(x.dtype)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(x * mask) / denom


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of x over masked elements; the lower middle element for even
    counts (torch.median's convention)."""
    big = torch.finfo(x.dtype).max
    vals = torch.sort(torch.where(mask, x, torch.full_like(x, big))).values
    count = torch.sum(mask.to(torch.int64))
    idx = torch.clamp(count - 1, min=0) // 2
    return vals.index_select(0, idx.reshape(1))[0]


class SdfLossWeights(NamedTuple):
    fs: float
    center: float
    tail: float


def sdf_losses(sdf: torch.Tensor, z_vals: torch.Tensor,
               gt_depth: torch.Tensor, ray_mask: torch.Tensor,
               truncation: float, w: SdfLossWeights) -> torch.Tensor:
    """Free-space / center / tail SDF supervision, each averaged over its
    own mask, then weighted-summed. sdf, z_vals (R, N); gt_depth,
    ray_mask (R,)."""
    gd = gt_depth[:, None]
    rm = ray_mask[:, None].to(torch.bool)
    front = (z_vals < (gd - truncation)) & rm
    back = (z_vals > (gd + truncation)) & rm
    center = (z_vals > (gd - 0.4 * truncation)) & \
             (z_vals < (gd + 0.4 * truncation)) & rm
    tail = (~front) & (~back) & (~center) & rm

    fs_loss = masked_mean(torch.square(sdf - 1.0), front)
    est_depth = z_vals + sdf * truncation
    center_loss = masked_mean(torch.square(est_depth - gd), center)
    tail_loss = masked_mean(torch.square(est_depth - gd), tail)
    return w.fs * fs_loss + w.center * center_loss + w.tail * tail_loss


def color_loss(gt_color: torch.Tensor, color: torch.Tensor,
               ray_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean squared RGB error; gt/color (R, 3), ray_mask (R,)."""
    sq = torch.square(gt_color - color)
    return masked_mean(sq, ray_mask[:, None].expand(sq.shape))


def depth_loss(gt_depth: torch.Tensor, depth: torch.Tensor,
               ray_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean squared depth error; (R,) each."""
    return masked_mean(torch.square(gt_depth - depth), ray_mask)
