"""SDF / color / depth losses as weighted means with 0/1 masks.

Counterpart of `unislam_tpu/core/losses.py`; no boolean-mask indexing, so
nothing here waits for the device.

Under a ray group (`parallel/sharding.py`) each rank holds a block of the
batch: the caller sums the means' denominators over the ranks
(`loss_counts`, one all-reduce) and hands them in, so each rank's
numerator is divided by the batch's count; the ranks' partial losses then
sum to the batch's loss and their summed gradients to its gradient.
Without `denoms` the functions are exactly the plain ones.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def masked_mean(x: torch.Tensor, mask: torch.Tensor,
                denom=None) -> torch.Tensor:
    """Mean of x over elements where mask is truthy (0 if mask empty);
    `denom`: the count to divide by, where it is the batch's and not
    this mask's."""
    mask = mask.to(x.dtype)
    denom = torch.clamp(torch.sum(mask) if denom is None else denom,
                        min=1.0)
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


def _sdf_masks(z_vals, gt_depth, ray_mask, truncation):
    """The free-space, center and tail masks (R, N) of `sdf_losses`."""
    gd = gt_depth[:, None]
    rm = ray_mask[:, None].to(torch.bool)
    front = (z_vals < (gd - truncation)) & rm
    back = (z_vals > (gd + truncation)) & rm
    center = (z_vals > (gd - 0.4 * truncation)) & \
             (z_vals < (gd + 0.4 * truncation)) & rm
    tail = (~front) & (~back) & (~center) & rm
    return front, center, tail


def sdf_losses(sdf: torch.Tensor, z_vals: torch.Tensor,
               gt_depth: torch.Tensor, ray_mask: torch.Tensor,
               truncation: float, w: SdfLossWeights,
               denoms=None) -> torch.Tensor:
    """Free-space / center / tail SDF supervision, each averaged over its
    own mask, then weighted-summed. sdf, z_vals (R, N); gt_depth,
    ray_mask (R,). `denoms`: the three masks' counts to divide by."""
    gd = gt_depth[:, None]
    front, center, tail = _sdf_masks(z_vals, gt_depth, ray_mask, truncation)
    d = (None,) * 3 if denoms is None else denoms
    fs_loss = masked_mean(torch.square(sdf - 1.0), front, d[0])
    est_depth = z_vals + sdf * truncation
    center_loss = masked_mean(torch.square(est_depth - gd), center, d[1])
    tail_loss = masked_mean(torch.square(est_depth - gd), tail, d[2])
    return w.fs * fs_loss + w.center * center_loss + w.tail * tail_loss


def color_loss(gt_color: torch.Tensor, color: torch.Tensor,
               ray_mask: torch.Tensor, denom=None) -> torch.Tensor:
    """Masked mean squared RGB error; gt/color (R, 3), ray_mask (R,)."""
    sq = torch.square(gt_color - color)
    return masked_mean(sq, ray_mask[:, None].expand(sq.shape), denom)


def depth_loss(gt_depth: torch.Tensor, depth: torch.Tensor,
               ray_mask: torch.Tensor, denom=None) -> torch.Tensor:
    """Masked mean squared depth error; (R,) each."""
    return masked_mean(torch.square(gt_depth - depth), ray_mask, denom)


def loss_counts(z_vals: torch.Tensor, gt_depth: torch.Tensor,
                truncation: float, m_sdf: torch.Tensor, m_col: torch.Tensor,
                m_dep: torch.Tensor, *more: torch.Tensor) -> torch.Tensor:
    """The denominators of `sdf_losses` (3), `color_loss` and `depth_loss`
    over these rays, then the counts of the masks `more`: an f32 vector
    (sums of 0/1, exact below 2^24), to be summed over a ray group in one
    all-reduce."""
    front, center, tail = _sdf_masks(z_vals, gt_depth, m_sdf, truncation)
    f32 = torch.float32
    return torch.stack([front.to(f32).sum(), center.to(f32).sum(),
                        tail.to(f32).sum(), 3.0 * m_col.to(f32).sum(),
                        m_dep.to(f32).sum()]
                       + [m.to(f32).sum() for m in more])
