"""Depth sampling along rays: stratified, surface-guided, and inverse-CDF
importance sampling.

Counterpart of `unislam_tpu/core/sampling.py`, including the reference's
unnormalised-CDF quirk in `sample_pdf` (`normalize=False`). Uniform draws
come from an explicit generator or enter as explicit tensors.
"""

from __future__ import annotations

from typing import Optional

import torch


def _uniform(shape, like: torch.Tensor, generator, given):
    if given is not None:
        return given.to(device=like.device, dtype=like.dtype)
    return torch.rand(shape, generator=generator, device=like.device,
                      dtype=like.dtype)


def perturb_z_vals(z_vals: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   t_rand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stratified jitter of sorted z values within their mid-point intervals."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    t_rand = _uniform(z_vals.shape, z_vals, generator, t_rand)
    return lower + (upper - lower) * t_rand


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               det: bool = False, normalize: bool = False,
               generator: Optional[torch.Generator] = None,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF sampling of n_samples z values per ray from per-bin
    weights. bins, weights: (R, B). With normalize=False the uniforms are
    inverted against cumsum(weights), whose total need not be 1."""
    if normalize:
        weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(weights, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (R, B+1)

    shape = cdf.shape[:-1] + (n_samples,)
    if det:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=cdf.dtype,
                           device=cdf.device).expand(shape)
    else:
        u = _uniform(shape, cdf, generator, u)
    u = u.contiguous()

    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)

    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    nb = bins.shape[-1] - 1
    bins_below = torch.gather(bins, -1, torch.clamp(below, max=nb))
    bins_above = torch.gather(bins, -1, torch.clamp(above, max=nb))

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def z_vals_with_depth(gt_depth: torch.Tensor, truncation: float,
                      n_stratified: int, n_importance: int, perturb: bool,
                      generator: Optional[torch.Generator] = None,
                      t_rand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depth-guided z per ray: n_importance samples over gt +- 1.5*trunc
    and n_stratified over [0, 1.2*gt], sorted, then jittered.
    gt_depth (R,) -> (R, n_stratified + n_importance)."""
    kw = dict(dtype=gt_depth.dtype, device=gt_depth.device)
    t_uni = torch.linspace(0.0, 1.0, n_stratified, **kw)
    t_surf = torch.linspace(0.0, 1.0, n_importance, **kw)
    gd = gt_depth[:, None]
    z_surface = gd - 1.5 * truncation + 3.0 * truncation * t_surf[None, :]
    z_free = 1.2 * gd * t_uni[None, :]
    z = torch.sort(torch.cat([z_free, z_surface], dim=-1), dim=-1).values
    if perturb:
        z = perturb_z_vals(z, generator, t_rand)
    return z


def z_vals_uniform(far: torch.Tensor, n_stratified: int, perturb: bool,
                   generator: Optional[torch.Generator] = None,
                   t_rand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Uniform z in [0, far + 0.01] per ray, for rays without depth."""
    t_uni = torch.linspace(0.0, 1.0, n_stratified, dtype=far.dtype,
                           device=far.device)
    z = (far[:, None] + 0.01) * t_uni[None, :]
    if perturb:
        z = perturb_z_vals(z, generator, t_rand)
    return z
