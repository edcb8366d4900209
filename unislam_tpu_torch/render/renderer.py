"""Differentiable volume renderer: depth-guided sampling, SDF alpha
compositing and uncertainty outputs.

Counterpart of `unislam_tpu/render/renderer.py` `render_rays`. Rays with
sensor depth get depth-guided samples; rays without it get uniform samples
to the scene bound plus importance samples from a gradient-free probe of
the SDF field, which runs only when some ray lacks depth. Compositing is
plain PyTorch.

Surface LOD (brick encoding, `n_fine`): the fine levels are queried only at
the n_fine samples per ray nearest the sensor depth (or the probe's depth
for rays without one), or nearest the coarse field's zero crossing
(`lod_select: field`); `n_fine < 0` queries the coarse levels alone.

Random draws come from one explicit generator in a fixed order (depth-
branch jitter, then the probe's jitter and PDF uniforms), or enter as
explicit tensors through `draws` (keys "t_depth", "t_uni", "u_pdf").
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from unislam_tpu_torch.core import rays as rays_lib
from unislam_tpu_torch.core import sampling
from unislam_tpu_torch.models import brick_encoding
from unislam_tpu_torch.models import scene as scene_lib
from unislam_tpu_torch.models.scene import SceneConfig


class RenderConfig(NamedTuple):
    n_stratified: int = 32
    n_importance: int = 8
    perturb: bool = True
    # surface LOD (brick encoding only): query the fine levels at only the
    # n_fine samples per ray nearest the surface; 0 = all levels at all
    # samples; -1 = the coarse levels alone (scene.query_coarse)
    n_fine: int = 0
    # which levels are fine (brick_encoding.coarse_fine_split)
    lod_split: str = "cost"
    # "depth": nearest the sensor (or probe) depth; "field": nearest the
    # coarse field's zero crossing (scene.query_lod_field)
    lod_select: str = "depth"
    # the non-finest fine levels get only the n_fine_mid nearest samples
    # (0 = the same band as the finest level)
    n_fine_mid: int = 0
    # band row dedup of the table gradient (not ported yet: 0 only)
    dedup_band: float = 0.0


class RenderOutput(NamedTuple):
    termination_prob: torch.Tensor   # (R,)  sum of weights
    pixel_unc: torch.Tensor          # (R,)  (1 - sum w)^2
    depth: torch.Tensor              # (R,)
    rgb: torch.Tensor                # (R, 3)
    sdf: torch.Tensor                # (R, S)
    z_vals: torch.Tensor             # (R, S)
    depth_std: torch.Tensor          # (R,)  rendered depth uncertainty


def sdf2alpha(sdf: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """alpha = 1 - exp(-beta * sigmoid(-beta * sdf))."""
    return 1.0 - torch.exp(-beta * torch.sigmoid(-sdf * beta))


class _NonzeroCumprod(torch.autograd.Function):
    """`torch.cumprod` over the last axis of a tensor with no zeros. Its
    backward is the closed form for that case; torch's own backward first
    checks for zeros, reading a device value on the host, which would make
    every iteration wait for the device."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        # d out_i / d x_j = out_i / x_j for i >= j
        tail = torch.flip(torch.cumsum(torch.flip(g * out, [-1]), dim=-1),
                          [-1])
        return tail / x


def exclusive_cumprod_weights(alpha: torch.Tensor) -> torch.Tensor:
    """w_i = alpha_i * prod_{j<i}(1 - alpha_j + 1e-10); the factors are at
    least 1e-10 since alpha <= 1, so the product has no zero factor. (The
    JAX package forms the same product by log2(S) shifted multiplies.)"""
    shifted = torch.cat([torch.ones_like(alpha[..., :1]),
                         1.0 - alpha[..., :-1] + 1e-10], dim=-1)
    return alpha * _NonzeroCumprod.apply(shifted)


def _probe_z_vals(params, sc: SceneConfig, rc: RenderConfig, rays_o, rays_d,
                  generator, draws, levels=None):
    """Uniform + importance z values for rays without depth: uniform
    samples to the bound, a gradient-free SDF query there (over `levels`,
    default all), then inverse-CDF samples from the resulting weights.
    Returns (z (R, S), the probe's rendered depth (R,))."""
    with torch.no_grad():
        bound = sc.bound_tensors(rays_o.device)[0]
        far = rays_lib.ray_aabb_far(rays_o, rays_d, bound)
        z_uni = sampling.z_vals_uniform(far, rc.n_stratified, rc.perturb,
                                        generator, draws.get("t_uni"))
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_uni[..., None]
        p_nor = scene_lib.normalize_points(sc, pts.reshape(-1, 3))
        sdf_uni = scene_lib.raw_sdf(params, sc, p_nor,
                                    levels=levels).reshape(z_uni.shape)
        w_uni = exclusive_cumprod_weights(
            sdf2alpha(sdf_uni, scene_lib.beta_value(params, sc)))
        mids = 0.5 * (z_uni[..., 1:] + z_uni[..., :-1])
        z_samp = sampling.sample_pdf(mids, w_uni[..., 1:-1], rc.n_importance,
                                     generator=generator,
                                     u=draws.get("u_pdf"))
        z = torch.sort(torch.cat([z_uni, z_samp], dim=-1), dim=-1).values
        return z, torch.sum(w_uni * z_uni, dim=-1)


def _lod_mode(sc: SceneConfig, rc: RenderConfig, n_total: int):
    """(use_lod, coarse_only, probe_levels). Degenerate splits (no fine or
    no coarse levels) fall back to the full query."""
    use_lod = 0 < rc.n_fine < n_total and sc.encoding == "brick"
    coarse_only = rc.n_fine < 0 and sc.encoding == "brick"
    if not (use_lod or coarse_only):
        return False, False, None
    coarse, fine = brick_encoding.coarse_fine_split(sc.brick_spec,
                                                    rc.lod_split)
    if not fine or not coarse:
        return False, False, None
    return use_lod, coarse_only, coarse


def render_rays(params: Dict[str, Any], sc: SceneConfig, rc: RenderConfig,
                rays_o: torch.Tensor, rays_d: torch.Tensor,
                gt_depth: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None,
                probe: Optional[bool] = None) -> RenderOutput:
    """Render rays (R, 3) with gt_depth (R,), 0 marking no sensor depth.
    Differentiable w.r.t. params and rays.

    `probe`: whether any ray may lack depth. None asks the device (one
    sync); callers that know the answer pass it (tracking gives every ray a
    depth; mapping checks its data once per phase)."""
    draws = draws or {}
    has_depth = gt_depth > 0
    z_vals = sampling.z_vals_with_depth(
        torch.clamp(gt_depth, min=1e-6), sc.truncation, rc.n_stratified,
        rc.n_importance, rc.perturb, generator, draws.get("t_depth"))
    R, S = z_vals.shape
    use_lod, coarse_only, probe_levels = _lod_mode(sc, rc, S)
    if probe is None:
        probe = bool((~has_depth).any())
    d_ref = gt_depth
    if probe:
        z_nodepth, d_probe = _probe_z_vals(params, sc, rc, rays_o.detach(),
                                           rays_d.detach(), generator, draws,
                                           probe_levels)
        z_vals = torch.where(has_depth[:, None], z_vals, z_nodepth)
        # the probe's depth is the LOD selection's surface estimate for
        # rays without sensor depth
        d_ref = torch.where(has_depth, gt_depth, d_probe)

    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    p_nor = scene_lib.normalize_points(sc, pts.reshape(-1, 3))
    if use_lod and rc.lod_select == "field":
        raw = scene_lib.query_lod_field(
            params, sc, p_nor.reshape(R, S, 3), rc.n_fine,
            split=rc.lod_split, n_mid=rc.n_fine_mid, dedup=rc.dedup_band)
    elif use_lod:
        score = -torch.abs(z_vals.detach() - d_ref[:, None])
        raw = scene_lib.query_lod(
            params, sc, p_nor.reshape(R, S, 3),
            scene_lib.top_k_indices(score, rc.n_fine), split=rc.lod_split,
            n_mid=rc.n_fine_mid, dedup=rc.dedup_band)
    elif coarse_only:
        raw = scene_lib.query_coarse(params, sc, p_nor,
                                     split=rc.lod_split).reshape(R, S, 4)
    else:
        raw = scene_lib.query(params, sc, p_nor).reshape(R, S, 4)
    sdf = raw[..., 3]

    alpha = sdf2alpha(sdf, scene_lib.beta_value(params, sc))
    weights = exclusive_cumprod_weights(alpha)
    rgb = torch.sum(weights[..., None] * raw[..., :3], dim=-2)
    depth = torch.sum(weights * z_vals, dim=-1)
    termination_prob = torch.sum(weights, dim=-1)
    pixel_unc = torch.square(1.0 - termination_prob)
    depth_std = torch.sqrt(
        torch.sum(weights * torch.square(depth[..., None] - z_vals), dim=-1))
    return RenderOutput(termination_prob, pixel_unc, depth, rgb, sdf, z_vals,
                        depth_std)
