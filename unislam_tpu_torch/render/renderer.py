"""Differentiable volume renderer: depth-guided sampling, SDF alpha
compositing and uncertainty outputs.

Counterpart of the non-LOD branch of `unislam_tpu/render/renderer.py`
`render_rays`. Rays with sensor depth get depth-guided samples; rays
without it get uniform samples to the scene bound plus importance samples
from a gradient-free probe of the SDF field, which runs only when some ray
lacks depth. Compositing is plain PyTorch.

Random draws come from one explicit generator in a fixed order (depth-
branch jitter, then the probe's jitter and PDF uniforms), or enter as
explicit tensors through `draws` (keys "t_depth", "t_uni", "u_pdf").
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from unislam_tpu_torch.core import rays as rays_lib
from unislam_tpu_torch.core import sampling
from unislam_tpu_torch.models import scene as scene_lib
from unislam_tpu_torch.models.scene import SceneConfig


class RenderConfig(NamedTuple):
    n_stratified: int = 32
    n_importance: int = 8
    perturb: bool = True


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
                  generator, draws) -> torch.Tensor:
    """Uniform + importance z values for rays without depth: uniform
    samples to the bound, a gradient-free SDF query there, then inverse-CDF
    samples from the resulting weights."""
    with torch.no_grad():
        bound = sc.bound_tensors(rays_o.device)[0]
        far = rays_lib.ray_aabb_far(rays_o, rays_d, bound)
        z_uni = sampling.z_vals_uniform(far, rc.n_stratified, rc.perturb,
                                        generator, draws.get("t_uni"))
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_uni[..., None]
        p_nor = scene_lib.normalize_points(sc, pts.reshape(-1, 3))
        sdf_uni = scene_lib.raw_sdf(params, sc, p_nor).reshape(z_uni.shape)
        w_uni = exclusive_cumprod_weights(
            sdf2alpha(sdf_uni, scene_lib.beta_value(params, sc)))
        mids = 0.5 * (z_uni[..., 1:] + z_uni[..., :-1])
        z_samp = sampling.sample_pdf(mids, w_uni[..., 1:-1], rc.n_importance,
                                     generator=generator,
                                     u=draws.get("u_pdf"))
        return torch.sort(torch.cat([z_uni, z_samp], dim=-1), dim=-1).values


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
    if probe is None:
        probe = bool((~has_depth).any())
    if probe:
        z_nodepth = _probe_z_vals(params, sc, rc, rays_o.detach(),
                                  rays_d.detach(), generator, draws)
        z_vals = torch.where(has_depth[:, None], z_vals, z_nodepth)

    R, S = z_vals.shape
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    p_nor = scene_lib.normalize_points(sc, pts.reshape(-1, 3))
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
