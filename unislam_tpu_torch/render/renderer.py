"""Differentiable volume renderer: depth-guided sampling, SDF alpha
compositing and uncertainty outputs.

Counterpart of `unislam_tpu/render/renderer.py` `render_rays`. Rays with
sensor depth get depth-guided samples; rays without it get uniform samples
to the scene bound plus importance samples from a gradient-free probe of
the SDF field, which runs only when some ray lacks depth. Compositing, and
the probe's weights, go through kernel K3 (`kernels/composite.py`).

Surface LOD (brick encoding, `n_fine`): the fine levels are queried only at
the n_fine samples per ray nearest the sensor depth (or the probe's depth
for rays without one), or nearest the coarse field's zero crossing
(`lod_select: field`); `n_fine < 0` queries the coarse levels alone.

Random draws come from one explicit generator in a fixed order (depth-
branch jitter, then the probe's jitter and PDF uniforms), or enter as
explicit tensors through `draws` (keys "t_depth", "t_uni", "u_pdf").
`draw` makes them for a whole batch up front, in that order, so a rank of
a ray group can take its block of the same numbers (`parallel/sharding`).

`render_img` renders a full image in fixed `ray_batch_size` chunks without
gradients (evaluation, visualisation).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from unislam_tpu_torch.core import rays as rays_lib
from unislam_tpu_torch.core import sampling
from unislam_tpu_torch.kernels import composite as k3
# the plain compositing pieces keep their names here: the renderer's tests
# import them from this module
from unislam_tpu_torch.kernels.composite import (  # noqa: F401
    _NonzeroCumprod, exclusive_cumprod_weights, sdf2alpha)
from unislam_tpu_torch.models import brick_encoding
from unislam_tpu_torch.models import scene as scene_lib
from unislam_tpu_torch.models.scene import SceneConfig
from unislam_tpu_torch.utils.profiling import fetch, span


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
    # backward row dedup of the band groups (0 = off): a ray's same-brick
    # band samples (consecutive in z order) have their table-gradient rows
    # merged into one brick's rows before the scatter, at most
    # ceil(n_fine * dedup_band) bricks a ray (scene._dedup_groups, kernel
    # K8), each run's sum rounded to bf16. Rays whose band crosses more
    # bricks drop the table gradient of their farthest runs. Point and
    # pose gradients are unchanged.
    dedup_band: float = 0.0
    # rays per chunk of a full-image render (render_img)
    ray_batch_size: int = 10000


class RenderOutput(NamedTuple):
    termination_prob: torch.Tensor   # (R,)  sum of weights
    pixel_unc: torch.Tensor          # (R,)  (1 - sum w)^2
    depth: torch.Tensor              # (R,)
    rgb: torch.Tensor                # (R, 3)
    sdf: torch.Tensor                # (R, S)
    z_vals: torch.Tensor             # (R, S)
    depth_std: torch.Tensor          # (R,)  rendered depth uncertainty


def draw_shapes(rc: RenderConfig, n_rays: int,
                probe: bool) -> Dict[str, tuple]:
    """The shapes of the f32 uniforms `render_rays` draws for `n_rays`
    rays, by key, in the order it draws them."""
    out = {}
    if rc.perturb:
        out["t_depth"] = (n_rays, rc.n_stratified + rc.n_importance)
    if probe:
        if rc.perturb:
            out["t_uni"] = (n_rays, rc.n_stratified)
        out["u_pdf"] = (n_rays, rc.n_importance)
    return out


def draw(rc: RenderConfig, n_rays: int, probe: bool,
         generator: Optional[torch.Generator], device) -> Dict[str, Any]:
    """The draws `render_rays` takes from `generator` for `n_rays` rays,
    made up front in its order: the same numbers as a render of the whole
    batch draws."""
    return {k: torch.rand(shape, generator=generator, device=device,
                          dtype=torch.float32)
            for k, shape in draw_shapes(rc, n_rays, probe).items()}


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
        w_uni, d_probe = k3.probe_weights(
            sdf_uni, z_uni, scene_lib.beta_value(params, sc))
        mids = 0.5 * (z_uni[..., 1:] + z_uni[..., :-1])
        z_samp = sampling.sample_pdf(mids, w_uni[..., 1:-1], rc.n_importance,
                                     generator=generator,
                                     u=draws.get("u_pdf"))
        z = torch.sort(torch.cat([z_uni, z_samp], dim=-1), dim=-1).values
        return z, d_probe


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
    with span(".sample"):
        has_depth = gt_depth > 0
        z_vals = sampling.z_vals_with_depth(
            torch.clamp(gt_depth, min=1e-6), sc.truncation, rc.n_stratified,
            rc.n_importance, rc.perturb, generator, draws.get("t_depth"))
        R, S = z_vals.shape
        use_lod, coarse_only, probe_levels = _lod_mode(sc, rc, S)
        if probe is None:
            probe = fetch(bool, (~has_depth).any())
        d_ref = gt_depth
        if probe:
            z_nodepth, d_probe = _probe_z_vals(
                params, sc, rc, rays_o.detach(), rays_d.detach(), generator,
                draws, probe_levels)
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
    with span(".composite"):
        rgb, depth, termination_prob, pixel_unc, depth_std = k3.composite(
            raw, z_vals, scene_lib.beta_value(params, sc))
    return RenderOutput(termination_prob, pixel_unc, depth, rgb, raw[..., 3],
                        z_vals, depth_std)


def render_img(params: Dict[str, Any], sc: SceneConfig, rc: RenderConfig,
               intr: rays_lib.Intrinsics, c2w,
               generator: Optional[torch.Generator] = None, gt_depth=None,
               draws=None):
    """Full-image render at camera `c2w` (4, 4), in chunks of
    `rc.ray_batch_size` rays under `torch.no_grad()`; the last chunk is
    padded (origin 0, direction 1, depth 1) to the full size, as the JAX
    package pads its fixed-shape calls. Runs on the device of `params`.

    `gt_depth` (H, W), 0 = no sensor depth (None: no depth anywhere); a
    chunk with a pixel without depth runs the renderer's no-depth probe.
    Draws come from `generator`, or chunk i takes `draws[i]` (see
    `render_rays`).

    Returns (depth (H, W), rgb (H, W, 3), termination (H, W), pixel_unc
    (H, W), depth_std (H, W)) as tensors on that device."""
    dev = params["beta"].device
    H, W = intr.H, intr.W
    n = H * W
    c2w = torch.as_tensor(c2w, dtype=torch.float32).to(dev)
    rays_o, rays_d = rays_lib.get_rays(intr, c2w)
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    if gt_depth is None:
        gtd = torch.zeros(n, dtype=torch.float32, device=dev)
    else:
        gtd = torch.as_tensor(gt_depth, dtype=torch.float32).to(
            dev).reshape(-1)
    chunk = rc.ray_batch_size
    pad = (-n) % chunk
    if pad:
        rays_o = torch.cat([rays_o, rays_o.new_zeros(pad, 3)])
        rays_d = torch.cat([rays_d, rays_d.new_ones(pad, 3)])
        gtd = torch.cat([gtd, gtd.new_ones(pad)])
    # which chunks hold a pixel without depth: one fetch for the image
    lacks = fetch(torch.Tensor.tolist,
                  (gtd <= 0).reshape(-1, chunk).any(dim=1))
    outs = []
    with torch.no_grad():
        for c, i in enumerate(range(0, n + pad, chunk)):
            outs.append(render_rays(
                params, sc, rc, rays_o[i:i + chunk], rays_d[i:i + chunk],
                gtd[i:i + chunk], generator,
                draws[c] if draws is not None else None, probe=lacks[c]))

    def cat(field):
        return torch.cat([getattr(o, field) for o in outs])[:n]

    return (cat("depth").reshape(H, W), cat("rgb").reshape(H, W, 3),
            cat("termination_prob").reshape(H, W),
            cat("pixel_unc").reshape(H, W), cat("depth_std").reshape(H, W))
