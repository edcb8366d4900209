"""The scene representation: one parameter dict + query functions.

Counterpart of `unislam_tpu/models/scene.py`, both encodings:

    hash:  {"sdf_table", "color_table", "sdf_mlp": {w0, b0, ...},
            "color_mlp", "beta"}
    brick: {"table", "sdf_mlp", "color_mlp", "beta"}  (one table, both heads)

`SceneConfig` carries the static structure (grid specs, bound, sizes).
`params_from_jax` / `params_to_numpy` carry parameters across from and to
the JAX package's pytree (as numpy arrays, same layouts).

The surface-LOD queries (brick mode) encode the coarse levels at every
sample and the fine levels only at K selected samples per ray. The JAX
package selects and re-spreads with one-hot contractions; here a selection
is a (R, K) index tensor: `gather` picks the selected samples and a scatter
into zeros spreads their features back. A ray's K indices are distinct, so
both are exact.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np
import torch

from unislam_tpu_torch import resolve_device
from unislam_tpu_torch.models import brick_encoding, decoders, hash_encoding
from unislam_tpu_torch.models.brick_encoding import BrickSpec
from unislam_tpu_torch.models.hash_encoding import HashGridSpec


@dataclass(frozen=True)
class SceneConfig:
    """Static scene structure. `bound` is (3, 2) world-space min/max.
    `encoding` "hash" uses the two hash grids, "brick" the brick spec."""
    sdf_spec: HashGridSpec
    color_spec: HashGridSpec
    bound: np.ndarray
    truncation: float
    hidden_size: int = 16
    n_blocks: int = 2
    learnable_beta: bool = True
    beta_init: float = 10.0
    encoding: str = "hash"
    brick_spec: BrickSpec | None = None
    _on_device: Dict[torch.device, tuple] = field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def bound_min(self) -> np.ndarray:
        return self.bound[:, 0]

    @property
    def bound_extent(self) -> np.ndarray:
        return self.bound[:, 1] - self.bound[:, 0]

    def bound_tensors(self, device) -> tuple:
        """(bound (3, 2), bound_min, bound_extent) as tensors on `device`,
        copied there once: a copy from the host makes the host wait for the
        device, which the per-iteration path must not do."""
        device = torch.device(device)
        if device not in self._on_device:
            self._on_device[device] = tuple(
                torch.as_tensor(a, device=device)
                for a in (self.bound, self.bound_min, self.bound_extent))
        return self._on_device[device]


def make_scene_config(cfg: Dict[str, Any]) -> SceneConfig:
    """SceneConfig from a merged YAML config: the bound is scaled and
    rounded up to `bound_dividable`; the grid resolution is the largest
    scene dimension over the voxel size."""
    grid = cfg["grid"]
    encoding = grid.get("encoding", "hash")
    if encoding not in ("hash", "brick"):
        raise ValueError(f"unknown grid.encoding {encoding!r}")
    if grid.get("tcnn_network", False):
        raise NotImplementedError("grid.tcnn_network (fused decoders) is "
                                  "not ported yet")
    scale = cfg.get("scale", 1)
    bound = np.array(cfg["mapping"]["bound"], dtype=np.float64) * scale
    dividable = cfg["planes_res"]["bound_dividable"]
    bound[:, 1] = (np.floor((bound[:, 1] - bound[:, 0]) / dividable).astype(int)
                   + 1) * dividable + bound[:, 0]
    dim_max = (bound[:, 1] - bound[:, 0]).max()
    res_sdf = int(dim_max / grid["voxel_sdf"])
    res_color = int(dim_max / grid["voxel_color"])

    brick_spec = None
    if encoding == "brick":
        brick_spec = brick_encoding.make_spec(
            n_levels=int(grid.get("brick_levels", 4)),
            n_features=int(grid.get("brick_features", 8)),
            log2_hashmap_size=int(grid.get("brick_hash_size",
                                           grid["hash_size_sdf"])),
            base_resolution=int(grid.get("brick_base_res", 16)),
            desired_resolution=res_sdf,
            matmul_max_rows=int(grid.get("brick_matmul_rows", 4096)),
            matmul_hashed=int(grid.get("brick_matmul_hashed", 0)),
            matmul_hashed_rows=int(grid.get("brick_matmul_hashed_rows",
                                            4096)),
            hashed_level_rows=grid.get("brick_hashed_level_rows"))

    return SceneConfig(
        sdf_spec=hash_encoding.make_spec(
            log2_hashmap_size=grid["hash_size_sdf"],
            desired_resolution=res_sdf),
        color_spec=hash_encoding.make_spec(
            log2_hashmap_size=grid["hash_size_color"],
            desired_resolution=res_color),
        bound=bound.astype(np.float32),
        truncation=float(cfg["model"]["truncation"]),
        learnable_beta=bool(cfg["rendering"].get("learnable_beta", True)),
        encoding=encoding,
        brick_spec=brick_spec,
    )


def init_params(sc: SceneConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random scene parameters from `generator` (a CPU generator) on
    `device` (CUDA unless the caller asks for another; see
    `resolve_device`)."""
    device = resolve_device(device)
    beta = torch.full((1,), sc.beta_init, dtype=torch.float32, device=device)
    if sc.encoding == "brick":
        feat_dim = sc.brick_spec.out_dim
        return {
            "table": brick_encoding.init_table(sc.brick_spec, generator,
                                               device),
            "sdf_mlp": decoders.init_mlp(feat_dim, sc.hidden_size, 1,
                                         sc.n_blocks, generator, device),
            "color_mlp": decoders.init_mlp(feat_dim, sc.hidden_size, 3,
                                           sc.n_blocks, generator, device),
            "beta": beta,
        }
    return {
        "sdf_table": hash_encoding.init_table(sc.sdf_spec, generator, device),
        "color_table": hash_encoding.init_table(sc.color_spec, generator,
                                                device),
        "sdf_mlp": decoders.init_mlp(sc.sdf_spec.out_dim, sc.hidden_size, 1,
                                     sc.n_blocks, generator, device),
        "color_mlp": decoders.init_mlp(sc.color_spec.out_dim, sc.hidden_size,
                                       3, sc.n_blocks, generator, device),
        "beta": beta,
    }


def params_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The JAX scene pytree of either encoding (leaves as numpy arrays or
    anything np.asarray takes) -> the port's parameter dict on `device`
    (CUDA unless the caller asks for another; see `resolve_device`)."""
    device = resolve_device(device)
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return torch.tensor(np.asarray(v, dtype=np.float32), device=device)
    return conv(tree)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of params_from_jax: a nested dict of numpy arrays."""
    return {k: (params_to_numpy(v) if isinstance(v, dict)
                else v.detach().cpu().numpy()) for k, v in params.items()}


def normalize_points(sc: SceneConfig, pts: torch.Tensor) -> torch.Tensor:
    """World points -> [0, 1]^3."""
    _, lo, ext = sc.bound_tensors(pts.device)
    return (pts - lo) / ext


def raw_sdf(params: Dict[str, Any], sc: SceneConfig,
            p_nor: torch.Tensor, levels: tuple = None) -> torch.Tensor:
    """SDF at normalized points (N, 3) -> (N,). `levels` (brick mode
    only) restricts the encode to a ladder subset; the missing levels'
    features are zero-filled so the MLP input width is unchanged."""
    if sc.encoding == "brick":
        feat = brick_encoding.encode(params["table"], p_nor, sc.brick_spec,
                                     levels)
        if levels is not None and len(levels) < sc.brick_spec.n_levels:
            feat = _zero_fill_levels(feat, sc.brick_spec, tuple(levels))
    else:
        feat = hash_encoding.encode(params["sdf_table"], p_nor, sc.sdf_spec)
    return decoders.mlp_apply(params["sdf_mlp"], feat, "tanh")[..., 0]


def _zero_fill_levels(feat: torch.Tensor, spec: BrickSpec,
                      levels: tuple) -> torch.Tensor:
    """(N, len(levels)*F) features -> the full (N, L*F) width with zeros
    at the missing levels (level-major order)."""
    N, F = feat.shape[0], spec.n_features
    f3 = feat.reshape(N, len(levels), F)
    zeros = feat.new_zeros(N, F)
    cols = [f3[:, levels.index(l)] if l in levels else zeros
            for l in range(spec.n_levels)]
    return torch.stack(cols, dim=1).reshape(N, spec.n_levels * F)


def raw_rgb(params: Dict[str, Any], sc: SceneConfig,
            p_nor: torch.Tensor) -> torch.Tensor:
    """RGB at normalized points (N, 3) -> (N, 3)."""
    if sc.encoding == "brick":
        feat = brick_encoding.encode(params["table"], p_nor, sc.brick_spec)
    else:
        feat = hash_encoding.encode(params["color_table"], p_nor,
                                    sc.color_spec)
    return decoders.mlp_apply(params["color_mlp"], feat, "sigmoid")


def _decode(params: Dict[str, Any], feat: torch.Tensor) -> torch.Tensor:
    """Both heads on shared features (..., C) -> (..., 4) [r, g, b, sdf]."""
    sdf = decoders.mlp_apply(params["sdf_mlp"], feat, "tanh")
    rgb = decoders.mlp_apply(params["color_mlp"], feat, "sigmoid")
    return torch.cat([rgb, sdf], dim=-1)


def query(params: Dict[str, Any], sc: SceneConfig,
          p_nor: torch.Tensor) -> torch.Tensor:
    """Joint query -> (N, 4) [r, g, b, sdf]. In brick mode the shared
    features are encoded once and feed both heads."""
    if sc.encoding == "brick":
        return _decode(params, brick_encoding.encode(
            params["table"], p_nor, sc.brick_spec))
    sdf = raw_sdf(params, sc, p_nor)
    rgb = raw_rgb(params, sc, p_nor)
    return torch.cat([rgb, sdf[..., None]], dim=-1)


def _fine_groups(fine: tuple, sel_idx: torch.Tensor, n_mid: int) -> list:
    """Fine-level band groups [(levels, sel_idx (R, K_g)), ...]. With
    `n_mid` (0 = off) the non-finest fine levels get only the n_mid
    nearest selected samples; the selection is ordered nearest first, so
    its first n_mid columns are they."""
    if n_mid and len(fine) > 1 and 0 < n_mid < sel_idx.shape[1]:
        return [(fine[:-1], sel_idx[:, :n_mid]), (fine[-1:], sel_idx)]
    return [(fine, sel_idx)]


def _group_points(p_nor: torch.Tensor, groups) -> list:
    """Selected band points per group, (R*K_g, 3) each."""
    return [torch.gather(p_nor, 1, sel[..., None].expand(-1, -1, 3))
            .reshape(-1, 3) for _, sel in groups]


def _lod_decode(params, p_nor, feat_c, groups, group_feats):
    """Spread each band group's features back to all S samples (zeros
    elsewhere), concat with the coarse features (level-major order),
    decode both heads -> (R, S, 4)."""
    R, S = p_nor.shape[:2]
    feats = [feat_c]
    for (_, sel), feat_sel in zip(groups, group_feats):
        C = feat_sel.shape[-1]
        feats.append(feat_sel.new_zeros(R, S, C).scatter(
            1, sel[..., None].expand(-1, -1, C), feat_sel.reshape(R, -1, C)))
    feat = torch.cat(feats, dim=-1).reshape(R * S, -1)
    return _decode(params, feat).reshape(R, S, 4)


def _no_dedup(dedup: float) -> None:
    if dedup > 0:
        raise NotImplementedError("rendering.dedup_band (the band row "
                                  "dedup) is not ported yet")


def _lod_fine_tail(params: Dict[str, Any], sc: SceneConfig,
                   p_nor: torch.Tensor, feat_c: torch.Tensor,
                   sel_idx: torch.Tensor, fine: tuple,
                   n_mid: int = 0) -> torch.Tensor:
    """Encode the fine levels at the selected samples (one encode_multi
    across band groups), spread back, concat with the coarse features and
    decode. p_nor (R, S, 3); feat_c (R, S, Cc); sel_idx (R, K)."""
    groups = _fine_groups(fine, sel_idx, n_mid)
    feats = brick_encoding.encode_multi(
        params["table"], _group_points(p_nor, groups), sc.brick_spec,
        [g for g, _ in groups])
    return _lod_decode(params, p_nor, feat_c, groups, feats)


def top_k_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores per row, largest first, ties to the
    lower index (the order of `jax.lax.top_k`)."""
    return torch.sort(score, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def query_lod_field(params: Dict[str, Any], sc: SceneConfig,
                    p_nor: torch.Tensor, K: int, split: str = "cost",
                    n_mid: int = 0, dedup: float = 0.0) -> torch.Tensor:
    """Surface-LOD joint query with field-guided selection (brick mode):
    the K samples per ray whose coarse-only SDF is nearest zero get the
    fine levels. p_nor (R, S, 3) -> (R, S, 4) [r, g, b, sdf]."""
    assert sc.encoding == "brick"
    _no_dedup(dedup)
    spec = sc.brick_spec
    R, S = p_nor.shape[:2]
    coarse, fine = brick_encoding.coarse_fine_split(spec, split)
    assert not coarse or not fine or max(coarse) < min(fine)
    feat_c = brick_encoding.encode(params["table"], p_nor.reshape(-1, 3),
                                   spec, coarse)
    # the selection is discrete: its probe carries no gradient
    with torch.no_grad():
        probe = _zero_fill_levels(feat_c, spec, tuple(coarse))
        sdf_c = decoders.mlp_apply(params["sdf_mlp"], probe,
                                   "tanh")[..., 0].reshape(R, S)
        sel_idx = top_k_indices(-torch.abs(sdf_c), K)
    return _lod_fine_tail(params, sc, p_nor, feat_c.reshape(R, S, -1),
                          sel_idx, fine, n_mid)


def query_lod(params: Dict[str, Any], sc: SceneConfig, p_nor: torch.Tensor,
              sel_idx: torch.Tensor, split: str = "cost", n_mid: int = 0,
              dedup: float = 0.0) -> torch.Tensor:
    """Surface-LOD joint query (brick mode): the coarse levels at ALL
    samples, the fine levels only at the K selected samples of each ray.
    p_nor (R, S, 3); sel_idx (R, K) distinct sample indices per ray,
    nearest the surface first. Returns (R, S, 4) [r, g, b, sdf].

    One encode_multi serves every point set (all samples x coarse levels,
    each band group x its fine levels), so the table gradient is one
    scatter-accumulate."""
    assert sc.encoding == "brick"
    _no_dedup(dedup)
    spec = sc.brick_spec
    R, S = p_nor.shape[:2]
    coarse, fine = brick_encoding.coarse_fine_split(spec, split)
    # level-major feature order: coarse must be a ladder prefix so that
    # concat([coarse_feat, fine_feat]) matches the full encode's layout
    assert not coarse or not fine or max(coarse) < min(fine)
    groups = _fine_groups(fine, sel_idx, n_mid)
    feats = brick_encoding.encode_multi(
        params["table"], [p_nor.reshape(-1, 3)] + _group_points(p_nor, groups),
        spec, [coarse] + [g for g, _ in groups])
    return _lod_decode(params, p_nor, feats[0].reshape(R, S, -1), groups,
                       feats[1:])


def query_coarse(params: Dict[str, Any], sc: SceneConfig,
                 p_nor: torch.Tensor, split: str = "cost") -> torch.Tensor:
    """Coarse-levels-only joint query (brick mode) -> (N, 4): the fine
    levels are skipped and their feature columns zero-filled."""
    assert sc.encoding == "brick"
    spec = sc.brick_spec
    coarse, _ = brick_encoding.coarse_fine_split(spec, split)
    feat = brick_encoding.encode(params["table"], p_nor, spec, coarse)
    return _decode(params, _zero_fill_levels(feat, spec, tuple(coarse)))


def beta_value(params: Dict[str, Any], sc: SceneConfig) -> torch.Tensor:
    if sc.learnable_beta:
        return params["beta"][0]
    return torch.tensor(sc.beta_init, dtype=torch.float32,
                        device=params["beta"].device)
