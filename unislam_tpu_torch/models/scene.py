"""The scene representation: one parameter dict + query functions.

Counterpart of the hash half of `unislam_tpu/models/scene.py`:

    {"sdf_table", "color_table", "sdf_mlp": {w0, b0, ...}, "color_mlp",
     "beta"}

`SceneConfig` carries the static structure (hash specs, bound, sizes).
`params_from_jax` / `params_to_numpy` carry parameters across from and to
the JAX package's pytree (as numpy arrays, same layouts).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np
import torch

from unislam_tpu_torch import resolve_device
from unislam_tpu_torch.models import decoders, hash_encoding
from unislam_tpu_torch.models.hash_encoding import HashGridSpec


@dataclass(frozen=True)
class SceneConfig:
    """Static scene structure. `bound` is (3, 2) world-space min/max."""
    sdf_spec: HashGridSpec
    color_spec: HashGridSpec
    bound: np.ndarray
    truncation: float
    hidden_size: int = 16
    n_blocks: int = 2
    learnable_beta: bool = True
    beta_init: float = 10.0
    encoding: str = "hash"
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
    encoding = cfg["grid"].get("encoding", "hash")
    if encoding != "hash":
        raise NotImplementedError(f"grid.encoding {encoding!r} is not "
                                  "ported yet (only 'hash')")
    if cfg["grid"].get("tcnn_network", False):
        raise NotImplementedError("grid.tcnn_network (fused decoders) is "
                                  "not ported yet")
    scale = cfg.get("scale", 1)
    bound = np.array(cfg["mapping"]["bound"], dtype=np.float64) * scale
    dividable = cfg["planes_res"]["bound_dividable"]
    bound[:, 1] = (np.floor((bound[:, 1] - bound[:, 0]) / dividable).astype(int)
                   + 1) * dividable + bound[:, 0]
    dim_max = (bound[:, 1] - bound[:, 0]).max()
    res_sdf = int(dim_max / cfg["grid"]["voxel_sdf"])
    res_color = int(dim_max / cfg["grid"]["voxel_color"])

    return SceneConfig(
        sdf_spec=hash_encoding.make_spec(
            log2_hashmap_size=cfg["grid"]["hash_size_sdf"],
            desired_resolution=res_sdf),
        color_spec=hash_encoding.make_spec(
            log2_hashmap_size=cfg["grid"]["hash_size_color"],
            desired_resolution=res_color),
        bound=bound.astype(np.float32),
        truncation=float(cfg["model"]["truncation"]),
        learnable_beta=bool(cfg["rendering"].get("learnable_beta", True)),
    )


def init_params(sc: SceneConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random scene parameters from `generator` (a CPU generator) on
    `device` (CUDA unless the caller asks for another; see
    `resolve_device`)."""
    device = resolve_device(device)
    return {
        "sdf_table": hash_encoding.init_table(sc.sdf_spec, generator, device),
        "color_table": hash_encoding.init_table(sc.color_spec, generator,
                                                device),
        "sdf_mlp": decoders.init_mlp(sc.sdf_spec.out_dim, sc.hidden_size, 1,
                                     sc.n_blocks, generator, device),
        "color_mlp": decoders.init_mlp(sc.color_spec.out_dim, sc.hidden_size,
                                       3, sc.n_blocks, generator, device),
        "beta": torch.full((1,), sc.beta_init, dtype=torch.float32,
                           device=device),
    }


def params_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The JAX scene pytree (leaves as numpy arrays or anything
    np.asarray takes) -> the port's parameter dict on `device` (CUDA unless
    the caller asks for another; see `resolve_device`)."""
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
            p_nor: torch.Tensor) -> torch.Tensor:
    """SDF at normalized points (N, 3) -> (N,)."""
    feat = hash_encoding.encode(params["sdf_table"], p_nor, sc.sdf_spec)
    return decoders.mlp_apply(params["sdf_mlp"], feat, "tanh")[..., 0]


def raw_rgb(params: Dict[str, Any], sc: SceneConfig,
            p_nor: torch.Tensor) -> torch.Tensor:
    """RGB at normalized points (N, 3) -> (N, 3)."""
    feat = hash_encoding.encode(params["color_table"], p_nor, sc.color_spec)
    return decoders.mlp_apply(params["color_mlp"], feat, "sigmoid")


def query(params: Dict[str, Any], sc: SceneConfig,
          p_nor: torch.Tensor) -> torch.Tensor:
    """Joint query -> (N, 4) [r, g, b, sdf]."""
    sdf = raw_sdf(params, sc, p_nor)
    rgb = raw_rgb(params, sc, p_nor)
    return torch.cat([rgb, sdf[..., None]], dim=-1)


def beta_value(params: Dict[str, Any], sc: SceneConfig) -> torch.Tensor:
    if sc.learnable_beta:
        return params["beta"][0]
    return torch.tensor(sc.beta_init, dtype=torch.float32,
                        device=params["beta"].device)
