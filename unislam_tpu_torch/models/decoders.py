"""Tiny SDF / RGB MLP decoders as plain parameter dicts.

Counterpart of `unislam_tpu/models/decoders.py`, both variants; the
variant rides in the parameter structure, so every query site supports
both:
- vanilla (`grid.tcnn_network: false`): biased f32 linears with weights
  `w{i}` stored (d_in, d_out) and applied as `x @ W + b`, ReLU between
  layers;
- fused (`grid.tcnn_network: true`, the reference's tcnn FullyFusedMLP):
  bias-free {"w0", "w1"} with bf16 operands and f32 sums, kernel K4
  (`kernels/fused_mlp.py`). `decode_heads` runs the SDF and colour heads
  on shared features in one K4 launch a direction.
"""

from __future__ import annotations

from typing import Dict

import torch

from unislam_tpu_torch import resolve_device
from unislam_tpu_torch.kernels import fused_mlp


def init_mlp(in_dim: int, hidden: int, out_dim: int, n_blocks: int = 2,
             generator: torch.Generator | None = None,
             device=None) -> Dict[str, torch.Tensor]:
    """nn.Linear-style U(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights and
    biases, drawn from `generator` on the CPU and moved to `device` (CUDA
    unless the caller asks for another)."""
    device = resolve_device(device)
    dims = [in_dim] + [hidden] * n_blocks + [out_dim]
    params = {}
    for li, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        bound = 1.0 / d_in ** 0.5
        for name, shape in ((f"w{li}", (d_in, d_out)), (f"b{li}", (d_out,))):
            u = torch.rand(shape, generator=generator)
            params[name] = ((2.0 * u - 1.0) * bound).to(device)
    return params


def init_fused_mlp(in_dim: int, hidden: int, out_dim: int, n_blocks: int = 2,
                   generator: torch.Generator | None = None,
                   device=None) -> Dict[str, torch.Tensor]:
    """The fused variant's bias-free weights: `n_blocks - 1` hidden layers,
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from `generator` on the CPU, on
    `device`; f32, cast to bf16 where applied. The scene uses n_blocks 2
    (one hidden layer), the only depth `mlp_apply` takes for this
    variant."""
    device = resolve_device(device)
    dims = [in_dim] + [hidden] * max(n_blocks - 1, 0) + [out_dim]
    params = {}
    for li, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        u = torch.rand((d_in, d_out), generator=generator)
        params[f"w{li}"] = ((2.0 * u - 1.0) * (1.0 / d_in ** 0.5)).to(device)
    return params


def _finalize(out: torch.Tensor, final_activation: str) -> torch.Tensor:
    if final_activation == "tanh":
        return torch.tanh(out)
    if final_activation == "sigmoid":
        return torch.sigmoid(out)
    return out


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              final_activation: str) -> torch.Tensor:
    """ReLU MLP with tanh / sigmoid / no output activation; a bias-free
    dict runs the fused variant (K4)."""
    if "b0" not in params:
        return fused_mlp.apply_heads([params], x, [final_activation])
    n_layers = len(params) // 2
    h = x
    for li in range(n_layers - 1):
        h = torch.relu(h @ params[f"w{li}"] + params[f"b{li}"])
    li = n_layers - 1
    return _finalize(h @ params[f"w{li}"] + params[f"b{li}"],
                     final_activation)


def decode_heads(sdf_mlp: Dict[str, torch.Tensor],
                 color_mlp: Dict[str, torch.Tensor],
                 feat: torch.Tensor) -> torch.Tensor:
    """Both heads on shared features (..., C) -> (..., 4) [r, g, b, sdf];
    fused heads in one K4 launch."""
    if "b0" not in sdf_mlp and "b0" not in color_mlp:
        return fused_mlp.apply_heads([color_mlp, sdf_mlp], feat,
                                     ["sigmoid", "tanh"])
    return torch.cat([mlp_apply(color_mlp, feat, "sigmoid"),
                      mlp_apply(sdf_mlp, feat, "tanh")], dim=-1)
