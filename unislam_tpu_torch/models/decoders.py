"""Tiny SDF / RGB MLP decoders as plain parameter dicts.

Counterpart of `unislam_tpu/models/decoders.py`, vanilla variant: biased
f32 linears with weights `w{i}` stored (d_in, d_out) and applied as
`x @ W + b`, ReLU between layers. The bias-free bf16 "fused" variant is not
ported yet and raises.
"""

from __future__ import annotations

from typing import Dict

import torch

from unislam_tpu_torch import resolve_device


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


def init_fused_mlp(*args, **kwargs):
    raise NotImplementedError("the fused (bias-free bf16) decoder variant "
                              "is not ported yet")


def _finalize(out: torch.Tensor, final_activation: str) -> torch.Tensor:
    if final_activation == "tanh":
        return torch.tanh(out)
    if final_activation == "sigmoid":
        return torch.sigmoid(out)
    return out


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              final_activation: str) -> torch.Tensor:
    """ReLU MLP with tanh / sigmoid / no output activation."""
    if "b0" not in params:
        raise NotImplementedError("the fused (bias-free bf16) decoder "
                                  "variant is not ported yet")
    n_layers = len(params) // 2
    h = x
    for li in range(n_layers - 1):
        h = torch.relu(h @ params[f"w{li}"] + params[f"b{li}"])
    li = n_layers - 1
    return _finalize(h @ params[f"w{li}"] + params[f"b{li}"],
                     final_activation)
