"""Adam with bf16 moment state for the grid tables (`mapping.adam_state_dtype:
bfloat16`).

Counterpart of `unislam_tpu/core/optim.py`: `_sr_round`,
`scale_by_adam_lp` and `adam_lp`, together with what the JAX mapper does
after them (`optax.scale(-lr)`, then the phase's `* lr_scale`,
`unislam_tpu/engine/mapper.py:249-263`, then `p + u`). All arithmetic is
f32; only the stored moments are bf16, by stochastic rounding. Per
element, in this order:

    mf = m*b1 + g*(1-b1)
    vf = v*b2 + (g*g)*(1-b2)
    upd = (mf/bc1) / (sqrt(vf/bc2) + eps)
    p = p + (upd * (-lr)) * lr_scale

`AdamLP` steps CUDA leaves with kernel K7 (`kernels/adam_lp.py`) and CPU
leaves with `adam_lp_plain`; both give the JAX package's bits. The plain
version also takes the JAX optimiser's other two storages (f32 moments;
bf16 by round-to-nearest-even), which the mapper never asks for, so that
the tests can hold the shared arithmetic to JAX in every mode. A leaf's
random bits come from its flat row-major index, the step count and its
index k in its parameter group (the JAX `multi_transform` group's leaf
order), so the stored moments match JAX bit for bit.

Two details follow the reference's code, not its comments:
- the guard at `optim.py:65-67` keeps the f32 bits of an inf or NaN and
  truncates them, so a NaN whose payload lies only in its low 16 bits is
  stored as +-inf;
- round-to-nearest stores a NaN as XLA converts it: sign | 0x7FC0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from unislam_tpu_torch.kernels import adam_lp as k7

_M32 = 0xFFFFFFFF


class StepScalars(NamedTuple):
    """One leaf's step constants, each an f32 value (as a Python float) or
    a uint32 salt, computed once on the host."""
    b1: float
    c1: float           # f32(1 - b1), as the reference's `(1.0 - b1)`
    b2: float
    c2: float
    bc1: float          # 1 - b1**count, as XLA forms it in f32
    bc2: float
    eps: float
    neg_lr: float       # optax.scale(-lr)
    lr_scale: float
    salt_m: int
    salt_v: int


def _f32(x) -> float:
    return float(np.float32(x))


def step_scalars(count: int, k: int, lr: float, lr_scale: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8) -> StepScalars:
    """The constants of step `count` (1-based) for leaf `k` of its group.

    The bias corrections are `1 - f32(b)**count` in f32, the power taken in
    float64 and rounded once: equal bit for bit to XLA's f32 pow for every
    count a mapping phase reaches (tests/test_torch_optim.py)."""
    one = np.float32(1.0)
    bc1 = one - np.float32(float(np.float32(b1)) ** count)
    bc2 = one - np.float32(float(np.float32(b2)) ** count)
    salt = ((count * 2654435761) & _M32) ^ 0x9E3779B9
    leaf = salt ^ ((0x61C88647 * (2 * k + 1)) & _M32)
    return StepScalars(_f32(b1), _f32(1.0 - b1), _f32(b2), _f32(1.0 - b2),
                       float(bc1), float(bc2), _f32(eps), _f32(-lr),
                       _f32(lr_scale), leaf, leaf ^ 0xA5A5A5A5)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the kernel's oracle; what CPU leaves run). uint32
# arithmetic is done in int64 with a mask after every step.

def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 `a` in [0, 2^32) and a 32-bit constant
    `c`: `a` split into 16-bit halves, so no product passes 2^49."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & _M32


def _bits(x: torch.Tensor) -> torch.Tensor:
    """An f32 tensor's bits as int64 in [0, 2^32)."""
    return x.contiguous().view(torch.int32).to(torch.int64) & _M32


def _to_bf16(hi: torch.Tensor) -> torch.Tensor:
    """int64 bf16 bit patterns in [0, 2^16) -> a bf16 tensor."""
    hi = torch.where(hi >= 0x8000, hi - 0x10000, hi)
    return hi.to(torch.int16).view(torch.bfloat16)


def sr_round_plain(x: torch.Tensor, salt: int,
                   offset: int = 0) -> torch.Tensor:
    """f32 -> bf16 by stochastic rounding (`_sr_round`, optim.py:43-69):
    the low 16 bits of a murmur3-style finaliser of (flat index *
    0x9E3779B1) ^ salt are added to the f32 bits, which are then
    truncated; an inf or NaN keeps its bits. The flat index of x's first
    element is `offset` (x a row block of a larger leaf)."""
    bits = _bits(x)
    idx = torch.arange(offset, offset + x.numel(), dtype=torch.int64,
                       device=x.device).view(x.shape)
    h = _mul32(idx, 0x9E3779B1) ^ salt
    h = _mul32(h ^ (h >> 16), 0x85EBCA6B)
    h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
    h = h ^ (h >> 16)
    safe = (bits & 0x7F800000) != 0x7F800000
    up = torch.where(safe, bits + (h & 0xFFFF), bits)
    return _to_bf16(up >> 16)


def rtn_bf16_plain(x: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 round-to-nearest-even, a NaN as sign | 0x7FC0 (XLA's
    conversion, the reference's `astype(bfloat16)`)."""
    bits = _bits(x)
    rne = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16
    nan = (bits & 0x7FFFFFFF) > 0x7F800000
    return _to_bf16(torch.where(nan, ((bits >> 16) & 0x8000) | 0x7FC0, rne))


def adam_lp_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                  v: torch.Tensor, s: StepScalars,
                  stochastic_round: bool = True, offset: int = 0):
    """One leaf's step -> (p', m', v'), the moments in m's dtype (bf16 or
    f32). `offset`: the flat index of p's first element in the whole leaf
    (the stochastic rounding hashes it). Every op rounds as IEEE f32: the divisors are 0-dim tensors on
    the leaf's device (PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal), and the square root is taken in f64 and
    rounded once, which is the correctly rounded f32 root (PyTorch's
    vectorised f32 sqrt on AVX-512 CPUs is off by an ulp on about 0.7% of
    inputs)."""
    dev = p.device
    bc1, bc2 = (torch.tensor(b, dtype=torch.float32, device=dev)
                for b in (s.bc1, s.bc2))
    gf = g.float()
    mf = m.float() * s.b1 + gf * s.c1
    vf = v.float() * s.b2 + (gf * gf) * s.c2
    root = torch.sqrt((vf / bc2).double()).float()
    upd = (mf / bc1) / (root + s.eps)
    p_new = p + (upd * s.neg_lr) * s.lr_scale
    if m.dtype == torch.float32:
        return p_new, mf, vf
    if stochastic_round:
        return p_new, sr_round_plain(mf, s.salt_m, offset), \
            sr_round_plain(vf, s.salt_v, offset)
    return p_new, rtn_bf16_plain(mf), rtn_bf16_plain(vf)


class AdamLP(torch.optim.Optimizer):
    """Adam whose moments are stored in bf16 by stochastic rounding (the
    JAX mapper's `adam_lp(state_dtype=bfloat16)`). Each group's step count
    is a Python int (no host sync); its updates are
    `upd * (-lr) * lr_scale`, as the JAX mapper scales them. A leaf without
    a gradient is skipped. The state is fresh with the optimiser, as the
    JAX mapper's is each phase. A group's `offset` is the flat index of
    its leaves' first element in the whole leaf (a row block of a
    row-sharded table; 0 otherwise)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, lr_scale: float = 1.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      lr_scale=lr_scale, count=0, offset=0))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            group["count"] += 1
            b1, b2 = group["betas"]
            for k, p in enumerate(group["params"]):
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["m"] = torch.zeros(p.shape, dtype=torch.bfloat16,
                                          device=p.device)
                    st["v"] = torch.zeros_like(st["m"])
                s = step_scalars(group["count"], k, group["lr"],
                                 group["lr_scale"], b1, b2, group["eps"])
                off = group["offset"]
                if p.device.type == "cpu":
                    new = adam_lp_plain(p, p.grad, st["m"], st["v"], s,
                                        offset=off)
                    for t, n in zip((p, st["m"], st["v"]), new):
                        t.copy_(n)
                else:
                    k7.adam_lp_step(p, p.grad, st["m"], st["v"], s, off)
