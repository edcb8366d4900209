"""Volume compositing of a ray's samples (kernel K3).

Counterpart of `unislam_tpu/render/renderer.py`: `sdf2alpha` (:80-82),
`_exclusive_cumprod_weights` (:85-104), the five sums of `render_rays`
(:206-211) and the no-depth probe's weights (:151-160). Per ray, over its
S samples in z order:

    alpha_i = 1 - exp(-beta * sigmoid(-beta * sdf_i))
    w_i     = alpha_i * T_i,   T_i = prod_{j<i} (1 - alpha_j + 1e-10)
    rgb = sum w c,  depth D = sum w z,  term = sum w,
    unc = (1 - term)^2,  std = sqrt(sum w (D - z)^2)

The backward never divides by a factor (1 - alpha + 1e-10), which is
1e-10 where alpha saturates at 1 (beta |sdf| large): it walks the samples
from the last one down,

    d alpha_k = T_k (g_w_k - A_k),
    A_k = g_w_{k+1} alpha_{k+1} + (1 - alpha_{k+1} + 1e-10) A_{k+1},

and the plain version's cumulative product (`_NonzeroCumprod`) takes the
same division-free form. A cotangent the caller does not pass (None:
`depth_std` and `pixel_unc` in the SLAM loop) is a term the backward
skips, as JAX's symbolic zero is: a ray whose weights are all zero has
std = 0, and g_std / (2 std) would be NaN. Where a caller passes g_std,
the result follows `jax.vjp`, NaN or inf at std = 0 included.

`composite` and `probe_weights` take the plain version for CPU tensors and
launch the kernel (`csrc/composite.cu`) for CUDA tensors, with no fallback;
each launch adds one to `build.LAUNCHES["composite_fwd"]` (forward and
probe) or `["composite_bwd"]`.
"""

from __future__ import annotations

import ctypes

import torch

from unislam_tpu_torch.kernels import build

MAX_S = 64         # the kernel's largest sample count (csrc/composite.cu)
_RAYS = 8          # rays (warps) a block of the backward: one dbeta partial
                   # each, then the launch's completion counter (one more)


def sdf2alpha(sdf: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """alpha = 1 - exp(-beta * sigmoid(-beta * sdf))."""
    return 1.0 - torch.exp(-beta * torch.sigmoid(-sdf * beta))


class _NonzeroCumprod(torch.autograd.Function):
    """`torch.cumprod` over the last axis of a tensor with no zeros. Its
    backward needs no host read (torch's own first checks for zeros on the
    host, which would make every iteration wait for the device) and no
    division: d out_i / d x_j = out_{j-1} prod_{j<k<=i} x_k, summed over
    i >= j from the last index down."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        S = x.shape[-1]
        grads = [None] * S
        b = g[..., S - 1]
        for j in range(S - 1, 0, -1):
            grads[j] = out[..., j - 1] * b
            b = g[..., j - 1] + x[..., j] * b
        grads[0] = b
        return torch.stack(grads, dim=-1)


def exclusive_cumprod_weights(alpha: torch.Tensor) -> torch.Tensor:
    """w_i = alpha_i * prod_{j<i}(1 - alpha_j + 1e-10); the factors are at
    least 1e-10 since alpha <= 1, so the product has no zero factor. (The
    JAX package forms the same product by log2(S) shifted multiplies.)"""
    shifted = torch.cat([torch.ones_like(alpha[..., :1]),
                         1.0 - alpha[..., :-1] + 1e-10], dim=-1)
    return alpha * _NonzeroCumprod.apply(shifted)


def composite_plain(raw: torch.Tensor, z_vals: torch.Tensor,
                    beta: torch.Tensor):
    """Plain PyTorch K3: raw (R, S, 4) [r, g, b, sdf], z_vals (R, S), beta
    (0-d or (1,)) -> (rgb (R, 3), depth (R,), term (R,), unc (R,),
    std (R,)). Differentiable w.r.t. raw and beta."""
    weights = exclusive_cumprod_weights(sdf2alpha(raw[..., 3], beta))
    rgb = torch.sum(weights[..., None] * raw[..., :3], dim=-2)
    depth = torch.sum(weights * z_vals, dim=-1)
    term = torch.sum(weights, dim=-1)
    unc = torch.square(1.0 - term)
    std = torch.sqrt(
        torch.sum(weights * torch.square(depth[..., None] - z_vals), dim=-1))
    return rgb, depth, term, unc, std


def probe_weights_plain(sdf: torch.Tensor, z_vals: torch.Tensor,
                        beta: torch.Tensor):
    """Plain PyTorch K3 in probe mode: sdf (R, S), z_vals (R, S) -> (w
    (R, S), sum w z (R,)), without gradients."""
    with torch.no_grad():
        w = exclusive_cumprod_weights(sdf2alpha(sdf, beta))
        return w, torch.sum(w * z_vals, dim=-1)


def _check(what: str, x: torch.Tensor, z_vals: torch.Tensor,
           beta: torch.Tensor, channels: int) -> None:
    """Raise unless x is (R, S, channels) (or (R, S) for channels 0),
    z_vals (R, S) and beta one value, all float32 on one device, with
    1 <= S <= MAX_S."""
    if not (x.dtype == z_vals.dtype == beta.dtype == torch.float32):
        raise TypeError(f"{what}: float32 only (got {x.dtype}, "
                        f"{z_vals.dtype}, {beta.dtype})")
    shape = (*z_vals.shape, channels) if channels else tuple(z_vals.shape)
    if z_vals.dim() != 2 or tuple(x.shape) != shape or beta.numel() != 1:
        raise ValueError(f"{what}: shapes {tuple(x.shape)}, "
                         f"{tuple(z_vals.shape)}, {tuple(beta.shape)} do not "
                         "fit (R, S[, 4]), (R, S), one beta")
    if not 1 <= z_vals.shape[1] <= MAX_S:
        raise ValueError(f"{what}: S = {z_vals.shape[1]} samples a ray; the "
                         f"kernel takes 1 to {MAX_S}")
    if not x.device == z_vals.device == beta.device:
        raise ValueError(f"{what}: tensors on {x.device}, {z_vals.device}, "
                         f"{beta.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: CUDA or CPU tensors only (got "
                         f"{x.device})")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data does not start on 16 bytes (the
    kernel reads a sample's [r, g, b, sdf] as one float4)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _lib():
    lib = build.library("composite")
    lib.composite_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p] * 6
    lib.composite_probe.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    lib.composite_bwd.argtypes = [ctypes.c_void_p] * 11 \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int] \
        + [ctypes.c_void_p] * 2
    return lib


class _Composite(torch.autograd.Function):
    """K3 forward and backward on CUDA tensors. Grads are not materialised:
    an output without a cotangent is a term the backward skips."""

    @staticmethod
    def forward(ctx, raw, z_vals, beta):
        lib = _lib()
        ctx.set_materialize_grads(False)
        ctx.beta_shape = beta.shape
        raw, z_vals = _aligned(raw.contiguous()), z_vals.contiguous()
        beta = beta.reshape(1).contiguous()
        R, S = z_vals.shape
        rgb = raw.new_empty(R, 3)
        depth, term, unc, std = (raw.new_empty(R) for _ in range(4))
        if R:
            err = lib.composite_fwd(
                build.ptr(raw), build.ptr(z_vals), build.ptr(beta), R, S,
                build.ptr(rgb), build.ptr(depth), build.ptr(term),
                build.ptr(unc), build.ptr(std), build.stream_ptr(raw.device))
            build.LAUNCHES["composite_fwd"] += 1
            build.check(lib, err, "composite_fwd")
        ctx.save_for_backward(raw, z_vals, beta, depth, term, std)
        return rgb, depth, term, unc, std

    @staticmethod
    def backward(ctx, g_rgb, g_depth, g_term, g_unc, g_std):
        raw, z_vals, beta, depth, term, std = ctx.saved_tensors
        R, S = z_vals.shape
        d_raw = torch.empty_like(raw)
        d_beta = raw.new_zeros(1) if R == 0 else raw.new_empty(1)
        if R:
            lib = _lib()
            gs = [None if g is None else g.contiguous()
                  for g in (g_rgb, g_depth, g_term, g_unc, g_std)]
            n_part = -(-R // _RAYS)
            partial = raw.new_empty(n_part + 1)
            err = lib.composite_bwd(
                build.ptr(raw), build.ptr(z_vals), build.ptr(beta),
                build.ptr(depth), build.ptr(term), build.ptr(std),
                *(None if g is None else build.ptr(g) for g in gs), R, S,
                build.ptr(d_raw), build.ptr(partial), n_part,
                build.ptr(d_beta), build.stream_ptr(raw.device))
            build.LAUNCHES["composite_bwd"] += 1
            build.check(lib, err, "composite_bwd")
        return d_raw, None, d_beta.reshape(ctx.beta_shape)


def composite(raw: torch.Tensor, z_vals: torch.Tensor, beta: torch.Tensor):
    """K3 on CUDA tensors, the plain version on CPU tensors; same returns
    as `composite_plain`. z_vals take no gradient."""
    _check("composite", raw, z_vals, beta, 4)
    if z_vals.requires_grad and torch.is_grad_enabled():
        raise ValueError("composite: z_vals take no gradient")
    if raw.device.type == "cpu":
        return composite_plain(raw, z_vals, beta)
    return _Composite.apply(raw, z_vals, beta)


def probe_weights(sdf: torch.Tensor, z_vals: torch.Tensor,
                  beta: torch.Tensor):
    """K3's probe mode on CUDA tensors, the plain version on CPU tensors;
    same returns as `probe_weights_plain`. No gradient flows."""
    _check("probe_weights", sdf, z_vals, beta, 0)
    if sdf.device.type == "cpu":
        return probe_weights_plain(sdf, z_vals, beta)
    return _probe_kernel(sdf, z_vals, beta)


def _probe_kernel(sdf, z_vals, beta):
    """K3's probe mode on CUDA tensors: one launch, nothing saved."""
    lib = _lib()
    sdf, z_vals = sdf.detach().contiguous(), z_vals.detach().contiguous()
    beta = beta.detach().reshape(1).contiguous()
    R, S = z_vals.shape
    w, depth = torch.empty_like(sdf), sdf.new_empty(R)
    if R:
        err = lib.composite_probe(
            build.ptr(sdf), build.ptr(z_vals), build.ptr(beta), R, S,
            build.ptr(w), build.ptr(depth), build.stream_ptr(sdf.device))
        build.LAUNCHES["composite_fwd"] += 1
        build.check(lib, err, "composite_probe")
    return w, depth
