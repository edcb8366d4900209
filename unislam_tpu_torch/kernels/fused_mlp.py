"""The fused decoder MLP, kernel K4 (`csrc/fused_mlp.cu`), and its plain
PyTorch version.

Replaces `unislam_tpu/models/decoders.py` `mlp_apply`, bias-free branch
(the reference's tcnn FullyFusedMLP, `grid.tcnn_network: true`): a head is
{"w0": (in_dim, 16), "w1": (16, out)} applied as bf16(x) @ bf16(W0) with
f32 sums, ReLU, bf16, @ bf16(W1), then tanh / sigmoid / nothing. One call
runs one or two heads on the same input features, each into its own
columns of one output, so the brick path decodes both heads with one
launch a direction.

The backward follows the JAX package's VJP rounding point by rounding
point (see the kernel's note): the hidden and input gradients are rounded
to bf16, ReLU's derivative is 0.5 at 0 (JAX's `max`), and two heads' input
gradients are added after each is rounded. The weight gradients are the
f32 sums over all points; their one rounding point, to bf16, is the
caller's (`round_bf16_`, in `Mapper.backward`), so that a data-parallel
run sums its ranks' sums first and rounds then, as one rank rounds the
whole batch's.

`apply_heads` is a `torch.autograd.Function`: the kernel on CUDA tensors,
the plain version on CPU tensors. The weight gradients are formed only
when a weight requires a gradient (mapping); tracking and the no-grad
probe leave them out.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Iterable, Sequence

import torch

from unislam_tpu_torch.kernels import build

HIDDEN = 16
MAX_IN = 32
MAX_OUT = 4
MAX_HEADS = 2
ACTIVATIONS = {"none": 0, "tanh": 1, "sigmoid": 2}


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def round_bf16_(tensors: Iterable[torch.Tensor]) -> None:
    """Round each tensor to bf16 in place (f32 storage): the weight
    gradients' rounding point."""
    for t in tensors:
        t.copy_(_bf16(t))


def _activate(o: torch.Tensor, act: str) -> torch.Tensor:
    if act == "tanh":
        return torch.tanh(o)
    if act == "sigmoid":
        return torch.sigmoid(o)
    return o


# ---------------------------------------------------------------------------
# plain PyTorch versions (the kernel's oracle; what CPU tensors run). A head
# is (w0, w1, activation).

def mlp_fwd_plain(x: torch.Tensor, heads: Sequence) -> torch.Tensor:
    """(N, in_dim) -> (N, sum of the heads' widths), heads in order."""
    xb = _bf16(x)
    outs = []
    for w0, w1, act in heads:
        h = _bf16(torch.relu(xb @ _bf16(w0)))
        outs.append(_activate(h @ _bf16(w1), act))
    return torch.cat(outs, dim=-1)


def mlp_bwd_plain(x: torch.Tensor, heads: Sequence, g_out: torch.Tensor,
                  need_weights: bool = True):
    """-> (g_x (N, in_dim), [(dW0, dW1) per head] or None); the weight
    gradients f32 sums, not rounded."""
    xb = _bf16(x)
    g_x, dws, col = None, [], 0
    for w0, w1, act in heads:
        w0b, w1b = _bf16(w0), _bf16(w1)
        a = xb @ w0b
        h = _bf16(torch.relu(a))
        t = _activate(h @ w1b, act)
        g = g_out[:, col:col + w1.shape[1]]
        col += w1.shape[1]
        if act == "tanh":
            w = g * (1.0 - t)
            d = w + w * t
        elif act == "sigmoid":
            d = g * (t * (1.0 - t))
        else:
            d = g
        mask = torch.where(a > 0, 1.0, torch.where(a == 0, 0.5, 0.0))
        z = _bf16(d @ w1b.t()) * mask
        gx = _bf16(z @ w0b.t())
        g_x = gx if g_x is None else g_x + gx
        if need_weights:
            dws.append((xb.t() @ z, h.t() @ d))
    return g_x, (dws if need_weights else None)


# ---------------------------------------------------------------------------
# kernel wrappers

class _Heads(ctypes.Structure):
    _fields_ = [("n_heads", ctypes.c_int), ("in_dim", ctypes.c_int),
                ("out_cols", ctypes.c_int),
                ("out_dim", ctypes.c_int * MAX_HEADS),
                ("act", ctypes.c_int * MAX_HEADS),
                ("col", ctypes.c_int * MAX_HEADS),
                ("w0", ctypes.c_void_p * MAX_HEADS),
                ("w1", ctypes.c_void_p * MAX_HEADS)]


def _heads_struct(x: torch.Tensor, heads: Sequence, *tensors) -> _Heads:
    """Validate CUDA inputs; the kernel's description of the heads."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("fused_mlp: tensors must all lie on the CPU or all "
                         "on one CUDA device")
    N, in_dim = x.shape
    if not 1 <= len(heads) <= MAX_HEADS or in_dim > MAX_IN:
        raise ValueError(f"fused_mlp: the kernel takes 1-{MAX_HEADS} heads "
                         f"and at most {MAX_IN} inputs (got {len(heads)}, "
                         f"{in_dim})")
    for t in (x, *tensors, *(w for w0, w1, _ in heads for w in (w0, w1))):
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("fused_mlp: tensors must be contiguous f32 on "
                             "one CUDA device")
    hd = _Heads()
    hd.n_heads, hd.in_dim, col = len(heads), in_dim, 0
    for i, (w0, w1, act) in enumerate(heads):
        if w0.shape != (in_dim, HIDDEN) or w1.dim() != 2 \
                or w1.shape[0] != HIDDEN or not 1 <= w1.shape[1] <= MAX_OUT:
            raise ValueError(f"fused_mlp: head {i} has shapes "
                             f"{tuple(w0.shape)}, {tuple(w1.shape)}; the "
                             f"kernel takes ({in_dim}, {HIDDEN}) and "
                             f"({HIDDEN}, 1..{MAX_OUT})")
        hd.out_dim[i], hd.act[i], hd.col[i] = w1.shape[1], ACTIVATIONS[act], \
            col
        hd.w0[i], hd.w1[i] = w0.data_ptr(), w1.data_ptr()
        col += w1.shape[1]
    hd.out_cols = col
    return hd


def _is_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _weights(heads):
    return [w for w0, w1, _ in heads for w in (w0, w1)]


def mlp_fwd(x: torch.Tensor, heads: Sequence) -> torch.Tensor:
    """Kernel K4's forward on CUDA tensors, the plain version on CPU
    tensors."""
    if _is_cpu(x, *_weights(heads)):
        return mlp_fwd_plain(x, heads)
    hd = _heads_struct(x, heads)
    out = torch.empty(x.shape[0], hd.out_cols, dtype=torch.float32,
                      device=x.device)
    lib = build.library("fused_mlp")
    fn = lib.fused_mlp_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    err = fn(build.ptr(x), x.shape[0], ctypes.byref(hd), build.ptr(out),
             build.stream_ptr(x.device))
    build.LAUNCHES["fused_mlp_fwd"] += 1
    build.check(lib, err, "fused_mlp_fwd")
    return out


def mlp_bwd(x: torch.Tensor, heads: Sequence, g_out: torch.Tensor,
            need_weights: bool = True):
    """Kernel K4's backward on CUDA tensors, the plain version on CPU
    tensors. Same arguments and returns as `mlp_bwd_plain`."""
    if _is_cpu(x, g_out, *_weights(heads)):
        return mlp_bwd_plain(x, heads, g_out, need_weights)
    hd = _heads_struct(x, heads, g_out)
    N, in_dim = x.shape
    if g_out.shape != (N, hd.out_cols):
        raise ValueError(f"fused_mlp: bad g_out shape {tuple(g_out.shape)}")
    dev = x.device
    lib = build.library("fused_mlp")
    g_x = torch.empty(N, in_dim, dtype=torch.float32, device=dev)
    sizes = [s for w0, w1, _ in heads for s in (w0.numel(), w1.numel())]
    n_wg = sum(sizes)
    partial = dw = None
    if need_weights:
        lib.fused_mlp_wgrad_blocks.argtypes = [ctypes.c_int]
        n_blocks = lib.fused_mlp_wgrad_blocks(N)
        partial = torch.empty(max(n_blocks, 1) * n_wg, dtype=torch.float32,
                              device=dev)
        dw = torch.empty(n_wg, dtype=torch.float32, device=dev)
    null = ctypes.c_void_p(None)
    fn = lib.fused_mlp_bwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    err = fn(build.ptr(x), build.ptr(g_out), N, ctypes.byref(hd),
             build.ptr(g_x), build.ptr(partial) if need_weights else null,
             build.ptr(dw) if need_weights else null, n_wg,
             build.stream_ptr(dev))
    build.LAUNCHES["fused_mlp_bwd"] += 1
    build.check(lib, err, "fused_mlp_bwd")
    if not need_weights:
        return g_x, None
    parts = torch.split(dw, sizes)
    return g_x, [(parts[2 * i].view_as(w0), parts[2 * i + 1].view_as(w1))
                 for i, (w0, w1, _) in enumerate(heads)]


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, acts, *weights):
        ctx.acts = acts
        ctx.save_for_backward(x, *weights)
        return mlp_fwd(x, list(zip(weights[0::2], weights[1::2], acts)))

    @staticmethod
    def backward(ctx, g_out):
        x, *weights = ctx.saved_tensors
        need_w = any(ctx.needs_input_grad[2:])
        g_x, dws = mlp_bwd(x, list(zip(weights[0::2], weights[1::2],
                                       ctx.acts)), g_out.contiguous(), need_w)
        g_w = [None] * len(weights)
        if need_w:
            g_w = [g if need else None for g, need in zip(
                [g for pair in dws for g in pair], ctx.needs_input_grad[2:])]
        return (g_x if ctx.needs_input_grad[0] else None, None, *g_w)


def apply_heads(params: Sequence[Dict[str, torch.Tensor]], x: torch.Tensor,
                acts: Sequence[str]) -> torch.Tensor:
    """Heads {"w0", "w1"} with activations `acts` on features x (..., C)
    -> (..., sum of the heads' widths). Differentiable w.r.t. x and the
    weights."""
    for p in params:
        if set(p) != {"w0", "w1"}:
            raise ValueError("the fused decoder has one hidden layer (w0, "
                             f"w1); got {sorted(p)}")
    lead = x.shape[:-1]
    out = _FusedMLP.apply(x.reshape(-1, x.shape[-1]).contiguous(),
                          tuple(acts), *[p[k] for p in params
                                         for k in ("w0", "w1")])
    return out.reshape(*lead, out.shape[-1])
