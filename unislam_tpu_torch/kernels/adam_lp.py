"""Adam step with bf16 moment state by stochastic rounding, kernel K7
(`csrc/adam_lp.cu`).

Replaces `unislam_tpu/core/optim.py`: `_sr_round` + `scale_by_adam_lp` +
`adam_lp`, with the JAX mapper's `* lr_scale` and `apply_updates`. One
launch steps one leaf in place. Its plain version is
`unislam_tpu_torch.core.optim.adam_lp_plain` (same bits), which
`AdamLP` runs for CPU leaves; this wrapper takes CUDA tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from unislam_tpu_torch.kernels import build


class _Scalars(ctypes.Structure):
    _fields_ = [(name, ctypes.c_float) for name in (
        "b1", "c1", "b2", "c2", "bc1", "bc2", "eps", "neg_lr", "lr_scale")] \
        + [("salt_m", ctypes.c_uint32), ("salt_v", ctypes.c_uint32)]


def adam_lp_step(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, s, offset: int = 0) -> None:
    """Kernel K7: p, m, v updated in place from g with the step constants
    `s` (`core.optim.StepScalars`). p, g f32 and m, v bf16, all
    contiguous, of one shape, on one CUDA device. `offset`: the flat
    index of p's first element in the whole leaf (a row block of a
    row-sharded table), which the stochastic rounding hashes."""
    dev = p.device
    if dev.type != "cuda" or any(t.device != dev for t in (g, m, v)):
        raise ValueError("adam_lp_step: p, g, m, v must lie on one CUDA "
                         "device")
    if (p.dtype, g.dtype, m.dtype, v.dtype) != (torch.float32,) * 2 + (
            torch.bfloat16,) * 2:
        raise TypeError("adam_lp_step: p, g must be f32 and m, v bf16 (got "
                        f"{p.dtype}, {g.dtype}, {m.dtype}, {v.dtype})")
    if not all(t.shape == p.shape and t.is_contiguous()
               for t in (g, m, v)) or not p.is_contiguous():
        raise ValueError("adam_lp_step: p, g, m, v must be contiguous and "
                         "of one shape")
    n = p.numel()
    if offset < 0 or offset + n > 2 ** 32:
        raise ValueError("adam_lp_step: the flat index is 32-bit")
    # the kernel reads 4 elements at a time: 16 bytes of f32, 8 of bf16
    if any(t.data_ptr() % (4 * t.element_size()) for t in (p, g, m, v)):
        raise ValueError("adam_lp_step: tensors must be aligned to 4 "
                         "elements")
    sc = _Scalars(*s)
    lib = build.library("adam_lp")
    fn = lib.adam_lp_step
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [
        ctypes.c_void_p, ctypes.c_void_p]
    err = fn(build.ptr(p), build.ptr(g), build.ptr(m), build.ptr(v), n,
             offset, ctypes.byref(sc), build.stream_ptr(dev))
    build.LAUNCHES["adam_lp"] += 1
    build.check(lib, err, "adam_lp")
