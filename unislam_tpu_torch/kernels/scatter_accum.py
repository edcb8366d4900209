"""Deterministic scatter-accumulate `out[idx[i]] += upd[i]` (kernel K9).

Port of the Pallas kernel `examples/pallas_scatter_accum.py:
scatter_accumulate`: sort the destinations, then reduce each run of equal
destinations in f32 (`csrc/scatter_accum.cu`). It carries the table
gradients of the hash-grid backward (rows of 2) and of the brick backward
(F-wide vertex rows). Updates stay f32 (the Pallas version rounds them to
bf16; the hash path's rows are f32 and unrounded).
"""

from __future__ import annotations

import ctypes

import torch

from unislam_tpu_torch.kernels import build


def scatter_accumulate_plain(idx: torch.Tensor, upd: torch.Tensor,
                             n_rows: int) -> torch.Tensor:
    """Plain PyTorch version: stable sort, permute, then a sequential f32
    sum over each run (segment_reduce) in sorted order."""
    D = upd.shape[1]
    out = torch.zeros(n_rows, D, dtype=torch.float32, device=upd.device)
    if idx.numel() == 0:
        return out
    keys, order = torch.sort(idx, stable=True)
    upd_s = upd.index_select(0, order).to(torch.float32)
    heads, counts = torch.unique_consecutive(keys, return_counts=True)
    sums = torch.segment_reduce(upd_s, "sum", lengths=counts, axis=0)
    keep = (heads >= 0) & (heads < n_rows)
    out[heads[keep].long()] = sums[keep]
    return out


def scatter_accumulate(idx: torch.Tensor, upd: torch.Tensor,
                       n_rows: int) -> torch.Tensor:
    """(M,) int32 destinations, (M, D) f32 updates -> (n_rows, D) f32.

    Deterministic: each destination sums its updates in their original
    order. Destinations outside [0, n_rows) are dropped. CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if idx.device.type == "cpu" and upd.device.type == "cpu":
        return scatter_accumulate_plain(idx, upd, n_rows)
    if idx.device.type != "cuda" or upd.device != idx.device:
        raise ValueError("scatter_accumulate: idx and upd must lie on one "
                         f"CUDA device or on the CPU (got {idx.device}, "
                         f"{upd.device})")
    if idx.dtype != torch.int32 or upd.dtype != torch.float32:
        raise TypeError("scatter_accumulate: idx must be int32 and upd "
                        f"float32 (got {idx.dtype}, {upd.dtype})")
    if idx.dim() != 1 or upd.dim() != 2 or upd.shape[0] != idx.shape[0]:
        raise ValueError(f"scatter_accumulate: shapes {tuple(idx.shape)} "
                         f"and {tuple(upd.shape)} do not match")
    M, D = upd.shape
    out = torch.zeros(n_rows, D, dtype=torch.float32, device=upd.device)
    if M == 0:
        return out
    keys, order = torch.sort(idx, stable=True)
    upd_s = upd.index_select(0, order).contiguous()
    lib = build.library("scatter_accum")
    fn = lib.scatter_accumulate_sorted
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    err = fn(build.ptr(keys), build.ptr(upd_s), M, D, n_rows, build.ptr(out),
             build.stream_ptr(upd.device))
    build.LAUNCHES["scatter_accumulate"] += 1
    build.check(lib, err, "scatter_accumulate")
    return out
