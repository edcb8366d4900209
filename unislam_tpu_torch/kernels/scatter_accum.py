"""Order-independent scatter-accumulate `out[idx[i]] += upd[i]` (kernel K9).

Port of the Pallas kernel `examples/pallas_scatter_accum.py:
scatter_accumulate`. It carries the table gradients of the hash-grid
backward (rows of 2) and of the brick backward (F-wide vertex rows).

The sum is taken in fixed point, so it is exact and does not depend on the
order of the rows: the kernel (`csrc/scatter_accum.cu`, atomics in any
order) and the plain version below give bitwise the same result on every
run, in every row order and on every card. For each destination k:

1. `e_k`: the largest frexp exponent of its finite non-zero terms, over all
   D columns (the exponent of the largest finite |term|);
2. `s_k = 62 - e_k - h_k` with `h_k = ceil(log2(c_k))`, `c_k` its number of
   terms, so that no int64 sum of its terms can overflow;
3. each finite term becomes `q = round_half_even(v * 2^s_k)` as int64
   (the product is exact in f64); a non-finite term adds 0;
4. the q of each (destination, column) are summed in int64;
5. the sum goes to f64, is scaled by `2^-s_k` (exact), and rounds to f32.

Each column then follows IEEE rules for its non-finite terms, as the
reference's `.at[idx].add` does: NaN if a term is NaN or if both a +inf and
a -inf term are present, +-inf if only infinite terms of one sign are
(whatever its finite terms), else the fixed-point sum (which rounds to
+-inf past the f32 range). The kernel ORs each column's classes into one
word per destination, which does not depend on the order either. The
result is within one f32 ulp of the exact sum plus `c_k * 2^(e_k + h_k -
63)`, at most 2^(2 h_k - 62) of the destination's largest term.
Destinations outside [0, n_rows) are dropped; untouched rows are 0.
Updates stay f32 (the Pallas version rounds them to bf16).
"""

from __future__ import annotations

import ctypes

import torch

from unislam_tpu_torch.kernels import build

_ABS_BITS = 0x7FFFFFFF      # an f32's bits without its sign
_INF_BITS = 0x7F800000      # |bits| at or above this: inf or NaN


def _pow2(s: torch.Tensor) -> torch.Tensor:
    """2^s as f64, exactly, for integer s in [-1022, 1023]: the exponent
    field written directly (exp2 need not be exact)."""
    return ((s.to(torch.int64) + 1023) << 52).view(torch.float64)


def scatter_accumulate_plain(idx: torch.Tensor, upd: torch.Tensor,
                             n_rows: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel's fixed-point sum (the same
    steps, so the two agree bit for bit)."""
    D = upd.shape[1]
    dev = upd.device
    keep = (idx >= 0) & (idx < n_rows)
    if not bool(keep.all()):
        idx, upd = idx[keep], upd[keep]
    idx = idx.long()
    upd = upd.to(torch.float32)
    # 1. per destination: largest finite |term| (as its bits; finite
    # non-zero terms are 1 .. 0x7f7fffff, inf and NaN above) and count of
    # terms
    bits = upd.view(torch.int32) & _ABS_BITS
    finite = bits < _INF_BITS
    row_bits = torch.where(finite, bits, 0).amax(1)
    top = torch.zeros(n_rows, dtype=torch.int32, device=dev)
    top.scatter_reduce_(0, idx, row_bits, "amax", include_self=True)
    count = torch.bincount(idx, minlength=n_rows)
    e = torch.frexp(top.view(torch.float32).double()).exponent.to(
        torch.int64)
    h = torch.frexp((count - 1).clamp(min=0).double()).exponent.to(
        torch.int64)
    s = 62 - e - h
    # 2. finite terms to int64 (a non-finite term adds 0), summed per
    # (destination, column)
    q = torch.round(torch.where(finite, upd, 0.0).double()
                    * _pow2(s)[idx][:, None]).to(torch.int64)
    acc = torch.zeros(n_rows, D, dtype=torch.int64, device=dev)
    acc.index_add_(0, idx, q)
    # 3. back to f32
    out = (acc.double() * _pow2(-s)[:, None]).to(torch.float32)
    if bool(finite.all()):
        return out
    # 4. per (destination, column), IEEE rules for the non-finite terms:
    # how many NaN, +inf and -inf terms it received
    inf = bits == _INF_BITS
    classes = torch.stack([bits > _INF_BITS, inf & (upd > 0),
                           inf & (upd < 0)], dim=-1).to(torch.int32)
    seen = torch.zeros(n_rows, D, 3, dtype=torch.int32, device=dev)
    seen.index_add_(0, idx, classes)
    nan, pinf, ninf = (seen > 0).unbind(-1)
    out = torch.where(pinf, float("inf"), out)
    out = torch.where(ninf, float("-inf"), out)
    return torch.where(nan | (pinf & ninf), float("nan"), out)


def scatter_accumulate(idx: torch.Tensor, upd: torch.Tensor,
                       n_rows: int) -> torch.Tensor:
    """(M,) int32 destinations, (M, D) f32 updates -> (n_rows, D) f32.

    Exact fixed-point sum per destination, independent of the row order
    (see the module note). CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
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
    if D not in (2, 8):
        raise ValueError("scatter_accumulate: the kernel takes rows of 2 "
                         f"(hash) or 8 (brick) values (got {D})")
    dev = upd.device
    idx, upd = idx.contiguous(), upd.contiguous()
    if upd.data_ptr() % 16:          # the kernel reads rows as float2/float4
        upd = upd.clone()
    # per destination: (largest finite |term| bits, count) and the columns'
    # non-finite classes, in one zeroed buffer; and the int64 sums
    meta = torch.zeros(3 * n_rows, dtype=torch.int32, device=dev)
    cls = meta[2 * n_rows:]
    acc = torch.zeros(n_rows, D, dtype=torch.int64, device=dev)
    out = torch.empty(n_rows, D, dtype=torch.float32, device=dev)
    lib = build.library("scatter_accum")
    fn = lib.scatter_accumulate_fixed
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    err = fn(build.ptr(idx), build.ptr(upd), M, D, n_rows, build.ptr(meta),
             build.ptr(cls), build.ptr(acc), build.ptr(out),
             build.stream_ptr(dev))
    build.LAUNCHES["scatter_accumulate"] += 1
    build.check(lib, err, "scatter_accumulate")
    return out
