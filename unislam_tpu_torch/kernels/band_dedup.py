"""Band row dedup of the brick backward's table-gradient rows (kernel K8).

Counterpart of `unislam_tpu/models/brick_encoding.py: _dedup_rows`. A band
group's points are R rays x K samples in z order, so the samples of one ray
that fall in the same brick form consecutive runs. Per (level, ray) the
run's rows are summed into one brick's worth of rows before the K9
scatter, and at most Ku runs a ray are kept: the farthest runs of a ray
that crosses more than Ku bricks lose their table gradient.

The sums follow the reference's formula, not a plain per-run sum, so the
two agree bit for bit:

1. a run is a stretch of consecutive samples with the same brick row
   (`row_idx // 27`; a hash collision between two bricks is one run);
2. a 27 x F f32 prefix S per ray: slot (v, f) is the brick's vertex v
   (`row_idx % 27`) and feature f; each sample in turn adds its 8 vertex
   rows into their slots, and S is never reset;
3. at the end of run u < Ku: `bf16(P_u - P_{u-1})` for every slot, P_u the
   prefix at run u's last sample, P_{-1} = 0 (round to nearest even,
   stored as f32);
4. a slot u past the ray's last run is `P_last - P_last`: zero, or NaN
   where the prefix is not finite, at the brick row of the ray's last
   sample.

An inf term makes its slot NaN in every later run and unused slot of the
ray (inf - inf), as in the reference. Untouched slots are +0 (the
reference's can be -0).

Layout: the input is K6's (L, N = R*K, 8) vertex rows of the
(total_rows*27, F) table view; the output (L, R, Ku, 27) vertex rows with
index `brick_row * 27 + v`, fixed whatever the run count.
"""

from __future__ import annotations

import ctypes

import torch

from unislam_tpu_torch.kernels import build

_V3 = 27          # vertices of a brick (3x3x3)
_KERNEL_F = 8     # the F the kernel is built for
_FOOT = 8         # vertex rows a sample adds (its trilinear footprint)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _check_shapes(row_idx, rows, R: int, K: int, Ku: int) -> int:
    """The group's level count L (0 for a group of no rays); raises on
    shapes that do not fit."""
    if not 1 <= Ku <= K or R < 0:
        raise ValueError(f"band dedup: need 1 <= Ku <= K (got R={R}, K={K}, "
                         f"Ku={Ku})")
    if row_idx.dim() != 1 or rows.dim() != 2 \
            or rows.shape[0] != row_idx.shape[0]:
        raise ValueError(f"band dedup: shapes {tuple(row_idx.shape)} and "
                         f"{tuple(rows.shape)} do not match")
    per_level = R * K * _FOOT
    if row_idx.shape[0] % max(per_level, 1) \
            or (per_level == 0 and row_idx.shape[0]):
        raise ValueError(f"band dedup: {row_idx.shape[0]} rows are not L x "
                         f"{R} rays x {K} samples x {_FOOT}")
    return row_idx.shape[0] // per_level if per_level else 0


def _empty(n: int, F: int, device):
    return (torch.empty(n, dtype=torch.int32, device=device),
            torch.empty(n, F, dtype=torch.float32, device=device))


def dedup_rows_plain(row_idx: torch.Tensor, rows: torch.Tensor, R: int,
                     K: int, Ku: int):
    """Plain PyTorch version of K8: (L*R*K*8,) int32 destinations and
    (L*R*K*8, F) f32 rows -> (L*R*Ku*27,) int32 and (L*R*Ku*27, F) f32.
    The prefix is a loop over k (a scan could add in another order)."""
    L = _check_shapes(row_idx, rows, R, K, Ku)
    F = rows.shape[1]
    dev = rows.device
    if L == 0:
        return _empty(0, F, dev)
    ri = row_idx.view(L, R, K, _FOOT).long()
    rv = rows.to(torch.float32).view(L, R, K, _FOOT, F)
    brick = ri[..., 0] // _V3                                  # (L,R,K)
    slot = (ri % _V3)[..., None].expand(-1, -1, -1, -1, F)
    S = torch.zeros(L, R, _V3, F, dtype=torch.float32, device=dev)
    prefix = []
    for k in range(K):
        S = S + torch.zeros_like(S).scatter_(2, slot[:, :, k], rv[:, :, k])
        prefix.append(S)
    prefix = torch.stack(prefix, dim=2)                        # (L,R,K,27,F)
    new = torch.ones_like(brick, dtype=torch.bool)
    new[..., 1:] = brick[..., 1:] != brick[..., :-1]
    rank = torch.cumsum(new.long(), dim=-1) - 1                # (L,R,K)
    u = torch.arange(Ku, device=dev)
    # run u's last sample (the ray's last for u past its runs) and first
    # sample (clipped to the ray's last likewise); rank is non-decreasing
    last = (rank[..., None] <= u).sum(2) - 1                   # (L,R,Ku)
    first = (rank[..., None] < u).sum(2).clamp(max=K - 1)
    P = torch.gather(prefix, 2, last[..., None, None].expand(
        -1, -1, -1, _V3, F))                                   # (L,R,Ku,27,F)
    diff = P - torch.cat([torch.zeros_like(P[:, :, :1]), P[:, :, :-1]], 2)
    b_u = torch.gather(brick, 2, first)                        # (L,R,Ku)
    idx = b_u[..., None] * _V3 + torch.arange(_V3, device=dev)
    return (idx.to(torch.int32).reshape(-1),
            _bf16(diff).reshape(-1, F))


def dedup_rows(row_idx: torch.Tensor, rows: torch.Tensor, R: int, K: int,
               Ku: int):
    """K8 on CUDA tensors, the plain version on CPU tensors; same returns
    as `dedup_rows_plain`. One launch for all the group's levels."""
    if row_idx.device.type == "cpu" and rows.device.type == "cpu":
        return dedup_rows_plain(row_idx, rows, R, K, Ku)
    if row_idx.device.type != "cuda" or rows.device != row_idx.device:
        raise ValueError("band dedup: row_idx and rows must lie on one CUDA "
                         f"device or on the CPU (got {row_idx.device}, "
                         f"{rows.device})")
    if row_idx.dtype != torch.int32 or rows.dtype != torch.float32:
        raise TypeError("band dedup: row_idx must be int32 and rows float32 "
                        f"(got {row_idx.dtype}, {rows.dtype})")
    L = _check_shapes(row_idx, rows, R, K, Ku)
    F = rows.shape[1]
    if F != _KERNEL_F:
        raise ValueError(f"band dedup: the kernel takes rows of {_KERNEL_F} "
                         f"(got {F})")
    dev = rows.device
    idx_out, rows_out = _empty(L * R * Ku * _V3, F, dev)
    if L == 0:
        return idx_out, rows_out
    row_idx, rows = row_idx.contiguous(), rows.contiguous()
    lib = build.library("band_dedup")
    fn = lib.band_dedup
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    err = fn(build.ptr(row_idx), build.ptr(rows), build.ptr(idx_out),
             build.ptr(rows_out), L * R, K, Ku, F, build.stream_ptr(dev))
    build.LAUNCHES["band_dedup"] += 1
    build.check(lib, err, "band_dedup")
    return idx_out, rows_out
