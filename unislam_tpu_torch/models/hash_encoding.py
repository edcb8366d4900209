"""Multiresolution hash-grid encoding (instant-ngp family), PyTorch + CUDA.

Counterpart of `unislam_tpu/models/hash_encoding.py`: the same static spec
(level scales, resolutions, dense/hashed levels, offsets into ONE flat
(total_entries, F) table) and the same encode, with output (N, L*F),
level-major.

`encode` is an autograd Function. On CUDA tensors its forward is kernel K1
and its backward kernel K2 (`csrc/hash_encode.cu`); the table gradient is
K2's (L*N*8) rows reduced by the order-independent fixed-point
scatter-accumulate kernel K9 (`kernels/scatter_accum.py`). Each has a
plain PyTorch version here, which is what runs for tensors on the CPU.
The table gradient is only formed
when the table requires a gradient (mapping); tracking freezes the scene,
so its backward computes the point gradient alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from unislam_tpu_torch import resolve_device
from unislam_tpu_torch.kernels import build
from unislam_tpu_torch.kernels.scatter_accum import scatter_accumulate

# xor-hash primes (public instant-ngp constants).
_PRIMES = (1, 2654435761, 805459861)
_MAX_LEVELS = 32


class HashGridSpec(NamedTuple):
    """Static description of a multiresolution hash grid."""
    n_levels: int
    n_features: int
    log2_hashmap_size: int
    base_resolution: int
    per_level_scale: float
    scales: np.ndarray        # (L,) float32: grid scale per level
    resolutions: np.ndarray   # (L,) int32: cells per axis per level
    offsets: np.ndarray       # (L+1,) int64: entry offset per level
    hashed: np.ndarray        # (L,) bool: True -> spatial hash, False -> dense
    level_sizes: np.ndarray   # (L,) int64: entries per level

    @property
    def total_entries(self) -> int:
        return int(self.offsets[-1])

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features


def make_spec(n_levels: int = 16, n_features: int = 2,
              log2_hashmap_size: int = 19, base_resolution: int = 16,
              desired_resolution: int = 512,
              per_level_scale: float | None = None) -> HashGridSpec:
    """Build the static spec (the JAX package's level sizes and offsets)."""
    if per_level_scale is None:
        per_level_scale = float(
            np.exp2(np.log2(desired_resolution / n_levels) / (n_levels - 1)))
    hashmap_size = 1 << log2_hashmap_size

    scales = np.float32(
        [base_resolution * per_level_scale ** l - 1.0 for l in range(n_levels)])
    resolutions = np.int32(np.ceil(scales) + 1)

    level_sizes = []
    hashed = []
    for res in resolutions:
        dense = int(res) ** 3
        if dense > hashmap_size:
            level_sizes.append(hashmap_size)
            hashed.append(True)
        else:
            level_sizes.append(-(-dense // 8) * 8)  # aligned to 8 like tcnn
            hashed.append(False)
    level_sizes = np.int64(level_sizes)
    offsets = np.concatenate([[0], np.cumsum(level_sizes)]).astype(np.int64)
    return HashGridSpec(n_levels, n_features, log2_hashmap_size,
                        base_resolution, per_level_scale, scales, resolutions,
                        offsets, np.bool_(hashed), level_sizes)


def init_table(spec: HashGridSpec, generator: torch.Generator,
               device=None) -> torch.Tensor:
    """tcnn-style U(-1e-4, 1e-4) init of the flat (total_entries, F) table,
    drawn from `generator` (a CPU generator, so the draw is the same on any
    device) and moved to `device` (CUDA unless the caller asks for
    another)."""
    device = resolve_device(device)
    t = torch.rand(spec.total_entries, spec.n_features, generator=generator)
    return (t * 2e-4 - 1e-4).to(device)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the kernels' oracle; what CPU tensors run)

# The plain versions work corner-major, (L, 8, N) with corner k = 4*bx +
# 2*by + bz (x slowest), so every elementwise pass runs over N contiguous
# values; the rows handed to the scatter are transposed to the reference's
# (L, N, 8) order at the end. Indices are int32: the CPU's vector units
# multiply int32, not int64.

def _corners_plain(spec: HashGridSpec, points: torch.Tensor):
    """(L, 8, N) int32 table rows and (L, 3, 2, N) per-axis weights
    [1 - frac, frac]."""
    dev, L = points.device, spec.n_levels
    scales = torch.as_tensor(spec.scales, device=dev).view(L, 1, 1)
    res = torch.as_tensor(spec.resolutions, device=dev).view(L, 1, 1, 1)
    # contiguous: elementwise results keep their inputs' memory layout
    p = points.clamp(0.0, 1.0).t().contiguous()                     # (3,N)
    pos = p[None] * scales + 0.5                                    # (L,3,N)
    pos_floor = torch.floor(pos)
    frac = pos - pos_floor
    step = torch.arange(2, dtype=torch.int32, device=dev).view(1, 1, 2, 1)
    c = torch.minimum(torch.clamp(pos_floor.to(torch.int32)[:, :, None]
                                  + step, min=0), res - 1)          # (L,3,2,N)
    n_dense = int(np.sum(~spec.hashed))   # coarse levels are the dense ones
    assert not spec.hashed[:n_dense].any() and spec.hashed[n_dense:].all()
    parts = []
    if n_dense:
        cd, r = c[:n_dense], res[:n_dense, 0]
        parts.append(cd[:, 0, :, None, None]
                     + (cd[:, 1] * r)[:, None, :, None]
                     + (cd[:, 2] * (r * r))[:, None, None, :])
    if n_dense < L:
        # per-axis products in int64 (exact), masked to the table's bits
        # before the xor, which commutes with the mask
        mask = (1 << spec.log2_hashmap_size) - 1
        hx, hy, hz = (((c[n_dense:, a].to(torch.int64) * _PRIMES[a]) & mask)
                      .to(torch.int32) for a in range(3))
        parts.append(hx[:, :, None, None] ^ hy[:, None, :, None]
                     ^ hz[:, None, None, :])
    idx = torch.cat(parts).view(L, 8, -1)
    sizes = torch.as_tensor(spec.level_sizes.astype(np.int32),
                            device=dev).view(L, 1, 1)
    offsets = torch.as_tensor(spec.offsets[:-1].astype(np.int32),
                              device=dev).view(L, 1, 1)
    idx = torch.minimum(idx, sizes - 1) + offsets
    return idx, torch.stack([1.0 - frac, frac], dim=2)


def _interp_weights(wl: torch.Tensor) -> torch.Tensor:
    """(L, 3, 2, N) per-axis weights -> (L, 8, N) corner weights
    wx * wy * wz."""
    L, _, _, N = wl.shape
    return (wl[:, 0, :, None, None] * wl[:, 1, None, :, None]
            * wl[:, 2, None, None, :]).view(L, 8, N)


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(L, 8, N) rows of the table -> (L, 8, N, F)."""
    return table.index_select(0, idx.reshape(-1)).view(*idx.shape, -1)


def encode_fwd_plain(table: torch.Tensor, points: torch.Tensor,
                     spec: HashGridSpec) -> torch.Tensor:
    idx, wl = _corners_plain(spec, points)
    w = _interp_weights(wl)
    out = torch.sum(w[..., None] * _gather(table, idx), dim=1)      # (L,N,F)
    return out.permute(1, 0, 2).reshape(points.shape[0], spec.out_dim)


def encode_bwd_plain(table: torch.Tensor, points: torch.Tensor,
                     g_out: torch.Tensor, spec: HashGridSpec,
                     need_points: bool = True, need_rows: bool = True):
    """Returns (g_points (N,3) or None, row_idx (L*N*8,) int32 or None,
    rows (L*N*8, F) f32 or None); rows are in the reference's (L, N, 8)
    order, to be reduced by scatter_accumulate into the table gradient."""
    N = points.shape[0]
    L, F = spec.n_levels, spec.n_features
    idx, wl = _corners_plain(spec, points)
    g = g_out.reshape(N, L, F).permute(1, 0, 2)[:, None]           # (L,1,N,F)
    g_points = row_idx = rows = None
    if need_rows:
        rows = (_interp_weights(wl)[..., None] * g).transpose(1, 2)
        rows = rows.reshape(-1, F)
        row_idx = idx.transpose(1, 2).reshape(-1)
    if need_points:
        g_w = torch.sum(_gather(table, idx) * g, dim=-1).view(L, 2, 2, 2, N)
        wx = wl[:, 0, :, None, None]
        wy = wl[:, 1, None, :, None]
        wz = wl[:, 2, None, None, :]
        # d out / d frac_a: corner values weighted by the other two axes'
        # weights, upper corner minus lower corner along axis a
        tx, ty, tz = g_w * wy * wz, g_w * wx * wz, g_w * wx * wy
        g_frac = torch.stack([
            (tx[:, 1] - tx[:, 0]).sum((1, 2)),
            (ty[:, :, 1] - ty[:, :, 0]).sum((1, 2)),
            (tz[:, :, :, 1] - tz[:, :, :, 0]).sum((1, 2))], dim=-1)  # (L,N,3)
        scales = torch.as_tensor(spec.scales, device=points.device)
        g_p = torch.sum(g_frac * scales.view(L, 1, 1), dim=0)
        inside = (points >= 0.0) & (points <= 1.0)
        g_points = torch.where(inside, g_p, torch.zeros_like(g_p))
    return g_points, row_idx, rows


# ---------------------------------------------------------------------------
# kernel wrappers (K1, K2)

class _HashLevels(ctypes.Structure):
    _fields_ = [("n_levels", ctypes.c_int), ("hash_mask", ctypes.c_uint32),
                ("scale", ctypes.c_float * _MAX_LEVELS),
                ("res", ctypes.c_int * _MAX_LEVELS),
                ("offset", ctypes.c_int * _MAX_LEVELS),
                ("size", ctypes.c_int * _MAX_LEVELS),
                ("hashed", ctypes.c_int * _MAX_LEVELS)]


@functools.lru_cache(maxsize=None)
def _levels_struct(n_levels, n_features, log2_hashmap_size, base_resolution,
                   per_level_scale) -> _HashLevels:
    spec = make_spec(n_levels, n_features, log2_hashmap_size,
                     base_resolution, per_level_scale=per_level_scale)
    lv = _HashLevels()
    lv.n_levels = n_levels
    lv.hash_mask = (1 << log2_hashmap_size) - 1
    for l in range(n_levels):
        lv.scale[l] = float(spec.scales[l])
        lv.res[l] = int(spec.resolutions[l])
        lv.offset[l] = int(spec.offsets[l])
        lv.size[l] = int(spec.level_sizes[l])
        lv.hashed[l] = int(spec.hashed[l])
    return lv


def _kernel_args(spec: HashGridSpec, table, points, *tensors):
    """Validate CUDA inputs; return (library, levels struct)."""
    if spec.n_features != 2 or spec.n_levels > _MAX_LEVELS:
        raise ValueError("the hash-encode kernels take F=2 and at most "
                         f"{_MAX_LEVELS} levels (got F={spec.n_features}, "
                         f"L={spec.n_levels})")
    if spec.total_entries >= 2 ** 31:
        raise ValueError("table too large for int32 row indices")
    for t in (table, points) + tensors:
        if t.device != points.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("hash encode: tensors must be contiguous f32 "
                             "on one CUDA device")
    if table.shape != (spec.total_entries, 2) or points.dim() != 2 \
            or points.shape[1] != 3:
        raise ValueError(f"hash encode: bad shapes table {tuple(table.shape)}"
                         f", points {tuple(points.shape)}")
    lv = _levels_struct(spec.n_levels, spec.n_features,
                        spec.log2_hashmap_size, spec.base_resolution,
                        spec.per_level_scale)
    return build.library("hash_encode"), lv


def _is_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _require_cuda(*tensors) -> None:
    if not all(t.device.type == "cuda" for t in tensors):
        raise ValueError("hash encode: tensors must all lie on the CPU or "
                         "all on a CUDA device")


def encode_fwd(table: torch.Tensor, points: torch.Tensor,
               spec: HashGridSpec) -> torch.Tensor:
    """Kernel K1 on CUDA tensors, the plain version on CPU tensors."""
    if _is_cpu(table, points):
        return encode_fwd_plain(table, points, spec)
    _require_cuda(table, points)
    lib, lv = _kernel_args(spec, table, points)
    N = points.shape[0]
    out = torch.empty(N, spec.out_dim, dtype=torch.float32,
                      device=points.device)
    fn = lib.hash_encode_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_void_p]
    err = fn(build.ptr(points), build.ptr(table), build.ptr(out), N,
             ctypes.byref(lv), build.stream_ptr(points.device))
    build.LAUNCHES["hash_encode_fwd"] += 1
    build.check(lib, err, "hash_encode_fwd")
    return out


def encode_bwd(table: torch.Tensor, points: torch.Tensor,
               g_out: torch.Tensor, spec: HashGridSpec,
               need_points: bool = True, need_rows: bool = True):
    """Kernel K2 on CUDA tensors, the plain version on CPU tensors.
    Same returns as `encode_bwd_plain`."""
    if _is_cpu(table, points, g_out):
        return encode_bwd_plain(table, points, g_out, spec, need_points,
                                need_rows)
    _require_cuda(table, points, g_out)
    lib, lv = _kernel_args(spec, table, points, g_out)
    N, L = points.shape[0], spec.n_levels
    if g_out.shape != (N, spec.out_dim):
        raise ValueError(f"hash encode: bad g_out shape {tuple(g_out.shape)}")
    dev = points.device
    g_points = (torch.empty(N, 3, dtype=torch.float32, device=dev)
                if need_points else None)
    row_idx = (torch.empty(L * N * 8, dtype=torch.int32, device=dev)
               if need_rows else None)
    rows = (torch.empty(L * N * 8, 2, dtype=torch.float32, device=dev)
            if need_rows else None)
    fn = lib.hash_encode_bwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_void_p]
    null = ctypes.c_void_p(None)
    err = fn(build.ptr(points), build.ptr(table), build.ptr(g_out),
             build.ptr(g_points) if need_points else null,
             build.ptr(row_idx) if need_rows else null,
             build.ptr(rows) if need_rows else null, N, ctypes.byref(lv),
             build.stream_ptr(dev))
    build.LAUNCHES["hash_encode_bwd"] += 1
    build.check(lib, err, "hash_encode_bwd")
    return g_points, row_idx, rows


class _Encode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, points, spec):
        ctx.spec = spec
        ctx.save_for_backward(table, points)
        return encode_fwd(table, points, spec)

    @staticmethod
    def backward(ctx, g_out):
        table, points = ctx.saved_tensors
        need_table, need_points = ctx.needs_input_grad[0], \
            ctx.needs_input_grad[1]
        g_points, row_idx, rows = encode_bwd(
            table, points, g_out.contiguous(), ctx.spec, need_points,
            need_table)
        g_table = (scatter_accumulate(row_idx, rows, table.shape[0])
                   if need_table else None)
        return g_table, g_points, None


def encode(table: torch.Tensor, points: torch.Tensor,
           spec: HashGridSpec) -> torch.Tensor:
    """Encode points (N, 3) in [0, 1] (clamped) -> features (N, L*F).
    Differentiable w.r.t. table and points."""
    return _Encode.apply(table, points.contiguous(), spec)
