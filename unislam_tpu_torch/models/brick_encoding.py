"""Multiresolution BRICK encoding, PyTorch + CUDA.

Counterpart of `unislam_tpu/models/brick_encoding.py`: each level is a
lattice of bricks of 2x2x2 cells; a brick's table row holds the features of
its 3x3x3 = 27 vertices, so a point's trilinear footprint at a level lies
in one row of the flat (total_rows, 27*F) table. Coarse levels store bricks
densely, fine levels hash the brick coordinate. Output is (N, L*F),
level-major, over a static subset `levels` of the ladder.

`encode_multi` encodes several point sets, each against its own level
subset, and is an autograd Function. On CUDA tensors the forward of all
sets is one launch of kernel K5 (up to four sets a launch) and each set's
backward a launch of kernel K6 (`csrc/brick_encode.cu`); the table
gradient of ALL sets is one call of the fixed-point scatter-accumulate K9
(`kernels/scatter_accum.py`), the counterpart of `_scatter_segments`. A
band group can have its rows run-length merged per ray first (the band row
dedup, kernel K8, `kernels/band_dedup.py`). The plain PyTorch versions are
what tensors on the CPU run.

Numerics follow the JAX package: the gathered table values are rounded to
bf16 (round to nearest even) and weighted by exact f32 trilinear weights
(wx*wy)*wz; the backward rounds the output cotangent to bf16, forms the
table-gradient values as bf16(bf16(w) * bf16(g)) and the point gradient
from bf16 rows times bf16 cotangents summed in f32. A small dense level is
served by the same gather as any other (the JAX package's one-hot matmul
picks the same bf16 rows).

Only the 8 vertices of the footprint are read or written. K6 emits its
table-gradient rows as rows of the (total_rows*27, F) view of the table:
8 F-wide rows per (point, level) instead of one 27F-wide row whose other
19 vertices hold exact zeros. Both give the same table gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from unislam_tpu_torch import resolve_device
from unislam_tpu_torch.kernels import build
# dedup_rows_plain: the band row dedup's plain version, beside the
# encode's own
from unislam_tpu_torch.kernels.band_dedup import (  # noqa: F401
    dedup_rows, dedup_rows_plain)
from unislam_tpu_torch.kernels.scatter_accum import scatter_accumulate

_PRIMES = (1, 2654435761, 805459861)
_BRICK_CELLS = 2                    # cells per brick axis
_BRICK_VERTS = _BRICK_CELLS + 1     # 3 -> 27 vertices per brick
_V3 = _BRICK_VERTS ** 3
_MAX_LEVELS = 16
_KERNEL_F = 8                # the F the kernels are built for
_MAX_GROUPS = 4              # groups of one K5 launch (MAX_GROUPS in csrc)
_FWD_WARPS = 8               # warps of a K5 block (FWD_WARPS in csrc)
_FWD_POINTS = 16             # points of a K5 warp (FWD_POINTS in csrc)


class BrickSpec(NamedTuple):
    n_levels: int
    n_features: int           # features per level
    resolutions: np.ndarray   # (L,) cell-lattice resolution per level
    brick_res: np.ndarray     # (L,) brick-lattice resolution per level
    hashed: np.ndarray        # (L,) bool
    level_rows: np.ndarray    # (L,) rows in the table per level
    row_offsets: np.ndarray   # (L+1,)
    log2_hashmap_size: int
    matmul: np.ndarray = None  # (L,) bool: the JAX package's one-hot levels

    @property
    def row_dim(self) -> int:
        return _V3 * self.n_features

    @property
    def total_rows(self) -> int:
        return int(self.row_offsets[-1])

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features


def _geometric(lo: int, hi: int, n: int) -> list:
    if n == 1:
        return [int(hi)]
    scale = (hi / lo) ** (1.0 / (n - 1))
    return [int(round(lo * scale ** l)) for l in range(n)]


def make_spec(n_levels: int = 4, n_features: int = 8,
              log2_hashmap_size: int = 16, base_resolution: int = 16,
              desired_resolution: int = 816,
              matmul_max_rows: int = 0,
              matmul_hashed: int = 0,
              matmul_hashed_rows: int = 4096,
              hashed_level_rows=None) -> BrickSpec:
    """The JAX package's ladder: geometric resolutions from base to
    desired; with `matmul_max_rows > 0` level 1 snaps down so its dense
    brick count fits that budget and the rest re-spread up to
    `desired_resolution`. `matmul_hashed` caps the first N hashed levels at
    `matmul_hashed_rows` rows; `hashed_level_rows` gives the row counts of
    the other hashed levels in turn (the last entry repeats)."""
    if n_levels > 1:
        resolutions = _geometric(base_resolution, desired_resolution,
                                 n_levels)
    else:
        resolutions = [int(desired_resolution)]

    if matmul_max_rows > 0 and n_levels >= 3:
        mm_brick = int(round(matmul_max_rows ** (1.0 / 3.0)))
        mm_res = mm_brick * _BRICK_CELLS
        if resolutions[1] > mm_res > base_resolution:
            tail = _geometric(mm_res, desired_resolution, n_levels - 1)
            resolutions = [base_resolution] + tail

    resolutions = np.int32(resolutions)
    brick_res = np.int32(-(-resolutions // _BRICK_CELLS))  # ceil
    max_rows = 1 << log2_hashmap_size
    level_rows, hashed, matmul = [], [], []
    hashed_seen = 0
    gather_hashed_seen = 0
    for br in brick_res:
        dense = int(br) ** 3
        if dense > max_rows:
            hashed_seen += 1
            if hashed_seen <= matmul_hashed and matmul_max_rows > 0:
                level_rows.append(min(max_rows, matmul_hashed_rows))
                hashed.append(True)
                matmul.append(True)
            else:
                rows = max_rows
                if hashed_level_rows:
                    k = min(gather_hashed_seen, len(hashed_level_rows) - 1)
                    rows = min(int(hashed_level_rows[k]), dense)
                gather_hashed_seen += 1
                level_rows.append(rows)
                hashed.append(True)
                matmul.append(False)
        else:
            level_rows.append(dense)
            hashed.append(False)
            matmul.append(dense <= matmul_max_rows)
    level_rows = np.int64(level_rows)
    return BrickSpec(
        n_levels=n_levels, n_features=n_features,
        resolutions=resolutions, brick_res=brick_res,
        hashed=np.bool_(hashed), level_rows=level_rows,
        row_offsets=np.concatenate([[0], np.cumsum(level_rows)]).astype(
            np.int64),
        log2_hashmap_size=log2_hashmap_size,
        matmul=np.bool_(matmul))


def init_table(spec: BrickSpec, generator: torch.Generator,
               device=None) -> torch.Tensor:
    """U(-1e-4, 1e-4) init of the flat (total_rows, 27F) table, drawn from
    `generator` (a CPU generator, so the draw is the same on any device)
    and moved to `device` (CUDA unless the caller asks for another)."""
    device = resolve_device(device)
    t = torch.rand(spec.total_rows, spec.row_dim, generator=generator)
    return (t * 2e-4 - 1e-4).to(device)


def all_levels(spec: BrickSpec) -> tuple:
    return tuple(range(spec.n_levels))


def coarse_fine_split(spec: BrickSpec, mode: str = "cost") -> tuple:
    """(coarse, fine) level tuples of the surface-LOD query. "cost": fine =
    the hashed levels the JAX package serves by gather; "hashed": fine =
    every hashed level; "coarse<N>": the first N levels are coarse."""
    matmul_flags = (spec.matmul if spec.matmul is not None
                    else np.zeros(spec.n_levels, bool))
    if mode == "hashed":
        gated = [bool(spec.hashed[l]) for l in range(spec.n_levels)]
    elif mode.startswith("coarse"):
        n_coarse = int(mode[len("coarse"):])
        gated = [l >= n_coarse for l in range(spec.n_levels)]
    else:
        gated = [bool(spec.hashed[l]) and not matmul_flags[l]
                 for l in range(spec.n_levels)]
    fine = tuple(l for l in range(spec.n_levels) if gated[l])
    coarse = tuple(l for l in range(spec.n_levels) if not gated[l])
    return coarse, fine


# ---------------------------------------------------------------------------
# plain PyTorch versions (the kernels' oracle; what CPU tensors run)

# Like the hash plain versions these work corner-major, (L, 8, N) with corner
# k = 4*a + 2*b + c over the footprint's (x, y, z) offsets (x slowest), so
# elementwise passes run over N contiguous values. Rows handed to the scatter
# are in K6's (L, N, 8) order.

def _level_indices(points: torch.Tensor, spec: BrickSpec, levels: tuple):
    """Per level of `levels`: the brick's row within the level (L, N)
    int64, the in-brick cell `local` (L, 3, N) int32 in {0, 1} and the
    fractional position `frac` (L, 3, N) f32, of points already in [0, 1]
    (the JAX `_level_indices`, transposed)."""
    lv = list(levels)
    L, dev = len(lv), points.device
    res = torch.as_tensor(spec.resolutions[lv].astype(np.float32),
                          device=dev).view(L, 1, 1)
    pos = points.t().contiguous()[None] * (res - 1.0)          # (L,3,N)
    cell = torch.floor(pos).to(torch.int32)
    cell = torch.clamp(torch.minimum(cell, (res - 2).to(torch.int32)), min=0)
    frac = pos - cell
    brick = cell // _BRICK_CELLS
    local = cell - brick * _BRICK_CELLS

    b = brick.to(torch.int64)
    mask = (1 << 32) - 1
    h = ((b[:, 0] * _PRIMES[0]) & mask) ^ ((b[:, 1] * _PRIMES[1]) & mask) \
        ^ ((b[:, 2] * _PRIMES[2]) & mask)                        # uint32
    rows = torch.as_tensor(spec.level_rows[lv], device=dev).view(L, 1)
    br = torch.as_tensor(spec.brick_res[lv].astype(np.int64),
                         device=dev).view(L, 1)
    dense = torch.minimum(b[:, 0] + b[:, 1] * br + b[:, 2] * br * br,
                          rows - 1)
    hashed = torch.as_tensor(spec.hashed[lv], device=dev).view(L, 1)
    idx = torch.where(hashed, h % rows, dense)
    return idx, local, frac


def _footprint(spec: BrickSpec, points: torch.Tensor, levels: tuple):
    """(L, 8, N) int32 rows of the (total_rows*27, F) table view that the
    trilinear footprint touches, and (L, 3, 2, N) per-axis weights
    [1 - frac, frac]. Clamps the points to [0, 1]."""
    L = len(levels)
    dev = points.device
    idx, local, frac = _level_indices(points.clamp(0.0, 1.0), spec, levels)
    offsets = torch.as_tensor(spec.row_offsets[list(levels)], device=dev)
    base = ((idx + offsets.view(L, 1)) * _V3).to(torch.int32)  # (L,N)
    step = torch.arange(2, dtype=torch.int32, device=dev).view(1, 1, 2, 1)
    c = local[:, :, None] + step                                # (L,3,2,N)
    vert = (c[:, 0, :, None, None] * (_BRICK_VERTS * _BRICK_VERTS)
            + c[:, 1, None, :, None] * _BRICK_VERTS
            + c[:, 2, None, None, :])                           # (L,2,2,2,N)
    vidx = (vert + base[:, None, None, None]).view(L, 8, -1)
    return vidx, torch.stack([1.0 - frac, frac], dim=2)


def _interp_weights(wl: torch.Tensor) -> torch.Tensor:
    """(L, 3, 2, N) per-axis weights -> (L, 8, N) corner weights
    (wx * wy) * wz."""
    L, _, _, N = wl.shape
    return (wl[:, 0, :, None, None] * wl[:, 1, None, :, None]
            * wl[:, 2, None, None, :]).view(L, 8, N)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to bf16 (to nearest even) and back."""
    return x.to(torch.bfloat16).to(torch.float32)


def _gather_bf16(table: torch.Tensor, vidx: torch.Tensor,
                 F: int) -> torch.Tensor:
    """(L, 8, N) vertex rows of the table's (rows*27, F) view -> (L, 8, N,
    F) f32 values rounded to bf16."""
    vals = table.reshape(-1, F).index_select(0, vidx.reshape(-1))
    return _bf16(vals).view(*vidx.shape, F)


def encode_fwd_plain(table: torch.Tensor, points: torch.Tensor,
                     spec: BrickSpec, levels: tuple) -> torch.Tensor:
    N, L, F = points.shape[0], len(levels), spec.n_features
    vidx, wl = _footprint(spec, points, levels)
    w = _interp_weights(wl)
    out = torch.sum(w[..., None] * _gather_bf16(table, vidx, F), dim=1)
    return out.permute(1, 0, 2).reshape(N, L * F)


def encode_fwd_multi_plain(table: torch.Tensor, points_tuple, spec: BrickSpec,
                           levels_groups) -> tuple:
    """The grouped forward: per group, `encode_fwd_plain`."""
    return tuple(encode_fwd_plain(table, p, spec, lv)
                 for p, lv in zip(points_tuple, levels_groups))


def encode_bwd_plain(table: torch.Tensor, points: torch.Tensor,
                     g_out: torch.Tensor, spec: BrickSpec, levels: tuple,
                     need_points: bool = True, need_rows: bool = True):
    """Returns (g_points (N,3) or None, row_idx (L*N*8,) int32 or None,
    rows (L*N*8, F) f32 or None): rows of the (total_rows*27, F) table view
    in (L, N, 8) order, to be reduced by scatter_accumulate."""
    N, L, F = points.shape[0], len(levels), spec.n_features
    vidx, wl = _footprint(spec, points, levels)
    g_bf = _bf16(g_out.reshape(N, L, F).permute(1, 0, 2))[:, None]  # L,1,N,F
    g_points = row_idx = rows = None
    if need_rows:
        w_bf = _bf16(_interp_weights(wl))
        rows = _bf16(w_bf[..., None] * g_bf).transpose(1, 2).reshape(-1, F)
        row_idx = vidx.transpose(1, 2).reshape(-1)
    if need_points:
        g_w = torch.sum(_gather_bf16(table, vidx, F) * g_bf,
                        dim=-1).view(L, 2, 2, 2, N)
        wx = wl[:, 0, :, None, None]
        wy = wl[:, 1, None, :, None]
        wz = wl[:, 2, None, None, :]
        # d out / d frac_a: the footprint's vertex values weighted by the
        # other two axes' weights, upper vertex minus lower along axis a
        tx, ty, tz = g_w * wy * wz, g_w * wx * wz, g_w * wx * wy
        g_frac = torch.stack([
            (tx[:, 1] - tx[:, 0]).sum((1, 2)),
            (ty[:, :, 1] - ty[:, :, 0]).sum((1, 2)),
            (tz[:, :, :, 1] - tz[:, :, :, 0]).sum((1, 2))], dim=-1)  # (L,N,3)
        res_m1 = torch.as_tensor(
            spec.resolutions[list(levels)].astype(np.float32),
            device=points.device) - 1.0
        g_p = torch.sum(g_frac * res_m1.view(L, 1, 1), dim=0)
        inside = (points >= 0.0) & (points <= 1.0)
        g_points = torch.where(inside, g_p, torch.zeros_like(g_p))
    return g_points, row_idx, rows


# ---------------------------------------------------------------------------
# kernel wrappers (K5, K6)

class _BrickLevels(ctypes.Structure):
    _fields_ = [("n_levels", ctypes.c_int),
                ("res_m1", ctypes.c_float * _MAX_LEVELS),
                ("res_m2", ctypes.c_int * _MAX_LEVELS),
                ("brick_res", ctypes.c_int * _MAX_LEVELS),
                ("rows", ctypes.c_int * _MAX_LEVELS),
                ("offset", ctypes.c_int * _MAX_LEVELS),
                ("hashed", ctypes.c_int * _MAX_LEVELS)]


@functools.lru_cache(maxsize=None)
def _levels_struct(resolutions: tuple, brick_res: tuple, level_rows: tuple,
                   row_offsets: tuple, hashed: tuple,
                   levels: tuple) -> _BrickLevels:
    lv = _BrickLevels()
    lv.n_levels = len(levels)
    for k, l in enumerate(levels):
        lv.res_m1[k] = float(np.float32(resolutions[l]) - np.float32(1.0))
        lv.res_m2[k] = int(resolutions[l]) - 2
        lv.brick_res[k] = int(brick_res[l])
        lv.rows[k] = int(level_rows[l])
        lv.offset[k] = int(row_offsets[l])
        lv.hashed[k] = int(hashed[l])
    return lv


def _kernel_args(spec: BrickSpec, levels: tuple, table, points, *tensors):
    """Validate CUDA inputs; return (library, levels struct)."""
    if spec.n_features != _KERNEL_F or not levels \
            or len(levels) > _MAX_LEVELS:
        raise ValueError(f"the brick-encode kernels take F = {_KERNEL_F} "
                         f"and 1 to {_MAX_LEVELS} levels "
                         f"(got F={spec.n_features}, levels={levels})")
    if spec.total_rows * _V3 >= 2 ** 31:
        raise ValueError("table too large for int32 vertex-row indices")
    for t in (table, points) + tensors:
        if t.device != points.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("brick encode: tensors must be contiguous f32 "
                             "on one CUDA device")
    if table.shape != (spec.total_rows, spec.row_dim) or points.dim() != 2 \
            or points.shape[1] != 3:
        raise ValueError(f"brick encode: bad shapes table "
                         f"{tuple(table.shape)}, points {tuple(points.shape)}")
    lv = _levels_struct(tuple(spec.resolutions.tolist()),
                        tuple(spec.brick_res.tolist()),
                        tuple(spec.level_rows.tolist()),
                        tuple(spec.row_offsets.tolist()),
                        tuple(bool(h) for h in spec.hashed), tuple(levels))
    return build.library("brick_encode"), lv


def _is_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _require_cuda(*tensors) -> None:
    if not all(t.device.type == "cuda" for t in tensors):
        raise ValueError("brick encode: tensors must all lie on the CPU or "
                         "all on a CUDA device")


def fwd_launches(n_points, n_levels) -> list:
    """K5's grid for groups of `n_points` points at `n_levels` levels: one
    launch per `_MAX_GROUPS` groups, each (index of its first group, points
    a block covers per group, first block per group + the grid size). A
    block is `_FWD_WARPS` warps of `_FWD_POINTS` points at one level; at L
    levels it covers P = _FWD_POINTS * max(1, _FWD_WARPS // L) points, so
    a group of N = 0 points gets no blocks."""
    launches = []
    for g0 in range(0, len(n_points), _MAX_GROUPS):
        ppb = [_FWD_POINTS * max(1, _FWD_WARPS // L)
               for L in n_levels[g0:g0 + _MAX_GROUPS]]
        first = [0]
        for n, p in zip(n_points[g0:g0 + _MAX_GROUPS], ppb):
            first.append(first[-1] + -(-n // p))
        launches.append((g0, ppb, first))
    return launches


def block_group(first: list, b: int) -> int:
    """The group of block `b` of a launch whose groups start at blocks
    `first` (as the kernel finds it: the last group starting at or before
    b)."""
    return sum(b >= f for f in first[1:-1])


def encode_fwd_multi(table: torch.Tensor, points_tuple, spec: BrickSpec,
                     levels_groups) -> tuple:
    """Kernel K5 on CUDA tensors, one launch per `_MAX_GROUPS` groups; the
    plain version on CPU tensors. Features (N_k, len(levels_k)*F) per
    group."""
    if _is_cpu(table, *points_tuple):
        return encode_fwd_multi_plain(table, points_tuple, spec,
                                      levels_groups)
    _require_cuda(table, *points_tuple)
    F = spec.n_features
    lvs = []
    for p, levels in zip(points_tuple, levels_groups):
        lib, lv = _kernel_args(spec, levels, table, p)
        lvs.append(lv)
    outs = [torch.empty(p.shape[0], len(lv) * F, dtype=torch.float32,
                        device=p.device)
            for p, lv in zip(points_tuple, levels_groups)]
    fn = lib.brick_encode_fwd_multi
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] \
        + [ctypes.c_void_p] * 7
    for g0, ppb, first in fwd_launches([p.shape[0] for p in points_tuple],
                                       [len(lv) for lv in levels_groups]):
        if first[-1] == 0:
            continue
        G = len(ppb)
        group = range(g0, g0 + G)
        err = fn(build.ptr(table), F, G,
                 (ctypes.c_void_p * G)(*(points_tuple[k].data_ptr()
                                         for k in group)),
                 (ctypes.c_void_p * G)(*(outs[k].data_ptr() for k in group)),
                 (ctypes.c_int * G)(*(points_tuple[k].shape[0]
                                      for k in group)),
                 (ctypes.c_int * G)(*ppb), (ctypes.c_int * (G + 1))(*first),
                 (_BrickLevels * G)(*(lvs[k] for k in group)),
                 build.stream_ptr(table.device))
        build.LAUNCHES["brick_encode_fwd"] += 1
        build.check(lib, err, "brick_encode_fwd_multi")
    return tuple(outs)


def encode_fwd(table: torch.Tensor, points: torch.Tensor, spec: BrickSpec,
               levels: tuple) -> torch.Tensor:
    """One group of `encode_fwd_multi`: features (N, len(levels)*F)."""
    return encode_fwd_multi(table, (points,), spec, (levels,))[0]


def encode_bwd(table: torch.Tensor, points: torch.Tensor,
               g_out: torch.Tensor, spec: BrickSpec, levels: tuple,
               need_points: bool = True, need_rows: bool = True):
    """Kernel K6 on CUDA tensors, the plain version on CPU tensors. Same
    returns as `encode_bwd_plain`."""
    if _is_cpu(table, points, g_out):
        return encode_bwd_plain(table, points, g_out, spec, levels,
                                need_points, need_rows)
    _require_cuda(table, points, g_out)
    lib, lv = _kernel_args(spec, levels, table, points, g_out)
    N, L, F = points.shape[0], len(levels), spec.n_features
    if g_out.shape != (N, L * F):
        raise ValueError(f"brick encode: bad g_out shape {tuple(g_out.shape)}")
    dev = points.device
    g_points = (torch.empty(N, 3, dtype=torch.float32, device=dev)
                if need_points else None)
    row_idx = (torch.empty(L * N * 8, dtype=torch.int32, device=dev)
               if need_rows else None)
    rows = (torch.empty(L * N * 8, F, dtype=torch.float32, device=dev)
            if need_rows else None)
    fn = lib.brick_encode_bwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_void_p]
    null = ctypes.c_void_p(None)
    err = fn(build.ptr(points), build.ptr(table), build.ptr(g_out),
             build.ptr(g_points) if need_points else null,
             build.ptr(row_idx) if need_rows else null,
             build.ptr(rows) if need_rows else null, N, F, ctypes.byref(lv),
             build.stream_ptr(dev))
    build.LAUNCHES["brick_encode_bwd"] += 1
    build.check(lib, err, "brick_encode_bwd")
    return g_points, row_idx, rows


class _EncodeMulti(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, spec, levels_groups, dedup, *points):
        ctx.spec, ctx.levels_groups, ctx.dedup = spec, levels_groups, dedup
        ctx.save_for_backward(table, *points)
        return encode_fwd_multi(table, points, spec, levels_groups)

    @staticmethod
    def backward(ctx, *g_outs):
        table, *points = ctx.saved_tensors
        spec = ctx.spec
        need_table = ctx.needs_input_grad[0]
        g_points, idx_parts, row_parts = [], [], []
        for k, (p, levels, g, dd) in enumerate(zip(
                points, ctx.levels_groups, g_outs, ctx.dedup)):
            need_p = ctx.needs_input_grad[4 + k]
            if not (need_p or need_table):
                g_points.append(None)
                continue
            gp, ri, rv = encode_bwd(table, p, g.contiguous(), spec, levels,
                                    need_p, need_table)
            g_points.append(gp)
            if need_table:
                if dd is not None:    # the band row dedup (K8)
                    ri, rv = dedup_rows(ri, rv, *dd)
                idx_parts.append(ri)
                row_parts.append(rv)
        g_table = None
        if need_table:
            # every set's rows in one reduction, as _scatter_segments does
            T, D = table.shape
            g_table = scatter_accumulate(
                torch.cat(idx_parts) if len(idx_parts) > 1 else idx_parts[0],
                torch.cat(row_parts) if len(row_parts) > 1 else row_parts[0],
                T * _V3).view(T, D)
        return (g_table, None, None, None, *g_points)


def encode_multi(table: torch.Tensor, points_tuple, spec: BrickSpec,
                 levels_groups, dedup=None) -> tuple:
    """Encode several point sets (N_k, 3) against per-set level subsets
    with one fused backward: a tuple of (N_k, len(levels_k)*F) features.
    Differentiable w.r.t. the table and every point set; the table
    gradient of all sets is one scatter-accumulate.

    `dedup` (optional): per set None or an (R, K, Ku) triple. A triple
    declares the set to be R rays x K samples in z order, and its table
    rows are run-length merged to at most Ku bricks a ray before the
    scatter (the band row dedup, `kernels/band_dedup.py`); rays that cross
    more than Ku bricks drop the table gradient of their farthest runs.
    Point gradients are per sample and never change."""
    levels_groups = tuple(tuple(l) for l in levels_groups)
    dedup = (None,) * len(levels_groups) if dedup is None else tuple(
        None if dd is None else tuple(int(x) for x in dd) for dd in dedup)
    if len(dedup) != len(levels_groups):
        raise ValueError(f"encode_multi: {len(dedup)} dedup entries for "
                         f"{len(levels_groups)} point sets")
    for p, dd in zip(points_tuple, dedup):
        if dd is not None and p.shape[0] != dd[0] * dd[1]:
            raise ValueError(f"encode_multi: dedup {dd} does not fit "
                             f"{p.shape[0]} points")
    return _EncodeMulti.apply(table, spec, levels_groups, dedup,
                              *(p.contiguous() for p in points_tuple))


def encode(table: torch.Tensor, points: torch.Tensor, spec: BrickSpec,
           levels: tuple = None) -> torch.Tensor:
    """points (N, 3) in [0, 1] (clamped) -> features (N, len(levels)*F),
    over the level subset `levels` (default all). Differentiable w.r.t.
    table and points."""
    if levels is None:
        levels = all_levels(spec)
    return encode_multi(table, (points,), spec, (tuple(levels),))[0]
