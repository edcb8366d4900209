"""The sizes one iteration of the SLAM loop works on, from a frozen config.

The benchmark's own arithmetic (the kernels' bytes and operations, the
reference's grids) starts here and reads nothing of the program: the
camera crop (`intrinsics_from_cfg` in the port), the bound rounded up to
`bound_dividable`, and the hash grids' level layout (`make_spec`), each
written out again from the published definitions.
"""

from __future__ import annotations

import numpy as np

# xor-hash primes of instant-ngp
PRIMES = (1, 2654435761, 805459861)


def intrinsics(cfg: dict) -> dict:
    """The camera after `crop_size` (a rescale) and `crop_edge` (a cut)."""
    cam = cfg["cam"]
    H, W = cam["H"], cam["W"]
    fx, fy, cx, cy = cam["fx"], cam["fy"], cam["cx"], cam["cy"]
    if "crop_size" in cam:
        sy, sx = cam["crop_size"][0] / H, cam["crop_size"][1] / W
        fx, fy, cx, cy = sx * fx, sy * fy, sx * cx, sy * cy
        H, W = cam["crop_size"]
    edge = cam.get("crop_edge", 0)
    if edge > 0:
        H, W, cx, cy = H - 2 * edge, W - 2 * edge, cx - edge, cy - edge
    return {"H": int(H), "W": int(W), "fx": fx, "fy": fy, "cx": cx,
            "cy": cy}


def bound64(cfg: dict) -> np.ndarray:
    """(3, 2) world box in float64: mapping.bound with its upper ends
    moved up to a whole number of `bound_dividable` steps."""
    b = np.array(cfg["mapping"]["bound"], np.float64) * cfg.get("scale", 1)
    step = cfg["planes_res"]["bound_dividable"]
    b[:, 1] = (np.floor((b[:, 1] - b[:, 0]) / step).astype(int) + 1) \
        * step + b[:, 0]
    return b


def hash_grid(log2_size: int, voxel: float, extent: float,
              n_levels: int = 16, n_features: int = 2,
              base_res: int = 16) -> dict:
    """A multiresolution hash grid's levels: scale, resolution, first
    entry, entries and whether the level is hashed (dense levels hold
    every cell, padded to 8 entries)."""
    desired = int(extent / voxel)
    growth = float(np.exp2(np.log2(desired / n_levels) / (n_levels - 1)))
    size = 1 << log2_size
    scales = np.float32([base_res * growth ** lv - 1.0
                         for lv in range(n_levels)])
    res = np.int32(np.ceil(scales) + 1)
    hashed = [int(r) ** 3 > size for r in res]
    sizes = [size if h else -(-int(r) ** 3 // 8) * 8
             for r, h in zip(res, hashed)]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return {"L": n_levels, "F": n_features, "mask": size - 1,
            "scales": scales, "res": res, "hashed": np.bool_(hashed),
            "sizes": np.int64(sizes), "offsets": offsets[:-1],
            "T": int(offsets[-1])}


def of(cfg: dict) -> dict:
    """Every size the benchmark's arithmetic needs."""
    b = bound64(cfg)
    # the grids' resolution comes from the float64 extent (an f32 one can
    # land one cell lower)
    extent = float((b[:, 1] - b[:, 0]).max())
    g, r, t, m = cfg["grid"], cfg["rendering"], cfg["tracking"], \
        cfg["mapping"]
    S = r["n_stratified"] + r["n_importance"]
    hidden = 16
    return {
        "intr": intrinsics(cfg),
        "bound": b.astype(np.float32),
        "grids": {"sdf": hash_grid(g["hash_size_sdf"], g["voxel_sdf"],
                                   extent),
                  "color": hash_grid(g["hash_size_color"], g["voxel_color"],
                                     extent)},
        # decoders: in -> hidden -> hidden -> out, biased, f32
        "mlp": {"sdf": (32, hidden, hidden, 1), "color": (32, hidden,
                                                          hidden, 3)},
        "samples": S,
        "probe_samples": r["n_stratified"],
        "track_rays": t["pixels"],
        # the mapper's extra rays on the newest keyframes (200 a batch)
        "map_rays": m["pixels"] + m.get("extra_rays", 200),
    }
