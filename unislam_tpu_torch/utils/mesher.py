"""Mesh extraction: device-queried SDF grid -> native isosurface -> colored,
bound-culled PLY.

Counterpart of `unislam_tpu/utils/mesher.py`:
- uniform grid over marching_cubes_bound (+5 cm padding) at `resolution`;
- SDF queried on the device in 500,000-point batches under
  `torch.no_grad()` (one K1 launch per hash batch, one K5 launch per brick
  batch); out-of-bound points get sdf = -1;
- brick encoding trained with surface LOD: a two-pass grid (the coarse
  levels everywhere, the full ladder only in the dilated band around the
  coarse surface); hash encoding: a hierarchical two-pass (the full ladder
  on a stride-s subgrid, full resolution only in the dilated band);
- isosurface by the native marching-tetrahedra library (`utils/native.py`);
- vertex colors from the color field at the vertices;
- scene-bound culling against the convex hull of back-projected keyframe
  depth points and camera centers, scaled by mesh_bound_scale.

The JAX mesher builds the full float64 meshgrid on the host. Here a batch
of grid points is made on the device from the same float64 axes by
gathering from flat grid indices and casting to float32, which gives the
same points bit for bit without the full grid (at 1 cm over a 7.5 m cube
it would hold 422M float64 points, 10 GB).

`stats` records the last mesh's seconds and grid points per pass.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from unislam_tpu_torch.core import pose as pose_lib
from unislam_tpu_torch.core.rays import Intrinsics
from unislam_tpu_torch.models import brick_encoding
from unislam_tpu_torch.models import scene as scene_lib
from unislam_tpu_torch.utils import mesh_io


class SceneBound:
    """Convex hull of keyframe geometry; containment via Delaunay."""

    def __init__(self, points: np.ndarray, scale: float = 1.02):
        from scipy.spatial import ConvexHull, Delaunay
        hull = ConvexHull(points)
        hp = points[hull.vertices]
        center = hp.mean(axis=0)
        hp = center + (hp - center) * scale
        self._tri = Delaunay(hp)

    def contains(self, pts: np.ndarray) -> np.ndarray:
        return self._tri.find_simplex(pts) >= 0


class GridPoints:
    """Points of the uniform grid on `axes` (three float64 arrays), in
    C order (x slowest), or the subset at the flat grid indices `flat`.
    Indexing with a slice gives that range of points as a float32 (n, 3)
    tensor on `device`, made there from the float64 axes: the JAX mesher's
    `meshgrid(..., indexing="ij")` points, cast to float32 at the batch."""

    def __init__(self, axes, device, flat: Optional[np.ndarray] = None):
        self.axes = axes
        self.shape = tuple(len(a) for a in axes)
        self.device = device
        self.flat = flat
        self._axes_t = [torch.as_tensor(a, dtype=torch.float64).to(device)
                        for a in axes]

    def __len__(self) -> int:
        return (int(np.prod(self.shape)) if self.flat is None
                else len(self.flat))

    def take(self, flat: np.ndarray) -> "GridPoints":
        """The points at flat grid indices `flat`."""
        return GridPoints(self.axes, self.device, np.asarray(flat, np.int64))

    def __getitem__(self, sl: slice) -> torch.Tensor:
        if self.flat is None:
            start, stop, _ = sl.indices(len(self))
            flat = torch.arange(start, stop, device=self.device)
        else:
            flat = torch.as_tensor(self.flat[sl]).to(self.device)
        _, ny, nz = self.shape
        ix = torch.div(flat, ny * nz, rounding_mode="floor")
        iy = torch.div(flat, nz, rounding_mode="floor") % ny
        iz = flat % nz
        ax, ay, az = self._axes_t
        return torch.stack([ax[ix], ay[iy], az[iz]], dim=-1).to(
            torch.float32)


class Mesher:
    def __init__(self, cfg, sc: scene_lib.SceneConfig, intr: Intrinsics,
                 points_batch_size: int = 500_000):
        self.sc = sc
        self.intr = intr
        self.points_batch_size = points_batch_size
        self.resolution = cfg["meshing"]["resolution"]
        self.level_set = cfg["meshing"]["level_set"]
        self.mesh_bound_scale = cfg["meshing"]["mesh_bound_scale"]
        self.scale = cfg.get("scale", 1)
        mcb = cfg["mapping"].get("marching_cubes_bound",
                                 cfg["mapping"]["bound"])
        self.marching_cubes_bound = np.asarray(mcb, dtype=np.float64) * self.scale
        self.stats: dict = {}

        # LOD two-pass grid (brick encoding trained with surface LOD): the
        # fine levels train only inside the depth-guided band, so outside
        # it they hold untrained values that would turn into floaters.
        # Pass 1 queries the always-trained coarse levels over the whole
        # grid; pass 2 re-queries the full ladder only where the coarse
        # field is near the level set (|sdf| < coarse_band, dilated).
        r = cfg.get("rendering", {})
        meshing = cfg.get("meshing", {})
        self._coarse_levels = None
        self._coarse_band = float(meshing.get("coarse_band", 0.9))
        if (sc.encoding == "brick" and int(r.get("n_fine", 0)) > 0
                and bool(meshing.get("lod_two_pass", True))):
            coarse, fine = brick_encoding.coarse_fine_split(
                sc.brick_spec, str(r.get("lod_split", "cost")))
            if coarse and fine:
                self._coarse_levels = coarse
        self._lod_two_pass = self._coarse_levels is not None

        # Hierarchical two-pass for hash mode: the full ladder on a
        # stride-s subgrid, full resolution only inside the dilated
        # near-surface band. The trained field is tanh(sdf/truncation), so
        # the band's transition zone spans about 2 truncations, which
        # covers >= 2 coarse cells when stride * resolution <= truncation;
        # below stride 2 the pass is off (epsilon: 0.6/0.3 must give 2).
        safe_stride = int(sc.truncation / max(self.resolution, 1e-6) + 1e-9)
        self._hier_two_pass = (
            sc.encoding != "brick"
            and bool(meshing.get("hierarchical", True))
            and safe_stride >= 2)
        self._hier_band = float(meshing.get("coarse_band", 0.9))
        self._hier_stride = min(4, max(2, safe_stride))

    # ------------------------------------------------------------------
    def grid_axes(self):
        """Axis samples of the uniform grid (float64)."""
        b = self.marching_cubes_bound
        pad = 0.05
        axes = []
        for d in range(3):
            n = int(round((b[d][1] - b[d][0] + 2 * pad) / self.resolution))
            axes.append(np.linspace(b[d][0] - pad, b[d][1] + pad, n))
        return axes

    def _query(self, params, pts: torch.Tensor, sdf_only: bool,
               coarse: bool) -> torch.Tensor:
        sc = self.sc
        p_nor = scene_lib.normalize_points(sc, pts)
        if not sdf_only:
            return scene_lib.query(params, sc, p_nor)
        levels = self._coarse_levels if coarse else None
        return scene_lib.raw_sdf(params, sc, p_nor, levels=levels)[:, None]

    def eval_points(self, pts, params, sdf_only: bool = False,
                    coarse: bool = False) -> np.ndarray:
        """(N, 3) points (a numpy array or `GridPoints`) -> (N, 4)
        [r, g, b, sdf] (or (N,) sdf when `sdf_only`) with out-of-bound
        sdf = -1. `coarse` (sdf_only): query only the always-trained
        coarse LOD levels (pass 1 of the two-pass grid)."""
        dev = params["beta"].device
        bound = self.sc.bound_tensors(dev)[0].to(torch.float32)
        width = 1 if sdf_only else 4
        out = np.empty((len(pts), width), dtype=np.float32)
        bs = self.points_batch_size
        with torch.no_grad():
            for i in range(0, len(pts), bs):
                if isinstance(pts, GridPoints):
                    chunk = pts[i:i + bs]
                else:
                    chunk = torch.as_tensor(
                        np.asarray(pts[i:i + bs], np.float32)).to(dev)
                ret = self._query(params, chunk, sdf_only, coarse)
                inside = ((chunk > bound[:, 0]) &
                          (chunk < bound[:, 1])).all(dim=1)
                ret[:, width - 1] = torch.where(inside, ret[:, width - 1],
                                                -1.0)
                out[i:i + len(chunk)] = ret.cpu().numpy()
        return out[:, 0] if sdf_only else out

    def scene_bound_from_bank(self, bank,
                              subsample: int = 97) -> Optional[SceneBound]:
        """Hull of back-projected keyframe bank depths + camera centers."""
        count = int(bank.count)
        if count < 1:
            return None
        depth = bank.depth[:count].cpu().numpy()          # (K, B)
        rays_d = bank.rays_d[:count].cpu().numpy()        # (K, B, 3)
        c2w = pose_lib.cam_pose_to_matrix(bank.pose7[:count]).cpu().numpy()
        pts = []
        for k in range(count):
            d = depth[k][::subsample]
            rd = rays_d[k][::subsample]
            valid = d > 0
            world_d = rd[valid] @ c2w[k, :3, :3].T
            pts.append(c2w[k, :3, 3] + world_d * d[valid][:, None])
            pts.append(c2w[k, :3, 3][None])
        pts = np.concatenate(pts, axis=0)
        if len(pts) < 8:
            return None
        return SceneBound(pts, self.mesh_bound_scale)

    # ------------------------------------------------------------------
    def _near_band(self, sdf: np.ndarray, band: float) -> np.ndarray:
        from scipy.ndimage import binary_dilation
        return binary_dilation(np.abs(sdf - self.level_set) < band,
                               iterations=2)

    def _eval_grid_hierarchical(self, pts: GridPoints, params, shape,
                                verbose: bool = False) -> np.ndarray:
        """Hierarchical full-ladder grid eval (hash mode): stride-s coarse
        sweep, nearest-fill of the far region, full-resolution re-query
        inside the dilated near-surface band."""
        nx, ny, nz = shape
        s = self._hier_stride
        # strided subgrid, always including the last sample per axis so the
        # coarse sweep covers the full bounds
        ix = np.unique(np.r_[np.arange(0, nx, s), nx - 1])
        iy = np.unique(np.r_[np.arange(0, ny, s), ny - 1])
        iz = np.unique(np.r_[np.arange(0, nz, s), nz - 1])
        flat_c = ((ix[:, None, None] * ny + iy[None, :, None]) * nz
                  + iz[None, None, :]).ravel()
        t0 = time.perf_counter()
        sdf_c = self.eval_points(pts.take(flat_c), params,
                                 sdf_only=True).reshape(
            len(ix), len(iy), len(iz))
        t1 = time.perf_counter()
        near_c = self._near_band(sdf_c, self._hier_band)
        # nearest-neighbour upsample of the coarse field + band mask to
        # full resolution: axis i's full index maps to coarse cell i // s
        # (clipped); far cells keep the coarse, sign-correct value
        mx = np.minimum(np.arange(nx) // s, len(ix) - 1)
        my = np.minimum(np.arange(ny) // s, len(iy) - 1)
        mz = np.minimum(np.arange(nz) // s, len(iz) - 1)
        sdf = sdf_c[np.ix_(mx, my, mz)].astype(np.float32)
        idx = np.flatnonzero(near_c[np.ix_(mx, my, mz)].ravel())
        t2 = time.perf_counter()
        if verbose:
            frac = 100.0 * (len(flat_c) + len(idx)) / max(len(pts), 1)
            print(f"meshing hierarchical: coarse {len(flat_c)} + fine "
                  f"{len(idx)} of {len(pts)} grid points ({frac:.1f}%)")
        if len(idx):
            sdf.ravel()[idx] = self.eval_points(pts.take(idx), params,
                                                sdf_only=True)
        self.stats.update(
            mode="hierarchical", coarse_points=len(flat_c),
            fine_points=len(idx), pass1_s=t1 - t0, band_s=t2 - t1,
            pass2_s=time.perf_counter() - t2)
        return sdf

    def eval_grid(self, params, axes, verbose: bool = False) -> np.ndarray:
        """The SDF on the grid of `axes` (nx, ny, nz), by the pass this
        mesher's encoding calls for."""
        shape = tuple(len(a) for a in axes)
        pts = GridPoints(axes, params["beta"].device)
        n = len(pts)
        if self._lod_two_pass:
            # pass 1: coarse levels everywhere (floater-free by training)
            t0 = time.perf_counter()
            sdf = self.eval_points(pts, params, sdf_only=True,
                                   coarse=True).reshape(shape)
            t1 = time.perf_counter()
            idx = np.flatnonzero(self._near_band(
                sdf, self._coarse_band).ravel())
            t2 = time.perf_counter()
            if verbose:
                print(f"meshing two-pass: fine re-query on {len(idx)} of "
                      f"{n} grid points ({100.0 * len(idx) / max(n, 1):.1f}%)")
            if len(idx):
                # pass 2: full ladder only near the coarse surface band
                sdf.ravel()[idx] = self.eval_points(pts.take(idx), params,
                                                    sdf_only=True)
            self.stats.update(mode="lod_two_pass", coarse_points=n,
                              fine_points=len(idx), pass1_s=t1 - t0,
                              band_s=t2 - t1,
                              pass2_s=time.perf_counter() - t2)
        elif self._hier_two_pass and n >= 2_000_000:
            # below ~2M grid points the dense sweep is a couple of batches
            # anyway and small scenes are mostly near-surface band
            sdf = self._eval_grid_hierarchical(pts, params, shape, verbose)
        else:
            t0 = time.perf_counter()
            sdf = self.eval_points(pts, params,
                                   sdf_only=True).reshape(shape)
            self.stats.update(mode="dense", coarse_points=n, fine_points=0,
                              pass1_s=time.perf_counter() - t0, band_s=0.0,
                              pass2_s=0.0)
        return sdf

    # ------------------------------------------------------------------
    def get_mesh(self, mesh_out_file: str, params, bank=None,
                 color: bool = True, verbose: bool = False) -> Optional[str]:
        """Extract, color, cull and save the mesh; returns its path, or
        None when the level set has no surface."""
        from unislam_tpu_torch.utils.native import marching_tetrahedra

        self.stats = {"grid_points": 0}
        axes = self.grid_axes()
        self.stats["grid_points"] = int(np.prod([len(a) for a in axes]))
        sdf = self.eval_grid(params, axes, verbose)
        if not ((sdf > self.level_set).any() and (sdf < self.level_set).any()):
            print("marching: no surface crossing at the level set")
            return None

        t0 = time.perf_counter()
        verts_idx, faces = marching_tetrahedra(sdf, float(self.level_set))
        del sdf
        self.stats["marching_s"] = time.perf_counter() - t0
        self.stats["marching_vertices"] = len(verts_idx)
        if len(faces) == 0:
            print("marching: empty mesh")
            return None
        # grid-index -> world coordinates
        origin = np.array([axes[0][0], axes[1][0], axes[2][0]])
        spacing = np.array([axes[0][1] - axes[0][0], axes[1][1] - axes[1][0],
                            axes[2][1] - axes[2][0]])
        vertices = origin + verts_idx * spacing

        t0 = time.perf_counter()
        vertex_colors = None
        if color:
            vertex_colors = self.eval_points(vertices, params)[:, :3]
        self.stats["color_s"] = time.perf_counter() - t0

        vertices = vertices / self.scale

        # cull outside the keyframe-visible hull
        t0 = time.perf_counter()
        if bank is not None:
            sb = self.scene_bound_from_bank(bank)
            if sb is not None:
                keep_v = sb.contains(vertices)
                keep_f = keep_v[faces].all(axis=1)
                faces = faces[keep_f]
                vertices, faces, vertex_colors = mesh_io.remove_unreferenced(
                    vertices, faces, vertex_colors)
                if len(faces) == 0:
                    print("marching: mesh fully outside scene bound")
                    return None
        self.stats["bound_cull_s"] = time.perf_counter() - t0

        os.makedirs(os.path.dirname(mesh_out_file) or ".", exist_ok=True)
        mesh_io.write_ply(mesh_out_file, vertices, faces, vertex_colors)
        self.stats.update(vertices=len(vertices), faces=len(faces))
        if verbose:
            print(f"Saved mesh at {mesh_out_file} "
                  f"({len(vertices)} verts, {len(faces)} faces)")
        return mesh_out_file
