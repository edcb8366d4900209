"""Mesh culling: remove faces not visible from any (estimated) camera.

Counterpart of `unislam_tpu/tools/cull_mesh.py`, on the port's native
library (`utils/native.py`):

- `cull_mesh` (here): per-frame frustum + (optionally) depth-consistency
  test over the whole trajectory; faces whose three vertices are never
  visible are dropped. Writes `<name>_culled.ply` next to the input.
- out-of-bound culling lives in `utils/mesher.py` (`Mesher` drops
  out-of-hull vertices at extraction time): it is part of meshing, not a
  separate pass.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from unislam_tpu_torch.utils import mesh_io
from unislam_tpu_torch.utils.native import frustum_visibility


def cull_mesh(mesh_file: str, cfg, intr, frames=None,
              estimate_c2w_list: Optional[np.ndarray] = None,
              eval_rec: bool = False, verbose: bool = False) -> str:
    """frames: sequence yielding (color, depth, gt_c2w) per index (a dataset
    or the SLAM's frame source); poses come from estimate_c2w_list when
    given."""
    truncation = cfg["model"]["truncation"]
    vertices, faces, colors = mesh_io.read_ply(mesh_file)

    if estimate_c2w_list is not None:
        n_imgs = len(estimate_c2w_list)
    else:
        n_imgs = len(frames)

    ever_visible = np.zeros(len(vertices), dtype=bool)
    for i in range(n_imgs):
        if frames is not None:
            _, depth, gt_c2w = frames[i]
        else:
            depth, gt_c2w = None, None
        c2w = (estimate_c2w_list[i] if estimate_c2w_list is not None
               else gt_c2w)
        if not np.isfinite(c2w).all():
            continue
        w2c = np.linalg.inv(np.asarray(c2w, np.float64)).astype(np.float32)
        vis = frustum_visibility(
            vertices, w2c, intr.fx, intr.fy, intr.cx, intr.cy, intr.W,
            intr.H, depth_img=(np.asarray(depth) if eval_rec else None),
            trunc=truncation)
        ever_visible |= vis

    # keep the faces with at least one vertex seen in some frame (a face
    # whose three vertices were never visible is removed)
    keep_f = ever_visible[faces].any(axis=1)
    faces = faces[keep_f]
    vertices, faces, colors = mesh_io.remove_unreferenced(vertices, faces,
                                                          colors)

    ext = mesh_file.split(".")[-1]
    out = mesh_file[:-len(ext) - 1] + "_culled." + ext
    mesh_io.write_ply(out, vertices, faces,
                      colors.astype(np.float32) / 255.0
                      if colors is not None else None)
    if verbose:
        print(f"culled mesh -> {out} ({len(vertices)} verts)")
    return out


def main():
    import argparse

    from unislam_tpu_torch.config import load_config
    from unislam_tpu_torch.data.datasets import get_dataset
    from unislam_tpu_torch.engine.slam import intrinsics_from_cfg

    parser = argparse.ArgumentParser(description="Cull a mesh against the "
                                     "trajectory frustums.")
    parser.add_argument("config", type=str)
    parser.add_argument("--input_mesh", type=str, required=True)
    parser.add_argument("--eval_rec", action="store_true")
    args = parser.parse_args()
    cfg = load_config(args.config, "configs/UNISLAM.yaml")
    intr = intrinsics_from_cfg(cfg)
    frames = get_dataset(cfg)
    cull_mesh(args.input_mesh, cfg, intr, frames=frames,
              eval_rec=args.eval_rec, verbose=True)


if __name__ == "__main__":
    main()
