"""Reconstruction + rendering evaluation.

Counterpart of `unislam_tpu/tools/eval_recon.py` (no open3d, trimesh or
torchmetrics):

- 3D metrics (accuracy / completion / completion-ratio in cm) via KD-trees
  over area-weighted surface samples, with optional point-to-point ICP
  alignment (`calc_3d_metric`).
- 2D depth-L1 over random interior views, both meshes rendered by the
  native z-buffer rasterizer (`calc_2d_metric`).
- Rendering metrics every 5th frame: PSNR / MS-SSIM / depth-L1, plus LPIPS
  when pretrained AlexNet weights are locally available (nothing is
  downloaded), each frame rendered by the port's `render_img` on the map's
  device (`eval_rendering`). The rendered RGB is written by the port's PNG
  codec; the coloured uncertainty map needs matplotlib's colour map and is
  skipped without it (the metrics never are).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
from scipy.spatial import cKDTree


# ---------------------------------------------------------------------------
# point sampling / ICP
# ---------------------------------------------------------------------------

def sample_surface(vertices: np.ndarray, faces: np.ndarray, n: int,
                   seed: int = 0) -> np.ndarray:
    """Area-weighted uniform samples on a triangle mesh."""
    rng = np.random.default_rng(seed)
    v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    probs = areas / areas.sum()
    tri = rng.choice(len(faces), size=n, p=probs)
    u = rng.random(n)
    v = rng.random(n)
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    return (v0[tri] + u[:, None] * (v1[tri] - v0[tri])
            + v[:, None] * (v2[tri] - v0[tri]))


def icp_align(src: np.ndarray, dst: np.ndarray, threshold: float = 0.1,
              iters: int = 20) -> np.ndarray:
    """Point-to-point ICP: transformation aligning src onto dst."""
    tree = cKDTree(dst)
    T = np.eye(4)
    cur = src.copy()
    for _ in range(iters):
        d, idx = tree.query(cur)
        m = d < threshold
        if m.sum() < 10:
            break
        p = cur[m]
        q = dst[idx[m]]
        pc, qc = p.mean(0), q.mean(0)
        H = (p - pc).T @ (q - qc)
        U, _, Vt = np.linalg.svd(H)
        S = np.eye(3)
        if np.linalg.det(Vt.T @ U.T) < 0:
            S[2, 2] = -1
        R = Vt.T @ S @ U.T
        t = qc - R @ pc
        step = np.eye(4)
        step[:3, :3] = R
        step[:3, 3] = t
        T = step @ T
        cur = cur @ R.T + t
        if np.linalg.norm(step - np.eye(4)) < 1e-7:
            break
    return T


# ---------------------------------------------------------------------------
# 3D metrics
# ---------------------------------------------------------------------------

def accuracy(gt_points, rec_points):
    d, _ = cKDTree(gt_points).query(rec_points)
    return np.mean(d)


def completion(gt_points, rec_points):
    d, _ = cKDTree(rec_points).query(gt_points)
    return np.mean(d)


def completion_ratio(gt_points, rec_points, dist_th=0.01):
    d, _ = cKDTree(rec_points).query(gt_points)
    return np.mean((d < dist_th).astype(float))


def calc_3d_metric(rec_meshfile: str, gt_meshfile: str, align: bool = True,
                   num_points: int = 450_000, dist_th: float = 0.01):
    """accuracy / completion / completion-ratio in cm."""
    from unislam_tpu_torch.utils.mesh_io import read_ply

    rec_v, rec_f, _ = read_ply(rec_meshfile)
    gt_v, gt_f, _ = read_ply(gt_meshfile)

    if align:
        T = icp_align(rec_v, gt_v)
        rec_v = rec_v @ T[:3, :3].T + T[:3, 3]

    rec_pc = sample_surface(rec_v, rec_f, num_points)
    gt_pc = sample_surface(gt_v, gt_f, num_points)
    acc = accuracy(gt_pc, rec_pc) * 100
    comp = completion(gt_pc, rec_pc) * 100
    ratio = completion_ratio(gt_pc, rec_pc, dist_th) * 100
    results = {"accuracy": round(acc, 2), "completion": round(comp, 2),
               "completion ratio": round(ratio, 2)}
    print("accuracy: ", results["accuracy"])
    print("completion: ", results["completion"])
    print(f"completion ratio < {dist_th}: ", results["completion ratio"])
    return results


# ---------------------------------------------------------------------------
# 2D depth metric
# ---------------------------------------------------------------------------

def _viewmatrix(forward, up, origin):
    f = forward / np.linalg.norm(forward)
    right = np.cross(f, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, f)
    c2w = np.eye(4)
    # OpenGL camera: -z forward
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -f
    c2w[:3, 3] = origin
    return c2w


def calc_2d_metric(rec_meshfile: str, gt_meshfile: str, align: bool = True,
                   n_imgs: int = 1000, seed: int = 0):
    """Depth-L1 (cm) between gt and reconstructed meshes rendered from
    random interior views. Views that would see the 'unseen' gt region
    (<gt>_pc_unseen.npy) are resampled."""
    from unislam_tpu_torch.utils.mesh_io import read_ply
    from unislam_tpu_torch.utils.native import rasterize_depth

    H = W = 500
    fx = fy = 300.0
    cx = cy = H / 2.0 - 0.5

    gt_v, gt_f, _ = read_ply(gt_meshfile)
    rec_v, rec_f, _ = read_ply(rec_meshfile)
    unseen_file = gt_meshfile.replace("_culled.ply", "_pc_unseen.npy")
    pc_unseen = (np.load(unseen_file)
                 if unseen_file != gt_meshfile and os.path.exists(unseen_file)
                 else None)

    if align:
        T = icp_align(rec_v, gt_v)
        rec_v = rec_v @ T[:3, :3].T + T[:3, 3]

    # interior sampling volume: shrunk gt bbox (axis-aligned), raised a bit
    lo, hi = gt_v.min(0), gt_v.max(0)
    center = (lo + hi) / 2
    ext = (hi - lo) * np.array([0.3, 0.7, 0.7]) / 2
    center[2] += 0.4

    nprng = np.random.default_rng(seed)
    errors = []
    attempts = 0
    # the resampling is bounded, and views that never pass the unseen-region
    # test are SKIPPED, not kept (keeping them would leak unseen geometry
    # into the metric)
    budget = n_imgs * 50
    while len(errors) < n_imgs and attempts < budget:
        attempts += 1
        origin = center + nprng.uniform(-1, 1, 3) * ext
        target = nprng.uniform(-10000, 10000, 3)
        c2w = _viewmatrix(target - origin, np.array([0.0, 0.0, -1.0]),
                          origin)
        if pc_unseen is not None and _sees(pc_unseen, c2w, fx, fy, cx,
                                           cy, W, H):
            continue
        w2c = np.linalg.inv(c2w)
        gt_depth = rasterize_depth(gt_v, gt_f, w2c, fx, fy, cx, cy, W, H)
        rec_depth = rasterize_depth(rec_v, rec_f, w2c, fx, fy, cx, cy, W, H)
        errors.append(np.abs(gt_depth - rec_depth).mean())

    if len(errors) < n_imgs:
        print(f"calc_2d_metric: only {len(errors)}/{n_imgs} valid views "
              f"within the {budget}-attempt budget (rest skipped)")
    if not errors:
        # None (JSON null), not NaN: json.dumps would emit the non-standard
        # `NaN` token and a NaN silently poisons any averaging downstream
        return {"Depth L1: ": None}
    depth_l1 = float(np.mean(errors) * 100)
    print("Depth L1: ", depth_l1)
    return {"Depth L1: ": depth_l1}


def _sees(points, c2w, fx, fy, cx, cy, W, H):
    """Do any points project into the view?"""
    from unislam_tpu_torch.utils.native import frustum_visibility
    c2w = c2w.copy()
    # y/z flipped before the test (it expects the dataset pose convention)
    c2w[:3, 1] *= -1
    c2w[:3, 2] *= -1
    w2c = np.linalg.inv(c2w)
    return frustum_visibility(points, w2c, fx, fy, cx, cy, W, H).any()


# ---------------------------------------------------------------------------
# rendering metrics
# ---------------------------------------------------------------------------

def _gaussian_kernel(size=11, sigma=1.5):
    x = np.arange(size) - size // 2
    g = np.exp(-x ** 2 / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g)


def _ssim_pair(a, b, data_range=1.0):
    """Per-channel SSIM mean + contrast-structure term (for MS-SSIM)."""
    from scipy.signal import fftconvolve
    k = _gaussian_kernel()
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2

    def filt(x):
        return np.stack([fftconvolve(x[..., c], k, mode="valid")
                         for c in range(x.shape[-1])], axis=-1)

    mu_a, mu_b = filt(a), filt(b)
    mu_a2, mu_b2, mu_ab = mu_a ** 2, mu_b ** 2, mu_a * mu_b
    s_a = filt(a * a) - mu_a2
    s_b = filt(b * b) - mu_b2
    s_ab = filt(a * b) - mu_ab
    cs = (2 * s_ab + C2) / (s_a + s_b + C2)
    ssim = ((2 * mu_ab + C1) / (mu_a2 + mu_b2 + C1)) * cs
    return float(ssim.mean()), float(cs.mean())


def ms_ssim(img_a: np.ndarray, img_b: np.ndarray,
            data_range: float = 1.0) -> float:
    """Multi-scale SSIM (Wang et al. 2003), standard 5-level weights."""
    import math

    weights = [0.0448, 0.2856, 0.3001, 0.2363, 0.1333]
    a = img_a.astype(np.float64)
    b = img_b.astype(np.float64)
    # adapt level count to image size (each level needs >= 11 px after
    # downsampling), renormalizing weights — full 5 levels for real frames,
    # graceful degradation for tiny test images
    max_levels = max(1, min(5, int(math.log2(min(a.shape[:2]) / 11)) + 1))
    weights = list(np.asarray(weights[:max_levels])
                   / np.sum(weights[:max_levels]))

    def down(x):
        h, w = x.shape[0] // 2 * 2, x.shape[1] // 2 * 2
        x = x[:h, :w]
        return 0.25 * (x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2]
                       + x[1::2, 1::2])

    vals = []
    for li in range(max_levels):
        ssim, cs = _ssim_pair(a, b, data_range)
        vals.append(ssim if li == max_levels - 1 else cs)
        if li < max_levels - 1:
            a, b = down(a), down(b)
    vals = np.clip(vals, 0, None)
    return float(np.prod([v ** w for v, w in zip(vals, weights)]))


class _NativeLPIPS:
    """LPIPS(alex) without the `lpips`/`torchvision` packages: the AlexNet
    conv stack + per-layer linear calibration, loaded from a LOCAL weights
    file (nothing is downloaded).

    Weight file format (torch.save'd dict):
      {"features": <torchvision alexnet `.features` state_dict>,
       "lins": [5 tensors of shape (1, C_i, 1, 1)]}   C_i = 64,192,384,256,256
    Produce it once on an internet-connected machine:
      sd = torchvision.models.alexnet(weights="DEFAULT").features.state_dict()
      lp = lpips.LPIPS(net="alex")
      torch.save({"features": sd,
                  "lins": [l.model[-1].weight.data for l in lp.lins]}, path)

    The metric of torchmetrics' LPIPS-alex: ImageNet-normalized input,
    features after each of the 5 ReLUs, channel-unit-normalization,
    calibrated squared differences, spatial mean, layer sum.
    """

    # torchvision alexnet .features conv indices and the ReLU tap points
    _CONVS = (0, 3, 6, 8, 10)

    def __init__(self, weights_path: str):
        import torch
        blob = torch.load(weights_path, map_location="cpu",
                          weights_only=True)
        feats, lins = blob["features"], blob["lins"]
        self.conv_w = [feats[f"{i}.weight"].float() for i in self._CONVS]
        self.conv_b = [feats[f"{i}.bias"].float() for i in self._CONVS]
        self.lins = [w.float().reshape(1, -1, 1, 1) for w in lins]
        # lpips scaling layer constants (input in [-1, 1])
        self.shift = torch.tensor([-0.030, -0.088, -0.188]).view(1, 3, 1, 1)
        self.scale = torch.tensor([0.458, 0.448, 0.450]).view(1, 3, 1, 1)
        # conv hyperparams of torchvision alexnet features
        self.stride = (4, 1, 1, 1, 1)
        self.pad = (2, 2, 1, 1, 1)
        self.pool_after = (0, 1)  # maxpool3x3/2 after relu0 and relu1

    def _features(self, x):
        import torch.nn.functional as F
        outs = []
        for li in range(5):
            x = F.conv2d(x, self.conv_w[li], self.conv_b[li],
                         stride=self.stride[li], padding=self.pad[li])
            x = F.relu(x)
            outs.append(x)
            if li in self.pool_after:
                x = F.max_pool2d(x, 3, 2)
        return outs

    def __call__(self, a, b):
        """a, b: (1, 3, H, W) torch tensors in [-1, 1]."""
        import torch
        with torch.no_grad():
            fa = self._features((a - self.shift) / self.scale)
            fb = self._features((b - self.shift) / self.scale)
            total = 0.0
            for xa, xb, lin in zip(fa, fb, self.lins):
                na = xa / (xa.square().sum(1, keepdim=True).sqrt() + 1e-10)
                nb = xb / (xb.square().sum(1, keepdim=True).sqrt() + 1e-10)
                d = (na - nb).square()
                total = total + (d * lin).sum(1).mean()
        return total


def lpips_weights_path() -> Optional[str]:
    """Local LPIPS weight-file lookup: $UNISLAM_LPIPS_WEIGHTS, then the
    default cache location."""
    cand = [os.environ.get("UNISLAM_LPIPS_WEIGHTS", "")]
    cand.append(os.path.expanduser("~/.cache/unislam/lpips_alex.pt"))
    for p in cand:
        if p and os.path.exists(p):
            return p
    return None


def try_lpips():
    """LPIPS needs pretrained AlexNet weights, and only a local weights
    file is used (see _NativeLPIPS): nothing is downloaded. Returns None,
    reported as 'unavailable', not silently dropped, when there is none."""
    path = lpips_weights_path()
    if path is not None:
        try:
            return _NativeLPIPS(path)
        except Exception as e:
            print(f"lpips: failed to load local weights {path}: {e}")
    return None


def eval_rendering(slam, output: str, every: int = 5,
                   save_images: bool = True, timings: Optional[dict] = None):
    """Render every `every`-th frame at the estimated poses (`render_img`
    on the map's device, no perturbation, a generator seeded 123) and
    compute PSNR / MS-SSIM / (LPIPS) / depth-L1 against the frames.
    `timings`, when given, gets the images rendered and `render_img`'s
    seconds over them (to the rendered depth and colour on the host)."""
    import time

    import cv2
    import torch

    from unislam_tpu_torch.core import rng
    from unislam_tpu_torch.render import renderer as renderer_lib
    from unislam_tpu_torch.utils.plots import pyplot

    os.makedirs(f"{output}/rendered_image", exist_ok=True)
    os.makedirs(f"{output}/rendered_uncertainty", exist_ok=True)

    lpips_model = try_lpips()
    psnr_sum = ssim_sum = lpips_sum = depth_l1 = 0.0
    frame_cnt = 0
    rc = slam.rc._replace(perturb=False)
    gen = rng.generator(123, slam.device)
    for idx in range(0, slam.n_img, every):
        color, depth, _ = slam.dataset[idx]
        t0 = time.perf_counter()
        r_depth, r_color, term, unc, depth_std = renderer_lib.render_img(
            slam.params, slam.sc, rc, slam.intr, slam.est_c2w[idx], gen,
            gt_depth=depth)
        r_depth = r_depth.cpu().numpy()
        r_color = r_color.cpu().numpy()
        if timings is not None:
            timings["images"] = timings.get("images", 0) + 1
            timings["render_s"] = (timings.get("render_s", 0.0)
                                   + time.perf_counter() - t0)

        if save_images:
            cv2.imwrite(f"{output}/rendered_image/frame_{idx:05d}.png",
                        cv2.cvtColor((r_color * 255).astype(np.uint8),
                                     cv2.COLOR_RGB2BGR))
            plt = pyplot()
            if plt is not None:
                unc_img = np.clip(depth_std.cpu().numpy(), 0, 1.0)
                colored = (plt.get_cmap("jet")(unc_img)[..., :3] * 255
                           ).astype(np.uint8)
                cv2.imwrite(
                    f"{output}/rendered_uncertainty/frame_{idx:05d}.png",
                    cv2.cvtColor(colored, cv2.COLOR_RGB2BGR))

        valid = depth > 0
        mse = float(np.mean((color[valid] - r_color[valid]) ** 2))
        psnr_sum += -10.0 * np.log10(mse)
        ssim_sum += ms_ssim(color, r_color)
        if lpips_model is not None:
            with torch.no_grad():
                lpips_sum += float(lpips_model(
                    torch.from_numpy(color).permute(2, 0, 1)[None].float()
                    * 2 - 1,
                    torch.from_numpy(r_color).permute(2, 0, 1)[None].float()
                    * 2 - 1))
        depth_l1 += float(np.abs(depth[valid] - r_depth[valid]).mean())
        frame_cnt += 1

    results = {
        "avg_ms_ssim": round(ssim_sum / frame_cnt, 4),
        "avg_psnr": round(psnr_sum / frame_cnt, 4),
        # avg_lpips stays type-stable (float or JSON null); why it is
        # missing goes in a separate note key
        "avg_lpips": (round(lpips_sum / frame_cnt, 4)
                      if lpips_model is not None else None),
        "depth_l1_render": round(depth_l1 / frame_cnt, 4),
    }
    if lpips_model is None:
        results["lpips_note"] = "unavailable (no local weights)"
    print(results)
    with open(os.path.join(output, "output.txt"), "a") as f:
        f.write(json.dumps(results) + "\n\n")
    return results


def main():
    import argparse
    parser = argparse.ArgumentParser(
        description="Evaluate a reconstruction against a ground-truth mesh.")
    parser.add_argument("--rec_mesh", type=str, required=True)
    parser.add_argument("--gt_mesh", type=str, required=True)
    parser.add_argument("-2d", "--metric_2d", action="store_true")
    parser.add_argument("-3d", "--metric_3d", action="store_true")
    parser.add_argument("--n_imgs", type=int, default=100)
    args = parser.parse_args()
    if args.metric_3d:
        calc_3d_metric(args.rec_mesh, args.gt_mesh)
    if args.metric_2d:
        calc_2d_metric(args.rec_mesh, args.gt_mesh, n_imgs=args.n_imgs)


if __name__ == "__main__":
    main()
