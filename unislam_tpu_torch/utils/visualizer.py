"""Per-frame diagnostic panels during tracking/mapping.

Counterpart of `unislam_tpu/utils/visualizer.py`: renders the current frame
against the live map (`render_img` on the map's device) and saves a 2x5
matplotlib panel: gt / rendered / residual depth, termination probability
and the rendered-weights pane ((1-sum w)^2 pixel uncertainty at vmax 0.01)
on the top row; gt / rendered / residual RGB, depth uncertainty and the
weights colorbar on the bottom row, with PSNR in the title. Frequencies:
`vis_freq` frames; `vis_inside_freq` iterations via save_imgs' `it`
argument. `save_mapping_imgs` is the per-mapping-iteration render dump.

The render and the PSNR record always run; without matplotlib the panel
figure is not written (`utils/plots.py`). The mapping dump's PNG is written
with cv2.
"""

from __future__ import annotations

import os

import numpy as np

from unislam_tpu_torch.utils.plots import pyplot


def mse2psnr(mse: float) -> float:
    return -10.0 * np.log10(mse + 1e-12)


class FrameVisualizer:
    def __init__(self, freq: int, vis_dir: str, sc, rc, intr,
                 verbose: bool = False):
        self.freq = max(1, freq)
        self.vis_dir = vis_dir
        self.sc = sc
        self.rc = rc._replace(perturb=False)
        self.intr = intr
        self.verbose = verbose
        os.makedirs(vis_dir, exist_ok=True)

    def _render(self, params, c2w, gt_depth, seed: int):
        from unislam_tpu_torch.core import rng
        from unislam_tpu_torch.render import renderer as renderer_lib

        gen = rng.generator(seed, params["beta"].device)
        outs = renderer_lib.render_img(
            params, self.sc, self.rc, self.intr, np.asarray(c2w), gen,
            gt_depth=None if gt_depth is None else np.asarray(gt_depth))
        return [o.cpu().numpy() for o in outs]

    def save_imgs(self, idx: int, it: int, gt_depth, gt_color, c2w, params,
                  seed=None):
        if idx % self.freq != 0:
            return None
        depth, color, term, unc, depth_std = self._render(
            params, c2w, gt_depth, idx if seed is None else seed)
        out = self._panel(idx, it, np.asarray(gt_depth), np.asarray(gt_color),
                          depth, color, term, unc, depth_std)
        if self.verbose and out is not None:
            print(f"saved frame visualization {out}")
        return out

    def save_mapping_imgs(self, idx: int, it: int, gt_color, c2w, params,
                          gt_depth=None, seed=None):
        """Per-mapping-iteration render dump: the rendered RGB of the frame
        being mapped into `render_img_{idx}/{it}.png` with an MSE/PSNR
        record."""
        import cv2

        sub = os.path.join(self.vis_dir, f"render_img_{idx}")
        os.makedirs(sub, exist_ok=True)
        _, color, _, _, _ = self._render(
            params, c2w, gt_depth, idx * 10007 + it if seed is None else seed)
        out = os.path.join(sub, f"{it}.png")
        cv2.imwrite(out, cv2.cvtColor(
            (np.clip(color, 0, 1) * 255).astype(np.uint8), cv2.COLOR_RGB2BGR))
        mse = float(np.mean((np.asarray(gt_color) - color) ** 2))
        with open(os.path.join(sub, "psnr_record.txt"), "a") as f:
            f.write(f"Color mse: {mse:.4f}  PSNR: {mse2psnr(mse):.4f}\n")
        return out

    def _panel(self, idx, it, gt_depth, gt_color, depth, color, term, unc,
               depth_std):
        """The panel figure (None without matplotlib) and, always, the
        frame's PSNR record."""
        depth_residual = np.abs(gt_depth - depth)
        depth_residual[gt_depth == 0] = 0.0
        color_residual = np.abs(gt_color - color)
        color_residual[gt_depth == 0] = 0.0
        valid = gt_depth > 0
        mse = np.mean((gt_color[valid] - color[valid]) ** 2) if valid.any() \
            else np.nan
        psnr = mse2psnr(mse)
        with open(os.path.join(self.vis_dir, "psnr_record.txt"), "a") as f:
            f.write(f"frame {idx:05d} iter {it:04d} psnr {psnr:.3f}\n")
        plt = pyplot()
        if plt is None:
            return None

        max_depth = max(np.max(gt_depth), 1e-3)
        fig, axs = plt.subplots(2, 5, figsize=(20, 7))
        fig.suptitle(f"frame {idx:05d} iter {it:04d}  PSNR {psnr:.2f} dB")
        # "Rendered weights" = (1 - sum w)^2 pixel uncertainty, shown at a
        # tight vmax 0.01
        panels = [
            (gt_depth, "Input depth", "plasma", (0, max_depth)),
            (depth, "Rendered depth", "plasma", (0, max_depth)),
            (depth_residual, "Depth residual", "plasma", (0, max_depth)),
            (term, "Termination prob", "viridis", (0, 1)),
            (unc, "Rendered weights", "viridis", (0, 0.01)),
            (gt_color, "Input RGB", None, (0, 1)),
            (color, "Rendered RGB", None, (0, 1)),
            (color_residual, "RGB residual", None, (0, 1)),
            (depth_std, "Depth uncertainty", "jet", (0, 1)),
        ]
        for ax, (img, title, cmap, clim) in zip(axs.ravel(), panels):
            if cmap is None:
                ax.imshow(np.clip(img, 0, 1))
            else:
                ax.imshow(img, cmap=cmap, vmin=clim[0], vmax=clim[1])
            ax.set_title(title, fontsize=9)
            ax.set_xticks([])
            ax.set_yticks([])
        # last slot: the weights/uncertainty colorbar (also written as a
        # standalone uncertainty_bar.png)
        from matplotlib.cm import ScalarMappable
        from matplotlib.colors import Normalize
        ax = axs[1, 4]
        sm = ScalarMappable(norm=Normalize(0, 0.01), cmap="viridis")
        fig.colorbar(sm, cax=ax.inset_axes([0.4, 0.05, 0.12, 0.9]),
                     label="Uncertainty Value")
        ax.set_xticks([])
        ax.set_yticks([])
        ax.axis("off")
        out = os.path.join(self.vis_dir, f"{idx:05d}_{it:04d}.jpg")
        plt.savefig(out, bbox_inches="tight", pad_inches=0.2, dpi=90)
        plt.close(fig)
        self._save_uncertainty_bar(plt)
        return out

    def _save_uncertainty_bar(self, plt):
        """Standalone colorbar strip, written once per run."""
        bar = os.path.join(self.vis_dir, "uncertainty_bar.png")
        if os.path.exists(bar):
            return
        from matplotlib.cm import ScalarMappable
        from matplotlib.colors import Normalize
        fig, ax = plt.subplots(figsize=(0.35, 4), dpi=300)
        cb = fig.colorbar(ScalarMappable(norm=Normalize(0, 0.01),
                                         cmap="viridis"), cax=ax)
        cb.set_label("Uncertainty Value", size=10)
        cb.ax.yaxis.set_tick_params(labelsize=8, right=False)
        fig.savefig(bar, bbox_inches="tight")
        plt.close(fig)
