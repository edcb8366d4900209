"""Absolute trajectory error (ATE) evaluation + trajectory/velocity plots.

Counterpart of `unislam_tpu/tools/eval_ate.py`: Horn's closed-form
alignment, ATE RMSE/mean/median/std/max in centimeters with the same result
keys, the trajectory plot, velocity plots, per-frame error dump and the
uncertainty / activated-mapping strips. The figures need matplotlib
(`utils/plots.py`); without it they are skipped and every number is still
written.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from unislam_tpu_torch.utils.plots import pyplot


def align_horn(model: np.ndarray, data: np.ndarray):
    """Horn's closed-form SE(3) alignment of `model` (3, N) onto `data`
    (3, N). Returns (rot (3,3), trans (3,1), trans_error (N,))."""
    model_mean = model.mean(axis=1, keepdims=True)
    data_mean = data.mean(axis=1, keepdims=True)
    W = (model - model_mean) @ (data - data_mean).T
    U, _, Vt = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vt
    trans = data_mean - rot @ model_mean
    err = rot @ model + trans - data
    return rot, trans, np.sqrt((err * err).sum(axis=0))


def evaluate_ate(gt_xyz: np.ndarray, est_xyz: np.ndarray,
                 pose_alignment: bool = False,
                 plot: Optional[str] = None) -> Tuple[np.ndarray, Dict]:
    """ATE between matched (N, 3) translation arrays; errors in cm.
    pose_alignment=False reports raw (unaligned) errors. `plot`: the
    trajectory plot's path."""
    model, data = est_xyz.T, gt_xyz.T
    if pose_alignment:
        rot, trans, _ = align_horn(model, data)
        model = rot @ model + trans
    err = model - data
    trans_error = np.sqrt((err * err).sum(axis=0)) * 100.0  # cm
    results = {
        "compared_pose_pairs": int(len(trans_error)),
        "unit": "cm",
        "error.rmse": round(float(np.sqrt(np.mean(trans_error ** 2))), 2),
        "error.mean": round(float(np.mean(trans_error)), 2),
        "error.median": round(float(np.median(trans_error)), 2),
        "error.std": round(float(np.std(trans_error)), 2),
        "error.max": round(float(np.max(trans_error)), 2),
    }
    if plot:
        _plot_trajectory(gt_xyz, model.T, results, plot)
    return trans_error, results


def _plot_trajectory(gt_xyz, est_xyz, results, path):
    plt = pyplot()
    if plt is None:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig, ax = plt.subplots()
    ax.set_title(f"len:{len(gt_xyz)} ATE RMSE:{results['error.rmse']} cm")
    ax.plot(gt_xyz[:, 0], gt_xyz[:, 1], "-", color="black",
            label="ground truth")
    ax.plot(est_xyz[:, 0], est_xyz[:, 1], "-", color="blue",
            label="estimated")
    ax.plot(gt_xyz[-1, 0], gt_xyz[-1, 1], "o", color="green", markersize=10,
            label="GT end")
    ax.plot(est_xyz[-1, 0], est_xyz[-1, 1], "*", color="red", markersize=10,
            label="Est end")
    ax.legend()
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    fig.savefig(path, dpi=90)
    plt.close(fig)


def angular_velocity_from_quats(quats: np.ndarray):
    """Rotational velocity/acceleration magnitudes from per-frame unit
    quaternions by finite differences: |omega_t| = |2 (q_t - q_{t-1})| at
    dt = 1 frame, zero-prepended."""
    q = np.asarray(quats, np.float64)
    vel = np.linalg.norm(2.0 * np.diff(q, axis=0), axis=1)
    vel = np.concatenate([[0.0], vel])
    acc = np.concatenate([[0.0], np.diff(vel)])
    return vel, acc


def replace_outliers_with_median(data: np.ndarray, factor: float = 20.0):
    """Clamp |x| > factor*median(x) to the median: keeps one bad
    quaternion flip from wrecking the plot scale."""
    data = np.asarray(data, np.float64)
    med = np.median(data)
    out = np.where(data > med * factor, med, data)
    return np.where(out < -med * factor, med, out)


def plot_velocities(gt_c2w, est_c2w, path, weights=None):
    """Linear + angular (quaternion-derived) velocity panels with the
    rendered-weight/uncertainty strip, as a 3x2 figure."""
    plt = pyplot()
    if plt is None:
        return
    import torch

    from unislam_tpu_torch.core import pose as pose_lib

    def lin(tr):
        v = np.concatenate([[np.zeros(3)], np.diff(tr, axis=0)])
        vm = np.linalg.norm(v, axis=1)
        a = np.concatenate([[0.0], np.diff(vm)])
        return vm, a

    gt = np.asarray(gt_c2w, np.float32)
    est = np.asarray(est_c2w, np.float32)
    vg, _ = lin(gt[:, :3, 3])
    ve, _ = lin(est[:, :3, 3])

    q_gt = pose_lib.matrix_to_cam_pose(torch.as_tensor(gt)).numpy()[:, :4]
    q_est = pose_lib.matrix_to_cam_pose(torch.as_tensor(est)).numpy()[:, :4]
    wg, _ = angular_velocity_from_quats(q_gt)
    we, ae = angular_velocity_from_quats(q_est)
    wg = replace_outliers_with_median(wg)
    we = replace_outliers_with_median(we)
    ae = replace_outliers_with_median(ae)

    unc = (np.asarray(weights, np.float64) if weights is not None
           else np.zeros(len(vg)))

    fig, axes = plt.subplots(3, 2, figsize=(12, 18))
    panels = [
        (vg, "Linear Velocity GT", "Velocity (units/s)"),
        (wg, "Angular Velocity GT", "Angular Velocity (rad/s)"),
        (ve, "Linear Velocity Est", "Velocity (units/s)"),
        (we, "Angular Velocity Est", "Angular Velocity (rad/s)"),
        (unc, "uncertainty", "uncertainty"),
        (ae, "Angular Acceleration Est", "rad/s^2"),
    ]
    for ax, (y, title, ylabel) in zip(axes.ravel(), panels):
        ax.plot(np.arange(len(y)), y)
        ax.set_title(title)
        ax.set_xlabel("Time (s)")
        ax.set_ylabel(ylabel)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=90)
    plt.close(fig)


def vis_trans_error(trans_error_cm, output, file_path="trans_error_data.json"):
    """Per-frame translation-error JSON (always) + scatter strip +
    uncertainty colorbar (figures)."""
    os.makedirs(output, exist_ok=True)
    err_m = np.asarray(trans_error_cm, np.float64) / 100.0  # meters
    with open(os.path.join(output, file_path), "w") as f:
        json.dump({"trans_error": [round(float(e), 4) for e in err_m]}, f)
    plt = pyplot()
    if plt is None:
        return
    from matplotlib.cm import ScalarMappable
    from matplotlib.colors import Normalize

    cmap = plt.get_cmap("viridis")
    norm = Normalize(vmin=0, vmax=0.001)
    fig, ax = plt.subplots(figsize=(0.35, 4), dpi=300)
    cb = fig.colorbar(ScalarMappable(norm=norm, cmap=cmap), cax=ax)
    cb.set_label("Uncertainty Value")
    fig.savefig(os.path.join(output, "uncertainty_colorbar.png"),
                bbox_inches="tight")
    plt.close(fig)

    cmap = plt.get_cmap("jet")
    norm = plt.Normalize(vmin=0, vmax=0.25)
    fig, ax = plt.subplots(figsize=(6, 0.5), dpi=300)
    for i, value in enumerate(err_m):
        ax.vlines(i, 0, 1, color=cmap(norm(value)), linewidth=2)
    ax.yaxis.set_visible(False)
    ax.set_xticks(range(0, max(len(err_m), 1), 500))
    for side in ("top", "right", "left", "bottom"):
        ax.spines[side].set_visible(False)
    ax.set_aspect("auto")
    fig.savefig(os.path.join(output, "translation_error_scatter.png"),
                bbox_inches="tight", pad_inches=0)
    plt.close(fig)


def vis_unc_mapstep(tracking_weights, additional_map_records, output):
    """Uncertainty strip + activated-mapping strip (figures)."""
    plt = pyplot()
    if plt is None:
        return
    os.makedirs(output, exist_ok=True)
    cmap = plt.get_cmap("plasma")
    norm = plt.Normalize(vmin=0, vmax=0.005)
    fig, ax = plt.subplots(figsize=(6, 0.5), dpi=150)
    for i, v in enumerate(tracking_weights):
        ax.vlines(i, 0, 1, color=cmap(norm(v)), linewidth=2)
    ax.yaxis.set_visible(False)
    fig.savefig(os.path.join(output, "uncertainty_record.png"),
                bbox_inches="tight", pad_inches=0)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(6, 0.5), dpi=150)
    for i, v in enumerate(additional_map_records):
        ax.vlines(i, 0, 1, color=("red" if v else "white"), linewidth=2)
    ax.yaxis.set_visible(False)
    fig.savefig(os.path.join(output, "addtional_mapping_record.png"),
                bbox_inches="tight", pad_inches=0)
    plt.close(fig)


def pose_evaluation(gt_c2w, est_c2w, weights=None, plot_path=None,
                    scale: float = 1.0, pose_alignment: bool = False):
    """(trans_error_cm, results) over the frames whose ground truth is
    finite; with `plot_path`, the trajectory plot there and, beside it,
    the per-frame error JSON and the velocity figure."""
    gt = np.asarray(gt_c2w, dtype=np.float64)
    est = np.asarray(est_c2w, dtype=np.float64)
    mask = np.isfinite(gt).all(axis=(1, 2))  # gt nan/inf frames are skipped
    gt_xyz = gt[mask][:, :3, 3] / scale
    est_xyz = est[mask][:, :3, 3] / scale
    trans_error, results = evaluate_ate(gt_xyz, est_xyz, pose_alignment,
                                        plot=plot_path)
    if plot_path:
        out_dir = os.path.dirname(plot_path) or "."
        os.makedirs(out_dir, exist_ok=True)
        vis_trans_error(trans_error, out_dir)
        w = np.asarray(weights)[mask] if weights is not None else None
        plot_velocities(gt[mask], est[mask],
                        os.path.join(out_dir, "velocity.png"), weights=w)
    return trans_error, results


def main():
    import argparse

    from unislam_tpu_torch.config import load_config
    from unislam_tpu_torch.utils.logger import (latest_checkpoint,
                                                load_checkpoint)

    parser = argparse.ArgumentParser(description="Evaluate tracking ATE "
                                     "from the latest checkpoint.")
    parser.add_argument("config", type=str)
    parser.add_argument("--output", type=str, default=None)
    args = parser.parse_args()
    cfg = load_config(args.config, "configs/UNISLAM.yaml")
    output = args.output or cfg["data"]["output"]
    ckpt_path = latest_checkpoint(os.path.join(output, "ckpts"))
    if ckpt_path is None:
        print(f"no checkpoint under {output}/ckpts")
        return
    ckpt = load_checkpoint(ckpt_path)
    _, results = pose_evaluation(
        ckpt["gt_c2w"], ckpt["est_c2w"], ckpt.get("tracking_weights"),
        plot_path=os.path.join(output, "eval_ate_plot.png"),
        scale=cfg.get("scale", 1))
    print(results)
    vis_unc_mapstep(ckpt.get("tracking_weights", []),
                    ckpt.get("additional_map_records", []), output)


if __name__ == "__main__":
    main()
