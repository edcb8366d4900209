"""Absolute trajectory error (ATE), numpy only.

A copy of the metric half of `unislam_tpu/tools/eval_ate.py`: Horn's
closed-form alignment and ATE RMSE/mean/median/std/max in centimeters, with
the same result keys. The plots are not ported.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


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
                 pose_alignment: bool = False) -> Tuple[np.ndarray, Dict]:
    """ATE between matched (N, 3) translation arrays; errors in cm.
    pose_alignment=False reports raw (unaligned) errors."""
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
    return trans_error, results


def pose_evaluation(gt_c2w, est_c2w, scale: float = 1.0,
                    pose_alignment: bool = False):
    """(trans_error_cm, results) over the frames whose ground truth is
    finite."""
    gt = np.asarray(gt_c2w, dtype=np.float64)
    est = np.asarray(est_c2w, dtype=np.float64)
    mask = np.isfinite(gt).all(axis=(1, 2))
    return evaluate_ate(gt[mask][:, :3, 3] / scale,
                        est[mask][:, :3, 3] / scale, pose_alignment)
