"""Checkpoints with resume.

Counterpart of `unislam_tpu/utils/logger.py`, in the same archive layout,
so a JAX run's checkpoint resumes in the port and the other way round: one
.npz holding every array leaf keyed by the JAX pytree path
(`params['sdf_table']`, `params['sdf_mlp']['w0']`, `bank.depth`, ...,
`bank.count`), the host trajectory state (`est_c2w`, `gt_c2w`,
`tracking_weights`, `additional_map_records`, `kf_is_cadence`) and the
scalars as a JSON blob under `__meta__`. `load_into` carries the archive's
scene through `scene.params_from_jax` and its bank through
`keyframes.bank_from_jax`.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional

import numpy as np

from unislam_tpu_torch.engine import keyframes as kf_lib
from unislam_tpu_torch.models import scene as scene_lib


def _flatten_params(tree, prefix: str = "params") -> Dict[str, np.ndarray]:
    """Nested dict -> {"params['a']['b']": array} (sorted keys, as JAX
    flattens a dict)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}['{k}']"
        if isinstance(v, dict):
            out.update(_flatten_params(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten_like(template, archive, prefix: str = "params"):
    return {k: (_unflatten_like(v, archive, f"{prefix}['{k}']")
                if isinstance(v, dict) else archive[f"{prefix}['{k}']"])
            for k, v in template.items()}


def save_checkpoint(path: str, slam, idx: int) -> str:
    """Save scene params + bank + trajectory state at frame `idx`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = _flatten_params(scene_lib.params_to_numpy(slam.params))
    arrays.update({f"bank.{k}": v for k, v in
                   kf_lib.bank_to_numpy(slam.bank).items()})
    arrays["est_c2w"] = slam.est_c2w
    arrays["gt_c2w"] = slam.gt_c2w
    arrays["tracking_weights"] = slam.tracking_weights
    arrays["additional_map_records"] = slam.additional_map_records
    arrays["kf_is_cadence"] = slam.kf_is_cadence
    meta = {
        "idx": int(idx),
        "t_iters": int(slam.t_iters),
        "m_iters": int(slam.m_iters),
        "tracking_back": bool(slam.tracking_back),
        "lc_cnt": int(slam.lc_cnt),
        "mapping_cnt": int(slam.mapping_cnt),
        "init_phase": bool(slam.init_phase),
    }
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    # written under another name and renamed: a reader (or a resume after a
    # crash) never sees a half-written archive
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a checkpoint archive into a dict (arrays + parsed meta)."""
    with np.load(path, allow_pickle=False) as z:
        out = {k: z[k] for k in z.files}
    out["meta"] = json.loads(bytes(out.pop("__meta__")).decode())
    return out


def load_into(slam, path: str) -> int:
    """Restore a UniSLAM instance from `path` (written by the port or by
    the JAX package); returns the frame index at which to resume (idx + 1).

    The bank's slot count (max_kf) follows the run's frame count, so a
    resumed run with another frame budget has a bank of another size: each
    bank array is copied into the run's own shape. Slot order is temporal
    order and selection reads the last slots as the newest keyframes, so a
    smaller bank keeps the NEWEST valid keyframes."""
    ckpt = load_checkpoint(path)
    device = slam.device
    slam.params = scene_lib.params_from_jax(
        _unflatten_like(scene_lib.params_to_numpy(slam.params), ckpt),
        device=device)

    tpl = kf_lib.bank_to_numpy(slam.bank)
    max_kf = slam.bank.max_kf
    src = {k: ckpt[f"bank.{k}"] for k in kf_lib.BANK_FIELDS}
    src_slots = src["pose7"].shape[0]
    src_count = int(ckpt["bank.count"]) if "bank.count" in ckpt \
        else src_slots
    valid = min(src_count, src_slots)
    keep = min(max_kf, valid)
    fields = {}
    for k, a in src.items():
        if a.shape == tpl[k].shape:
            fields[k] = a
        else:
            fields[k] = tpl[k].copy()
            fields[k][:keep] = a[valid - keep:valid]
    fields["count"] = keep
    slam.bank = kf_lib.bank_from_jax(fields, device=device)

    if "kf_is_cadence" in ckpt:
        src_cad = list(ckpt["kf_is_cadence"])
        if len(src_cad) == src_slots and len(slam.kf_is_cadence) == max_kf:
            slam.kf_is_cadence[:keep] = src_cad[valid - keep:valid]
        else:
            n = min(len(slam.kf_is_cadence), len(src_cad))
            slam.kf_is_cadence[:n] = src_cad[:n]
    # prefix-copy the trajectory state: the resumed run may see more frames
    # than the checkpointing run did, and its (n_img, ...) arrays keep
    # their length
    for name in ("est_c2w", "gt_c2w", "tracking_weights",
                 "additional_map_records"):
        dst = getattr(slam, name)
        a = ckpt[name]
        n = min(len(dst), len(a))
        dst[:n] = a[:n]
    meta = ckpt["meta"]
    slam.t_iters = meta["t_iters"]
    slam.m_iters = meta["m_iters"]
    slam.tracking_back = meta["tracking_back"]
    slam.lc_cnt = meta["lc_cnt"]
    slam.mapping_cnt = meta["mapping_cnt"]
    slam.init_phase = meta["init_phase"]
    return meta["idx"] + 1


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = [f for f in sorted(os.listdir(ckpt_dir))
             if re.match(r"^\d+\.npz$", f)]
    return os.path.join(ckpt_dir, ckpts[-1]) if ckpts else None


class Logger:
    """Periodic checkpoint writer (files are 05d-numbered by frame)."""

    def __init__(self, slam, ckpt_dir: str):
        self.slam = slam
        self.ckpt_dir = ckpt_dir

    def log(self, idx: int):
        path = os.path.join(self.ckpt_dir, f"{idx:05d}.npz")
        save_checkpoint(path, self.slam, idx)
        if self.slam.verbose:
            print(f"Saved checkpoint at {path}")
