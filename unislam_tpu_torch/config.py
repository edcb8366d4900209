"""YAML configuration with recursive `inherit_from` chains (the JAX
package's `config.py`: the leaf wins, relative parents resolve against the
including file, then against the repository root)."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import yaml


def update_recursive(dict1: Dict[str, Any], dict2: Dict[str, Any]) -> None:
    """Deep-merge dict2 into dict1 (dict2 wins on leaves)."""
    for k, v in dict2.items():
        if isinstance(v, dict):
            if not isinstance(dict1.get(k), dict):
                dict1[k] = {}
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v


def _resolve(path: str, relative_to: Optional[str]) -> str:
    if os.path.isabs(path) or os.path.exists(path) or relative_to is None:
        return path
    cand = os.path.join(os.path.dirname(relative_to), path)
    if os.path.exists(cand):
        return cand
    # paths like 'configs/Replica/replica.yaml' are relative to the repo root
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cand = os.path.join(root, path)
    return cand if os.path.exists(cand) else path


def load_config(path: str, default_path: Optional[str] = None) -> Dict[str, Any]:
    """Load a YAML config, following its `inherit_from` chain; a chain with
    no explicit root starts from `default_path`."""
    with open(path, "r") as f:
        cfg_special = yaml.safe_load(f) or {}

    inherit_from = cfg_special.get("inherit_from")
    if inherit_from is not None:
        cfg = load_config(_resolve(inherit_from, path), default_path)
    elif default_path is not None:
        with open(default_path, "r") as f:
            cfg = yaml.safe_load(f) or {}
    else:
        cfg = {}

    update_recursive(cfg, cfg_special)
    return cfg
