"""The port's CLI, `python -m unislam_tpu_torch.run`, as a subprocess on a
tiny on-disk Replica (40x52, 7 frames, written by the port's
`SyntheticRoom` and `write_replica`): a run on the CPU (`--device cpu`),
then `--resume` from its newest checkpoint, with the source snapshot kept;
a run with both low-precision mapping options set in the config; a brick
run with the band row dedup; and, without a GPU, the CLI refuses to run unless the CPU is asked for.
"""

import glob
import json
import os
import subprocess
import sys

import pytest
import torch

from test_torch_runtime import REPO, _room_cfg, _write_room


def _cli(args, timeout=600):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", "unislam_tpu_torch.run",
                           *args], cwd=REPO, env=env, timeout=timeout,
                          capture_output=True, text=True)


def test_cli_runs_and_resumes_on_the_cpu(tmp_path):
    import yaml
    folder = str(tmp_path)
    ds = _write_room(folder)
    cfg_path = os.path.join(folder, "room.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(_room_cfg(folder, ds), f)
    out = os.path.join(folder, "output")
    r = _cli([cfg_path, "--device", "cpu", "--n_frames", "5"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert os.path.exists(os.path.join(out, "config.yaml"))
    snap = os.path.join(out, "src_snapshot", "unislam_tpu_torch")
    assert os.path.exists(os.path.join(snap, "run.py"))
    assert not glob.glob(os.path.join(snap, "**", "__pycache__"),
                         recursive=True)
    marker = os.path.join(out, "src_snapshot", "MARKER")
    open(marker, "w").write("kept")
    r = _cli([cfg_path, "--device", "cpu", "--n_frames", "7", "--resume"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "resumed from" in r.stdout and "at frame 5" in r.stdout
    assert os.path.exists(marker)
    stats = json.load(open(os.path.join(out, "runtime_stats.json")))
    assert stats["start_frame"] == 5 and stats["frame_reads"] == {
        "frames": 2, "max": 1}
    ates = [json.loads(line) for line in open(os.path.join(out,
                                                           "output.txt"))
            if line.startswith('{"compared_pose_pairs"')]
    assert [a["compared_pose_pairs"] for a in ates] == [5, 7]


def test_cli_runs_the_low_precision_options_on_the_cpu(tmp_path):
    """`grid.tcnn_network: true` and `mapping.adam_state_dtype: bfloat16`
    in the YAML are all a user sets: the run ends, its checkpoint holds the
    bias-free decoders, and its ATE is written."""
    import numpy as np
    import yaml
    folder = str(tmp_path)
    ds = _write_room(folder, n=4)
    cfg = _room_cfg(folder, ds)
    cfg["grid"]["tcnn_network"] = True
    cfg["mapping"]["adam_state_dtype"] = "bfloat16"
    cfg_path = os.path.join(folder, "room.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    r = _cli([cfg_path, "--device", "cpu", "--n_frames", "4"])
    assert r.returncode == 0, r.stderr[-3000:]
    out = os.path.join(folder, "output")
    ckpt = sorted(glob.glob(os.path.join(out, "ckpts", "*.npz")))[-1]
    keys = set(np.load(ckpt).files)
    assert {"params['sdf_mlp']['w0']", "params['sdf_mlp']['w1']"} <= keys
    assert not any("['b0']" in k for k in keys)
    ates = [json.loads(line) for line in open(os.path.join(out,
                                                           "output.txt"))
            if line.startswith('{"compared_pose_pairs"')]
    assert ates[-1]["compared_pose_pairs"] == 4
    assert np.isfinite(ates[-1]["error.rmse"])


def test_cli_runs_the_band_row_dedup_on_the_cpu(tmp_path):
    """`rendering.dedup_band` in the YAML of a brick + surface-LOD run is
    all a user sets: the run ends through meshing, and its ATE is
    written."""
    import numpy as np
    import yaml
    folder = str(tmp_path)
    ds = _write_room(folder, n=4)
    cfg = _room_cfg(folder, ds)
    cfg["grid"].update({"encoding": "brick", "brick_levels": 3,
                        "brick_features": 8, "brick_hash_size": 12})
    cfg["rendering"].update({"n_fine": 6, "dedup_band": 0.5})
    cfg_path = os.path.join(folder, "room.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    r = _cli([cfg_path, "--device", "cpu", "--n_frames", "4"])
    assert r.returncode == 0, r.stderr[-3000:]
    out = os.path.join(folder, "output")
    saved = yaml.safe_load(open(os.path.join(out, "config.yaml")))
    assert saved["rendering"]["dedup_band"] == 0.5
    assert glob.glob(os.path.join(out, "mesh", "*.ply"))
    ates = [json.loads(line) for line in open(os.path.join(out,
                                                           "output.txt"))
            if line.startswith('{"compared_pose_pairs"')]
    assert ates[-1]["compared_pose_pairs"] == 4
    assert np.isfinite(ates[-1]["error.rmse"])


def test_cli_without_a_gpu_needs_the_cpu_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _cli([os.path.join(REPO, "configs/Replica/room0.yaml"), "--output",
              str(tmp_path / "o")], timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
