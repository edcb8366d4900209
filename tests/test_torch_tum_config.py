"""TUM RGB-D fr1/desk on the port's hash main path: the benchmark's
`tum_fr1desk_hash` configuration and its cell `tum_fr1desk_hash.holes`.

On the CPU: the configuration file is the port's merge of the published
files but for the cuts it lists; at a small size (image, rays and grids
cut; fr1/desk's 48 + 8 samples, fixed beta, mapping every 2nd frame and
thresholds kept) the output check holds the port's first tracking and
mapping iterations to the plain reference within the cell's limits, and a
fault planted on the mapping side fails it; the activated-mapping counters
(`UniSLAM.iters_run["activated"]`, `["extended"]`) count what `step_frame`
decided; the desk scene's depths and motion lie in fr1/desk's range; and
the benchmark's readers of the new metrics.
"""

import copy
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from slambench import check, lib, scene, shapes  # noqa: E402

CONFIG = "tum_fr1desk_hash"
CELL = "tum_fr1desk_hash.holes"
SPEC = lib.load_json("configs", CONFIG)
PUBLISHED = ("configs/TUM_RGBD/freiburg1_desk.yaml",
             "configs/TUM_RGBD/tum.yaml", "configs/UNISLAM.yaml")
# fr1/desk's published settings the file must hold unchanged
KEPT = {"grid.hash_size_sdf": 16, "grid.hash_size_color": 16,
        "grid.voxel_sdf": 0.01, "grid.voxel_color": 0.01,
        "grid.tcnn_network": False, "model.c_dim": 32,
        "rendering.n_stratified": 48, "rendering.n_importance": 8,
        "rendering.learnable_beta": False, "tracking.pixels": 5000,
        "tracking.iters": 20, "tracking.uncertainty_ts": 0.002,
        "tracking.lr_T": 0.01, "tracking.lr_R": 0.002,
        "mapping.pixels": 5000, "mapping.iters": 30,
        "mapping.every_frame": 2, "mapping.keyframe_every": 2,
        "cam.crop_size": [384, 512], "cam.crop_edge": 8}
# the small size: image, rays and grids cut, the rest as published
SMALL = {"cam": {"H": 34, "W": 60, "fx": 30.0, "fy": 30.0, "cx": 29.5,
                 "cy": 16.5, "crop_edge": 0},
         "grid": {"hash_size_sdf": 10, "hash_size_color": 10,
                  "voxel_sdf": 0.2, "voxel_color": 0.2},
         "tracking": {"pixels": 48, "iters": 3, "ignore_edge_W": 4,
                      "ignore_edge_H": 4},
         "mapping": {"pixels": 64, "iters": 3, "iters_first": 4}}
# fr1/desk's Kinect range (m) and per-frame motion (cm): 0.41 m/s at 30 Hz
DEPTH_RANGE = (0.5, 3.5)
STEP_CM = (1.0, 1.6)


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _merged():
    from unislam_tpu_torch.config import load_config

    cfg = load_config(os.path.join(ROOT, PUBLISHED[0]),
                      os.path.join(ROOT, PUBLISHED[2]))
    cfg.pop("inherit_from", None)
    return cfg


# -- (a) the configuration file --------------------------------------------

def test_the_config_is_the_published_merge_but_for_its_cuts():
    pub, got = _flat(_merged()), _flat(SPEC["slam"])
    missing = object()
    differ = {k for k in set(pub) | set(got)
              if pub.get(k, missing) != got.get(k, missing)}
    assert differ == set(SPEC["reduced"])
    assert tuple(SPEC["source_files"]) == PUBLISHED
    # the cut bound is the scene's box plus 0.2 m
    h = SPEC["scene"]["half"] + 0.2
    assert SPEC["slam"]["mapping"]["bound"] == [[-h, h]] * 3
    assert "distortion" not in SPEC["slam"]["cam"]


@pytest.mark.parametrize("key", sorted(KEPT))
def test_a_published_setting_is_kept(key):
    assert _flat(SPEC["slam"])[key] == KEPT[key]
    assert key not in SPEC["reduced"]


def test_the_benchmark_declares_the_config_and_its_cell():
    b = lib.benchmark()
    cfg = {c["name"]: c for c in b["configs"]}[CONFIG]
    assert cfg["file"] == f"slambench/configs/{CONFIG}.json"
    assert cfg["source"] == SPEC["source"]
    assert cfg["reduced"] == list(SPEC["reduced"])
    cell = {w["name"]: w for w in b["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "holes", 1)
    assert set(lib.load_json("limits", CELL)) == set(check.NUMBERS)


def test_the_crop_gives_fr1_desks_camera():
    from unislam_tpu_torch.engine.slam import intrinsics_from_cfg

    intr = shapes.intrinsics(SPEC["slam"])
    port = intrinsics_from_cfg(SPEC["slam"])
    assert (intr["H"], intr["W"]) == (port.H, port.W) == (368, 496)
    for k in ("fx", "fy", "cx", "cy"):
        assert intr[k] == pytest.approx(getattr(port, k), abs=0)
    assert intr["fx"] == pytest.approx(517.3 * 0.8)
    assert intr["cx"] == pytest.approx(318.6 * 0.8 - 8)


# -- (b) the output check at a small size ----------------------------------

@pytest.fixture(scope="module")
def session():
    from slambench import run

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    mp = pytest.MonkeyPatch()
    mp.setattr(run, "REHEARSAL", SMALL)
    ses = run.Session(CELL, 2 ** 31 + 19, rehearse=True)
    ses.window(0.5)
    yield ses
    ses.close()
    mp.undo()
    torch.set_num_threads(threads)


def test_the_small_config_keeps_fr1_desks_samples_and_cadence(session):
    cfg = session.cfg
    assert (cfg["rendering"]["n_stratified"],
            cfg["rendering"]["n_importance"]) == (48, 8)
    assert cfg["rendering"]["learnable_beta"] is False
    assert cfg["mapping"]["every_frame"] == 2
    assert cfg["tracking"]["uncertainty_ts"] == 0.002
    assert session.shp["samples"] == 56


def test_the_first_iterations_match_the_reference(session):
    got = session.check(("program", "control"))
    assert check.judge(got["program"], session.limits), got["program"]
    assert not check.judge(got["control"], session.limits), got["control"]


def test_half_the_batch_on_the_mapping_side_fails_the_check(session):
    from slambench.faults import FAULTS

    with FAULTS["half_batch"]():
        nums = session.check()["program"]
    assert nums["map_grad"] > session.limits["map_grad"], nums
    assert not check.judge(nums, session.limits)


# -- (c) the activated-mapping counters ------------------------------------

def _frames(cfg, n):
    intr = shapes.intrinsics(cfg)
    dirs = scene.camera_dirs(intr, "cpu")
    out = []
    for i in range(n):
        c2w = scene.orbit_pose(i, SPEC["scene"]["orbit_r"], 0.75)
        color, depth = scene.render(SPEC["scene"], dirs,
                                    torch.as_tensor(c2w))
        out.append((color.reshape(intr["H"], intr["W"], 3).numpy(),
                    depth.reshape(intr["H"], intr["W"]).numpy(), c2w))
    return out


def _drive(threshold, n=4):
    """fr1/desk's tracking (20 iterations, doubled to 40) at a small size,
    with `uncertainty_ts` set to `threshold`; the counters and each
    frame's tracking iterations."""
    from unislam_tpu_torch.config import update_recursive
    from unislam_tpu_torch.engine.slam import UniSLAM

    cfg = copy.deepcopy(SPEC["slam"])
    cfg["cam"].pop("crop_size")
    update_recursive(cfg, {
        "cam": dict(SMALL["cam"], H=12, W=16, fx=12.0, fy=12.0, cx=7.5,
                    cy=5.5),
        "grid": SMALL["grid"],
        "tracking": {"pixels": 16, "ignore_edge_W": 1, "ignore_edge_H": 1,
                     "uncertainty_ts": threshold},
        "mapping": {"pixels": 16, "iters": 1, "iters_first": 1},
        "data": {"prefetch": False}})
    frames = _frames(cfg, n)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    slam = UniSLAM(cfg, frames, seed=3, device="cpu")
    per_frame = []
    try:
        for i in range(n):
            before = slam.iters_run["track"]
            slam.step_frame(i)
            per_frame.append(slam.iters_run["track"] - before)
    finally:
        slam.close()
        torch.set_num_threads(threads)
    return slam.iters_run, per_frame


def test_a_zero_threshold_fires_on_every_frame_after_the_first():
    it, per_frame = _drive(0.0)
    # frame 1 runs the base count, fires, is extended to 40 and fires
    # again; every later frame starts from 40 and fires
    assert per_frame == [0, 40, 40, 40]
    assert (it["activated"], it["extended"]) == (3, 1)
    assert it["track"] == sum(per_frame)
    assert all(isinstance(v, int) for v in it.values())


def test_a_huge_threshold_never_fires():
    it, per_frame = _drive(1e9)
    assert per_frame == [0, 20, 20, 20]
    assert (it["activated"], it["extended"]) == (0, 0)
    assert it["track"] == 60


# -- (d) the desk scene ----------------------------------------------------

@pytest.fixture(scope="module")
def dirs():
    return scene.camera_dirs(shapes.intrinsics(SPEC["slam"]), "cpu")


@pytest.mark.parametrize("frame", range(0, 480, 60))
def test_the_desk_scene_lies_in_the_kinects_range(dirs, frame):
    sc = SPEC["scene"]
    c2w = torch.as_tensor(scene.orbit_pose(frame, sc["orbit_r"], 0.75))
    _, depth = scene.render(sc, dirs, c2w)
    assert DEPTH_RANGE[0] <= float(depth.min())
    assert float(depth.max()) <= DEPTH_RANGE[1]
    # the sphere, the desk object, is in view: its depth is under the
    # room's alone on a large share of the pixels
    _, room = scene.render(dict(sc, sphere_r=1e-6), dirs, c2w)
    assert float((depth < room - 1e-4).float().mean()) > 0.1


def test_the_camera_moves_as_fr1_desks():
    sc = SPEC["scene"]
    traffic = lib.load_json("traffic", "holes")
    a, b = (scene.orbit_pose(i, sc["orbit_r"], traffic["deg_per_frame"])
            for i in (100, 101))
    step_cm = float(np.linalg.norm(b[:3, 3] - a[:3, 3])) * 100
    assert STEP_CM[0] <= step_cm <= STEP_CM[1]
    cos = float(np.trace(a[:3, :3].T @ b[:3, :3]) - 1) / 2
    assert math.degrees(math.acos(min(cos, 1.0))) == pytest.approx(
        0.75, abs=0.1)


# -- the new metrics -------------------------------------------------------

def _read(name, run):
    return lib.load_module("metrics", name).read(run)


def test_activated_share_reader():
    run = {"stats": {"frames": 40, "iters": {"track": 900, "activated": 6}}}
    assert _read("activated_share", run) == pytest.approx(0.15)
    # a run without tracing, a parent without the counter, no frames
    assert _read("activated_share", {}) is None
    assert _read("activated_share",
                 {"stats": {"frames": 40, "iters": {"track": 900}}}) is None
    assert _read("activated_share", {"stats": {"frames": 0, "iters": {
        "activated": 0}}}) is None


def test_extended_share_reader():
    run = {"stats": {"frames": 40, "iters": {"track": 900, "extended": 2}}}
    assert _read("extended_share", run) == pytest.approx(0.05)
    # a run without tracing, a parent without the counter, no frames
    assert _read("extended_share", {}) is None
    assert _read("extended_share",
                 {"stats": {"frames": 40, "iters": {"track": 900}}}) is None
    assert _read("extended_share", {"stats": {"frames": 0, "iters": {
        "extended": 0}}}) is None


DEVICE_SHARES = ["mfu", "hash_encode_fwd_roofline",
                 "hash_encode_bwd_roofline", "scatter_accum_roofline",
                 "composite_roofline"]


@pytest.mark.parametrize("name", DEVICE_SHARES)
def test_a_device_share_reads_the_tum_cell(name):
    """The accepted shares list the new cell and read it at its shapes."""
    per_layer = {m["name"]: m for m in lib.benchmark()["per_layer"]}
    assert per_layer[name]["workloads"][-1] == CELL
    shp = shapes.of(SPEC["slam"])
    it = {"track": 400, "map": 300, "probe": 300}
    kernels = {"void_hash_fwd_kernel_64_": (90000.0, 1000),
               "hash_bwd_kernel_float": (80000.0, 1000),
               "void_pass_a_kernel_2_": (40000.0, 600),
               "void_pass_b_kernel_2_": (30000.0, 600),
               "pass_c_kernel": (5000.0, 600),
               "composite_fwd_kernel": (20000.0, 1000),
               "composite_bwd_kernel": (30000.0, 700),
               "composite_probe_kernel": (3000.0, 300)}
    run = {"shapes": shp, "trace": {"wall_s": 4.0, "busy_s": 2.0,
                                    "frames": 20, "launches": 9000,
                                    "iters": it, "kernels": kernels}}
    v = _read(name, run)
    assert v is not None and v > 0
    assert _read(name, {"shapes": shp}) is None


def test_the_benchmark_declares_the_new_metrics():
    per_layer = {m["name"]: m for m in lib.benchmark()["per_layer"]}
    for name in ("activated_share", "extended_share"):
        share = per_layer[name]
        assert (share["source"], share["layer"], share["moves"],
                share["unit"]) == ("program_counter", "driver",
                                   "frames_per_s", "frames/frame")
        assert "workloads" not in share
    # one name a quantity: the new cell is read under the accepted names
    assert not any(n.endswith(".tum") for n in per_layer)


def test_rehearsed_traced_tum_run_reports_the_activated_share(tmp_path):
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "slambench", "run.py"),
         "--workload", CELL, "--seed", "2147483671", "--seconds", "2",
         "--trace", "1", "--rehearse"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"]
    for name in ("activated_share", "extended_share"):
        share = result["metrics"][name]
        assert share["unit"] == "frames/frame" and 0 <= share["value"] <= 1
    # no device metric from a CPU run
    assert not set(DEVICE_SHARES) & set(result["metrics"])
