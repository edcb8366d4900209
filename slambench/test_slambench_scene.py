"""The benchmark's stream against the port's own synthetic room and the
smoke's depth dropouts (CPU, small frames)."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from slambench import scene  # noqa: E402

SCENE = {"half": 3.5, "orbit_r": 1.2, "sphere_c": [1.0, -1.0, 0.0],
         "sphere_r": 0.8, "texture": "noise"}
INTR = {"H": 68, "W": 120, "fx": 60.0, "fy": 60.0, "cx": 59.5, "cy": 33.5}


@pytest.mark.parametrize("frame", [0, 7, 131, 479])
def test_torch_renderer_matches_the_synthetic_room(frame):
    from unislam_tpu_torch.core.rays import Intrinsics
    from unislam_tpu_torch.data.synthetic import SyntheticRoom

    ds = SyntheticRoom(n_frames=frame + 1, intr=Intrinsics(**INTR),
                       half=3.5, orbit_r=1.2, sphere_c=(1.0, -1.0, 0.0),
                       sphere_r=0.8, texture="noise", deg_per_frame=0.75)
    color, depth, c2w = ds[frame]
    pose = scene.orbit_pose(frame, 1.2, 0.75)
    assert np.array_equal(pose, c2w)
    c, d = scene.render(SCENE, scene.camera_dirs(INTR, "cpu"),
                        torch.as_tensor(pose))
    d = d.reshape(depth.shape).numpy()
    c = c.reshape(color.shape).numpy()
    # f32 sums in another order: depth to a few ulps, colour (sines of
    # arguments up to ~100) to 1e-5
    assert np.max(np.abs(d / depth - 1)) < 1e-5
    assert np.max(np.abs(c - color)) < 1e-5


def test_pool_closes_the_orbit_and_the_stream_wraps():
    color, depth, poses = scene.render_pool(SCENE, {**INTR, "H": 8, "W": 12},
                                            30.0, 5, None, "cpu")
    assert color.shape == (12, 8, 12, 3) and depth.shape == (12, 8, 12)
    np.testing.assert_allclose(scene.orbit_pose(12, 1.2, 30.0)[:3, 3],
                               poses[0][:3, 3], atol=1e-6)
    s = scene.Stream(color, depth, poses, n_frames=100)
    assert len(s) == 100
    assert np.array_equal(s[12][1], depth[0]) and np.array_equal(s[29][1],
                                                                 depth[5])
    with pytest.raises(IndexError):
        s[100]
    with pytest.raises(ValueError):
        scene.pool_size(0.7)


@pytest.mark.parametrize("idx", [0, 3, 199])
def test_depth_holes_is_the_smokes(idx):
    sys.path.insert(0, ROOT)
    import chip_smoke

    depth = np.random.default_rng(9).uniform(0.5, 4.0, (68, 120)).astype(
        np.float32)
    ours = scene.depth_holes(depth, np.random.default_rng(idx))
    assert np.array_equal(ours, chip_smoke.depth_holes(depth, idx))
    # the device version zeroes the same pixels
    blocks = scene.hole_blocks(68, 120, 16, 0.05, np.random.default_rng(idx))
    mask = scene.hole_mask(68, 120, blocks, 16, "cpu").numpy()
    assert np.array_equal(ours == 0, mask)


def test_pool_holes_follow_seed_and_frame():
    intr = {**INTR, "H": 96, "W": 128}
    holes = {"block_px": 16, "share": 0.05}
    _, d1, _ = scene.render_pool(SCENE, intr, 30.0, 7, holes, "cpu")
    _, d2, _ = scene.render_pool(SCENE, intr, 30.0, 7, holes, "cpu")
    _, d3, _ = scene.render_pool(SCENE, intr, 30.0, 8, holes, "cpu")
    assert np.array_equal(d1, d2) and not np.array_equal(d1, d3)
    for i in (0, 5):
        want = scene.depth_holes(np.where(d1[i] == 0, 1.0, d1[i]),
                                 scene.frame_rng(7, i))
        assert np.array_equal(want == 0, d1[i] == 0)
