"""Port parity for the viewer half of the visualisation
(`unislam_tpu_torch/utils/playback.py`): the turntable pose, the camera
frustum, the layers of one third-person view (`view_layers`) against what
the JAX package's `render_view` puts in its matplotlib figure, the port's
copy of matplotlib's `bone` colormap, the cv2 drawing without matplotlib,
and the live follower.

Tolerances: poses and frustum points in float64 to 1e-12; the shaded depth
image within 1e-6 (both packages build the same rasterizer source, and it
comes out bitwise equal); each polyline and frustum segment within 1e-9
pixels, with the same count and order; the colormap within one 8-bit step.
"""

import os
import shutil
import sys

import cv2
import numpy as np
import pytest

from unislam_tpu.utils import mesh_io as jmesh_io
from unislam_tpu.utils import playback as jplayback
from unislam_tpu_torch.utils import mesh_io, playback

TET_V = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
TET_F = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], np.int32)


def _cube(half=1.0, center=(0.5, 0.2, -0.3)):
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], np.float32) * half + np.float32(center)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                  [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                  [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f


def _poses(t):
    """(n, 4, 4) poses: identity rotations at translations `t` (n, 3)."""
    c2w = np.tile(np.eye(4), (len(t), 1, 1))
    c2w[:, :3, 3] = t
    return c2w


def _view_pose(verts, theta=0.6):
    center = verts.mean(axis=0)
    extent = max((verts.max(0) - verts.min(0)).max(), 1e-3)
    return jplayback.third_person_pose(center, extent, theta), extent


def _in_front(c2w_view, pts):
    cam = (pts - c2w_view[:3, 3]) @ c2w_view[:3, :3]
    return cam[:, 2] - 1e-6 < 0


def _case(name):
    """(verts, faces, est (n, 3), gt (n, 3), cur_c2w, theta)."""
    if name == "tetrahedron":        # test_playback.py's scene
        verts, faces = TET_V * 2.0, TET_F
        est = _poses(np.stack([np.zeros(4), np.zeros(4),
                               np.linspace(3, 4, 4)], -1))
        gt = est.copy()
        gt[:, 0, 3] += 0.2
        return verts, faces, est[:, :3, 3], gt[:, :3, 3], est[-1], 0.6
    verts, faces = _cube()
    view, extent = _view_pose(verts)
    center, eye = verts.mean(0), view[:3, 3]
    if name == "behind_view":
        # the trajectory runs from the mesh's centre through the viewing
        # camera and on behind it: the points past the eye are dropped
        s = np.linspace(0.1, 2.0, 12)[:, None]
        est = center + s * (eye - center)
        gt = est + np.array([0.05, -0.04, 0.02])
        return verts, faces, est, gt, _poses(est[:1])[0], 0.6
    if name == "frustum_partly_off":
        # a camera just in front of the viewing one, turned to face it:
        # its apex is in view, its image-plane corners behind the eye
        cur = view.copy()
        cur[:3, 0], cur[:3, 2] = -view[:3, 0], -view[:3, 2]
        cur[:3, 3] = eye + 0.5 * extent * 0.03 * (center - eye) \
            / np.linalg.norm(center - eye)
        pts, _ = jplayback.camera_frustum_lines(cur, scale=extent * 0.03)
        vis = _in_front(view, pts)
        assert 0 < vis.sum() < len(vis)
        t = center + np.array([[0.3, 0.1, 0.0], [0.0, 0.3, 0.2],
                               [-0.2, 0.0, 0.3]])
        return verts, faces, t, t + 0.05, cur, 0.6
    if name == "one_pose":
        t = center[None] + np.array([[0.4, 0.2, 0.1]])
        return verts, faces, t, t.copy(), _poses(t)[0], 2.0
    raise ValueError(name)


CASES = ["tetrahedron", "behind_view", "frustum_partly_off", "one_pose"]


def _jax_figure(monkeypatch, tmp_path, verts, faces, est, gt, cur, theta,
                H=480, W=640):
    """Run the JAX package's `render_view` and keep its figure: savefig
    and close are replaced so the figure stays open."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    figs, real_close = [], plt.close
    monkeypatch.setattr(plt, "savefig", lambda *a, **k: figs.append(
        plt.gcf()))
    monkeypatch.setattr(plt, "close", lambda *a, **k: None)
    jplayback.render_view(str(tmp_path / "jax.png"), verts, faces, est, gt,
                          cur, 3, 4, theta=theta, H=H, W=W)
    (fig,) = figs
    try:
        ax = fig.axes[0]
        img = np.asarray(ax.images[0].get_array())
        lines = [(ln.get_color(), np.asarray(ln.get_xydata(), np.float64))
                 for ln in ax.lines]
    finally:
        real_close(fig)
    return img, lines


def test_turntable_pose_and_frustum_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(8):
        center = rng.normal(size=3)
        extent = float(rng.uniform(0.01, 10.0))
        theta = float(rng.uniform(-7, 7))
        a = playback.third_person_pose(center, extent, theta)
        b = jplayback.third_person_pose(center, extent, theta)
        assert a.dtype == np.float64
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        pa, sa = playback.camera_frustum_lines(a, scale=extent * 0.03)
        pb, sb = jplayback.camera_frustum_lines(b, scale=extent * 0.03)
        assert sa == sb and len(sa) == 8
        np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", CASES)
def test_view_layers_match_jax_render_view(case, monkeypatch, tmp_path):
    verts, faces, est, gt, cur, theta = _case(case)
    H, W = 120, 160
    jimg, jlines = _jax_figure(monkeypatch, tmp_path, verts, faces, est, gt,
                               cur, theta, H, W)
    img, lines, frustum = playback.view_layers(verts, faces, est, gt, cur,
                                               theta, H, W)
    assert img.shape == (H, W) and img.dtype == jimg.dtype
    assert (img > 0).any()
    np.testing.assert_allclose(img, jimg, rtol=0, atol=1e-6)
    assert np.array_equal(img, jimg)          # the same rasterizer source
    colour = {"gt": "lime", "est": "cyan"}
    ours = [(colour[label], uv) for label, uv in lines] \
        + [("red", seg) for seg in frustum]
    assert [c for c, _ in ours] == [c for c, _ in jlines]
    for (_, a), (_, b) in zip(ours, jlines):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    expect = {"tetrahedron": (["gt", "est"], 8),
              "behind_view": (["gt", "est"], 8),
              "frustum_partly_off": (["gt", "est"], 0),
              "one_pose": ([], 8)}[case]
    assert ([label for label, _ in lines], len(frustum)) == expect
    if case == "behind_view":               # the points behind are dropped
        assert 1 < len(lines[0][1]) < len(gt)


def test_bone_table_matches_matplotlib():
    import matplotlib.cm

    ref = matplotlib.cm.bone(np.arange(256))[:, :3]
    ours = playback.bone_lut(256)
    assert ours.shape == (256, 3)
    assert np.abs(ours - ref).max() * 255 <= 1.0


def test_render_view_draws_without_matplotlib(monkeypatch, tmp_path):
    for mod in ("matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, mod, None)
    verts, faces = _cube()
    view, extent = _view_pose(verts)
    center = verts.mean(0)
    # gt and est side by side across the cube's face, well inside the view
    s = np.linspace(-0.6, 0.6, 7)[:, None]
    gt = center + s * view[:3, 0] + 0.3 * view[:3, 1]
    est = center + s * view[:3, 0] - 0.3 * view[:3, 1]
    cur = _poses(est[-1:])[0]
    H, W = 480, 640
    png = playback.render_view(str(tmp_path / "v.png"), verts, faces, est,
                               gt, cur, 6, 7, H=H, W=W)
    assert png == str(tmp_path / "v.png")
    img = cv2.imread(png)
    assert img.shape == (H, W, 3)
    _, lines, frustum = playback.view_layers(verts, faces, est, gt, cur,
                                             0.6, H, W)
    uv = dict(lines)

    def bgr(p):
        c, r = np.round(p).astype(int)
        return tuple(int(x) for x in img[r, c])

    assert [bgr(p) for p in uv["gt"]] == [(0, 255, 0)] * len(gt)
    # the last est point carries the frustum's apex
    assert [bgr(p) for p in uv["est"][:-1]] == [(255, 255, 0)] * (len(est)
                                                                  - 1)
    assert len(frustum) == 8 and bgr(frustum[0][0]) == (0, 0, 255)
    shade = img[(img[..., 0] != img[..., 1]) | (img[..., 1] != img[..., 2])]
    assert len(shade) > 1000                  # the bone-shaded mesh


def _live_run(out):
    os.makedirs(f"{out}/mesh")
    jmesh_io.write_ply(f"{out}/mesh/00002_mesh.ply", TET_V * 2.0, TET_F)
    est = _poses(np.stack([np.linspace(0.2, 0.6, 4), np.full(4, 0.5),
                           np.linspace(0.3, 0.5, 4)], -1))
    playback.write_live_state(out, 3, 4, est, est.copy())


def test_follow_live_once_names_as_jax(tmp_path):
    ours, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    _live_run(ours)
    shutil.copytree(ours, ref)
    got = playback.follow_live(ours, poll_s=0.01, once=True)
    want = jplayback.follow_live(ref, poll_s=0.01, once=True)
    assert [os.path.relpath(p, ours) for p in got] == \
        [os.path.relpath(p, ref) for p in want] == ["live_view/00003.png"]
    assert sorted(os.listdir(f"{ours}/live_view")) == \
        sorted(os.listdir(f"{ref}/live_view"))
    assert cv2.imread(got[0]).shape == (480, 640, 3)
    v, f, _ = mesh_io.read_ply(f"{ours}/mesh/00002_mesh.ply")
    assert len(v) == 4 and len(f) == 4
