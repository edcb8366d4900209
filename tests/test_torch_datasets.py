"""The port's dataset loaders (`unislam_tpu_torch/data/datasets.py`) against
the JAX package's, on files the test writes with cv2 (JPEG and PNG colour,
16-bit depth, every pose format): colour, depth and pose arrays bitwise
equal, with crop_size, crop_edge and distortion; `get_dataset`; and the
prefetcher's `try_get` against the JAX `FramePrefetcher`'s."""

import os
import time

import cv2
import numpy as np
import pytest

from unislam_tpu.data import datasets as jds
from unislam_tpu.data.prefetch import FramePrefetcher as JPrefetcher
from unislam_tpu_torch.data import datasets as tds
from unislam_tpu_torch.data.prefetch import FramePrefetcher as TPrefetcher

H, W = 24, 32


def _rot_z(deg):
    th = np.deg2rad(deg)
    m = np.eye(4)
    m[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
    return m


def _pose(i):
    m = _rot_z(7.0 * i)
    m[:3, 3] = [0.1 * i, -0.05 * i, 0.02 * i]
    return m


def _write_frame(color_path, depth_path, seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    cv2.imwrite(color_path, rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
    cv2.imwrite(depth_path, rng.integers(1, 60000, (h, w)).astype(np.uint16))


def _cam(depth_scale=1000.0, **extra):
    cam = {"H": H, "W": W, "fx": 30.0, "fy": 31.0, "cx": 15.3, "cy": 11.6,
           "png_depth_scale": depth_scale, "crop_edge": 0}
    cam.update(extra)
    return cam


def _replica(d, n=3, ext="jpg"):
    (d / "results").mkdir(parents=True)
    for i in range(n):
        _write_frame(str(d / "results" / f"frame{i:06d}.{ext}"),
                     str(d / "results" / f"depth{i:06d}.png"), i)
    (d / "traj.txt").write_text("\n".join(
        " ".join(f"{v:.9f}" for v in _pose(i).reshape(-1))
        for i in range(n)) + "\n")


def _scannet(d, n=3):
    for sub in ("color", "depth", "pose"):
        (d / sub).mkdir(parents=True)
    for i in range(n):
        _write_frame(str(d / "color" / f"{i}.jpg"),
                     str(d / "depth" / f"{i}.png"), 10 + i)
        (d / "pose" / f"{i}.txt").write_text("\n".join(
            " ".join(str(v) for v in row) for row in _pose(i)))


def _tum(d, n=4):
    from scipy.spatial.transform import Rotation
    (d / "rgb").mkdir(parents=True)
    (d / "depth").mkdir()
    rgb, dep, gt = [], [], ["# ground truth"]
    for i in range(n):
        t = 100.0 + 0.5 * i
        _write_frame(str(d / "rgb" / f"{i}.png"),
                     str(d / "depth" / f"{i}.png"), 20 + i)
        rgb.append(f"{t:.4f} rgb/{i}.png")
        dep.append(f"{t + 0.02:.4f} depth/{i}.png")
        m = _pose(i)
        q = Rotation.from_matrix(m[:3, :3]).as_quat()
        gt.append(f"{t + 0.01:.4f} {m[0, 3]} {m[1, 3]} {m[2, 3]} "
                  f"{q[0]} {q[1]} {q[2]} {q[3]}")
    (d / "rgb.txt").write_text("\n".join(rgb) + "\n")
    (d / "depth.txt").write_text("\n".join(dep) + "\n")
    (d / "groundtruth.txt").write_text("\n".join(gt) + "\n")


def _azure(d, n=2, log=True):
    for sub in ("color", "depth", "scene"):
        (d / sub).mkdir(parents=True)
    lines = []
    for i in range(n):
        _write_frame(str(d / "color" / f"{i:05d}.jpg"),
                     str(d / "depth" / f"{i:05d}.png"), 30 + i)
        lines.append(f"{i} {i} {i + 1}")
        lines += [" ".join(str(v) for v in row) for row in _pose(i)]
    if log:
        (d / "scene" / "trajectory.log").write_text("\n".join(lines) + "\n")


def _rgbd(d, n=3):
    (d / "images").mkdir(parents=True)
    (d / "depth_filtered").mkdir()
    lines = []
    for i in range(n):
        _write_frame(str(d / "images" / f"img{i}.png"),
                     str(d / "depth_filtered" / f"depth{i}.png"), 40 + i)
        lines += (["nan nan nan nan"] * 4 if i == 1 else
                  [" ".join(f"{v:.6f}" for v in row) for row in _pose(i)])
    (d / "poses.txt").write_text("\n".join(lines) + "\n")


FORMATS = {"replica": _replica, "scannet": _scannet, "tumrgbd": _tum,
           "azure": _azure, "syntheticrgbd": _rgbd}


def _pair(tmp_path, name, cam=None, **data):
    folder = tmp_path / name
    FORMATS[name](folder)
    cfg = {"dataset": name, "cam": cam or _cam(),
           "data": {"input_folder": str(folder), **data}}
    return jds.get_dataset(cfg), tds.get_dataset(cfg)


def _assert_same(jd, td):
    assert len(jd) == len(td) and len(td) > 0
    assert type(td).__name__ == type(jd).__name__
    for i in range(len(jd)):
        for a, b in zip(jd[i], td[i]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_loaders_match_jax_bitwise(tmp_path, name):
    data = {"depth_folder": "filtered"} if name == "syntheticrgbd" else {}
    _assert_same(*_pair(tmp_path, name, **data))


@pytest.mark.parametrize("cam", [
    dict(crop_size=[16, 20]), dict(crop_edge=3),
    dict(crop_size=[18, 26], crop_edge=2),
    dict(distortion=[0.1, -0.05, 0.001, 0.001, 0.0]),
    dict(distortion=[0.05, 0.0, 0.0, 0.0, 0.0], crop_edge=1)],
    ids=["crop_size", "crop_edge", "both", "distortion", "distortion_edge"])
def test_crop_and_distortion_match_jax_bitwise(tmp_path, cam):
    _assert_same(*_pair(tmp_path, "replica", cam=_cam(**cam)))


def test_png_colour_under_jpg_names_and_scale(tmp_path):
    """Replica frames whose .jpg files hold PNG bytes (as
    synthetic.write_replica writes them) read the same in both loaders,
    and `scale` scales depth and translation alike."""
    folder = tmp_path / "r"
    _replica(folder, ext="png")
    for p in (folder / "results").glob("frame*.png"):
        p.rename(p.with_suffix(".jpg"))
    cfg = {"dataset": "replica", "cam": _cam(6553.5),
           "data": {"input_folder": str(folder)}}
    _assert_same(jds.get_dataset(cfg, scale=2.0),
                 tds.get_dataset(cfg, scale=2.0))


def test_azure_without_log_and_dispatch(tmp_path):
    folder = tmp_path / "az"
    _azure(folder, log=False)
    cfg = {"dataset": "azure", "cam": _cam(),
           "data": {"input_folder": str(folder)}}
    _assert_same(jds.get_dataset(cfg), tds.get_dataset(cfg))
    assert set(tds.dataset_dict) == set(jds.dataset_dict)
    for k, v in tds.dataset_dict.items():
        assert v.__name__ == jds.dataset_dict[k].__name__


class _Slow:
    def __init__(self, n=6, delay=0.02):
        self.n, self.delay, self.reads = n, delay, []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.reads.append(i)
        time.sleep(self.delay)
        return (np.full((2, 2, 3), i, np.float32),
                np.full((2, 2), i, np.float32), np.eye(4) * i)


def test_try_get_matches_jax_prefetcher():
    """try_get is None until a frame's decode is done, then that frame
    once; every frame is read from the dataset once, as the JAX
    prefetcher reads it; the port also counts the reads."""
    seqs = []
    for cls in (JPrefetcher, TPrefetcher):
        ds = _Slow()
        pf = cls(ds, ahead=2)
        got = [pf.try_get(0)]                    # nothing scheduled yet
        pf[0]                                    # schedules 1, 2
        deadline = time.time() + 5
        nxt = None
        while nxt is None and time.time() < deadline:
            nxt = pf.try_get(1)
        got.append(None if nxt is None else float(nxt[0][0, 0, 0]))
        got.append(pf.try_get(1))                # already taken
        for i in range(2, 6):
            got.append(float(pf[i][1][0, 0]))
        pf.close()
        seqs.append((got, sorted(ds.reads)))
        if cls is TPrefetcher:
            assert max(pf.reads.values()) == 1 and len(pf.reads) == 6
    assert seqs[0] == seqs[1]
    assert seqs[1][0] == [None, 1.0, None, 2.0, 3.0, 4.0, 5.0]
    assert seqs[1][1] == list(range(6))


def test_write_replica_round_trip(tmp_path):
    """synthetic.write_replica writes what the Replica loaders of both
    packages read: depth within 1/png_depth_scale, colour within 1/255,
    poses as written (float32)."""
    from unislam_tpu_torch.core.rays import Intrinsics
    from unislam_tpu_torch.data.synthetic import SyntheticRoom, write_replica
    ds = SyntheticRoom(n_frames=3, intr=Intrinsics(H=20, W=28, fx=25.0,
                                                   fy=25.0, cx=13.5,
                                                   cy=9.5))
    frames = [ds[i] for i in range(3)]
    assert write_replica(frames, str(tmp_path / "room")) == 3
    cfg = {"dataset": "replica", "cam": {**_cam(6553.5), "H": 20, "W": 28},
           "data": {"input_folder": str(tmp_path / "room")}}
    jd, td = jds.get_dataset(cfg), tds.get_dataset(cfg)
    _assert_same(jd, td)
    for (c, d, p), (c2, d2, p2) in zip(frames, (td[i] for i in range(3))):
        assert np.abs(c - c2).max() <= 1.0 / 255 + 1e-6
        assert np.abs(d - d2).max() <= 1.0 / 6553.5 + 1e-6
        np.testing.assert_allclose(p2, p, atol=1e-6)
    assert os.path.exists(tmp_path / "room" / "traj.txt")
