"""RGB-D dataset loaders: Replica, ScanNet, TUM-RGBD, Azure, SyntheticRGBD.

Counterpart of `unislam_tpu/data/datasets.py`: a host-side pipeline that
yields numpy frames (color (H, W, 3) float32 in [0, 1], depth (H, W)
float32 meters, gt_c2w (4, 4) float32); UniSLAM builds rays itself. All
loaders:

- decode color (BGR -> RGB, /255) and depth (png / depth_scale * scale)
  with `cv2.imread`, as the JAX loaders do, giving their arrays bit for
  bit;
- undistort color (not depth) with the cfg distortion, resize color to the
  depth's size when they differ, and resize to `crop_size`;
- crop `crop_edge` pixels;
- flip the y/z axes of poses (OpenGL camera, c2w[:, 1:3] *= -1).

`get_dataset(cfg, input_folder=None, scale=1)` dispatches on
cfg['dataset'].
"""

from __future__ import annotations

import glob
import os
import re
from typing import List, Optional

import cv2
import numpy as np


def as_intrinsics_matrix(intrinsics):
    """[fx, fy, cx, cy] -> 3x3 K."""
    K = np.eye(3)
    K[0, 0], K[1, 1] = intrinsics[0], intrinsics[1]
    K[0, 2], K[1, 2] = intrinsics[2], intrinsics[3]
    return K


def alphanum_key(s):
    """Natural sort key: 'z23a' -> ['z', 23, 'a']."""
    return [int(x) if x.isdigit() else x for x in re.split(r"([0-9]+)", s)]


class BaseDataset:
    def __init__(self, cfg, input_folder: Optional[str] = None,
                 scale: float = 1.0):
        self.cfg = cfg
        self.name = cfg["dataset"]
        self.scale = scale
        self.png_depth_scale = cfg["cam"]["png_depth_scale"]
        self.H, self.W = cfg["cam"]["H"], cfg["cam"]["W"]
        self.fx, self.fy = cfg["cam"]["fx"], cfg["cam"]["fy"]
        self.cx, self.cy = cfg["cam"]["cx"], cfg["cam"]["cy"]
        self.distortion = (np.array(cfg["cam"]["distortion"])
                           if "distortion" in cfg["cam"] else None)
        self.crop_size = cfg["cam"].get("crop_size")
        self.crop_edge = cfg["cam"].get("crop_edge", 0)
        self.input_folder = input_folder or cfg["data"]["input_folder"]
        self.color_paths: List[str] = []
        self.depth_paths: List[str] = []
        self.poses: List[np.ndarray] = []
        self.n_img = 0

    def __len__(self):
        return self.n_img

    def __getitem__(self, index):
        color = cv2.imread(self.color_paths[index])
        depth = cv2.imread(self.depth_paths[index], cv2.IMREAD_UNCHANGED)
        if self.distortion is not None:
            K = as_intrinsics_matrix([self.fx, self.fy, self.cx, self.cy])
            color = cv2.undistort(color, K, self.distortion)
        color = (cv2.cvtColor(color, cv2.COLOR_BGR2RGB).astype(np.float32)
                 / 255.0)
        depth = depth.astype(np.float32) / self.png_depth_scale * self.scale
        H, W = depth.shape
        if color.shape[:2] != (H, W):
            color = cv2.resize(color, (W, H))

        if self.crop_size is not None:
            ch, cw = self.crop_size
            color = cv2.resize(color, (cw, ch), interpolation=cv2.INTER_LINEAR)
            depth = cv2.resize(depth, (cw, ch), interpolation=cv2.INTER_NEAREST)

        edge = self.crop_edge
        if edge > 0:
            color = color[edge:-edge, edge:-edge]
            depth = depth[edge:-edge, edge:-edge]

        pose = self.poses[index].copy()
        pose[:3, 3] *= self.scale
        return color, depth, pose.astype(np.float32)


class Replica(BaseDataset):
    """Replica frames: results/frame*.jpg + depth*.png + traj.txt."""

    def __init__(self, cfg, input_folder=None, scale=1.0):
        super().__init__(cfg, input_folder, scale)
        self.color_paths = sorted(
            glob.glob(f"{self.input_folder}/results/frame*.jpg"))
        self.depth_paths = sorted(
            glob.glob(f"{self.input_folder}/results/depth*.png"))
        self.n_img = len(self.color_paths)
        self._load_poses(f"{self.input_folder}/traj.txt")

    def _load_poses(self, path):
        with open(path) as f:
            lines = f.readlines()
        for i in range(self.n_img):
            c2w = np.array(list(map(float, lines[i].split()))).reshape(4, 4)
            c2w[:3, 1] *= -1
            c2w[:3, 2] *= -1
            self.poses.append(c2w.astype(np.float32))


class ScanNet(BaseDataset):
    """ScanNet exported frames: color/*.jpg, depth/*.png, pose/*.txt."""

    def __init__(self, cfg, input_folder=None, scale=1.0):
        super().__init__(cfg, input_folder, scale)
        self.color_paths = sorted(
            glob.glob(os.path.join(self.input_folder, "color", "*.jpg")),
            key=lambda x: int(os.path.basename(x)[:-4]))
        self.depth_paths = sorted(
            glob.glob(os.path.join(self.input_folder, "depth", "*.png")),
            key=lambda x: int(os.path.basename(x)[:-4]))
        self._load_poses(os.path.join(self.input_folder, "pose"))
        self.n_img = len(self.color_paths)

    def _load_poses(self, path):
        for pose_path in sorted(
                glob.glob(os.path.join(path, "*.txt")),
                key=lambda x: int(os.path.basename(x)[:-4])):
            with open(pose_path) as f:
                c2w = np.array(
                    [list(map(float, l.split())) for l in f.readlines()]
                ).reshape(4, 4)
            c2w[:3, 1] *= -1
            c2w[:3, 2] *= -1
            self.poses.append(c2w.astype(np.float32))


class TUM_RGBD(BaseDataset):
    """TUM sequences with timestamp association of rgb/depth/groundtruth."""

    def __init__(self, cfg, input_folder=None, scale=1.0):
        super().__init__(cfg, input_folder, scale)
        self.color_paths, self.depth_paths, self.poses = self._load_tum(
            self.input_folder, frame_rate=32)
        self.n_img = len(self.color_paths)

    @staticmethod
    def _parse_list(filepath, skiprows=0):
        return np.loadtxt(filepath, delimiter=" ", dtype=np.str_,
                          skiprows=skiprows)

    @staticmethod
    def _associate(t_img, t_depth, t_pose, max_dt=0.08):
        associations = []
        for i, t in enumerate(t_img):
            j = np.argmin(np.abs(t_depth - t))
            k = np.argmin(np.abs(t_pose - t))
            if abs(t_depth[j] - t) < max_dt and abs(t_pose[k] - t) < max_dt:
                associations.append((i, j, k))
        return associations

    @staticmethod
    def _pose_from_quat(pvec):
        from scipy.spatial.transform import Rotation
        pose = np.eye(4)
        pose[:3, :3] = Rotation.from_quat(pvec[3:]).as_matrix()
        pose[:3, 3] = pvec[:3]
        return pose

    def _load_tum(self, datapath, frame_rate=-1):
        if os.path.isfile(os.path.join(datapath, "groundtruth.txt")):
            pose_list = os.path.join(datapath, "groundtruth.txt")
        else:
            pose_list = os.path.join(datapath, "pose.txt")
        image_data = self._parse_list(os.path.join(datapath, "rgb.txt"))
        depth_data = self._parse_list(os.path.join(datapath, "depth.txt"))
        pose_data = self._parse_list(pose_list, skiprows=1)
        pose_vecs = pose_data[:, 1:].astype(np.float64)

        t_img = image_data[:, 0].astype(np.float64)
        t_depth = depth_data[:, 0].astype(np.float64)
        t_pose = pose_data[:, 0].astype(np.float64)
        assoc = self._associate(t_img, t_depth, t_pose)

        indices = [0]
        for i in range(1, len(assoc)):
            t0 = t_img[assoc[indices[-1]][0]]
            t1 = t_img[assoc[i][0]]
            if t1 - t0 > 1.0 / frame_rate:
                indices.append(i)

        images, depths, poses = [], [], []
        inv_pose = None
        for ix in indices:
            i, j, k = assoc[ix]
            images.append(os.path.join(datapath, str(image_data[i, 1])))
            depths.append(os.path.join(datapath, str(depth_data[j, 1])))
            c2w = self._pose_from_quat(pose_vecs[k])
            if inv_pose is None:
                # the first pose becomes the origin
                inv_pose = np.linalg.inv(c2w)
                c2w = np.eye(4)
            else:
                c2w = inv_pose @ c2w
            c2w[:3, 1] *= -1
            c2w[:3, 2] *= -1
            poses.append(c2w.astype(np.float32))
        return images, depths, poses


class Azure(BaseDataset):
    """Azure Kinect captures with an open3d trajectory.log."""

    def __init__(self, cfg, input_folder=None, scale=1.0):
        super().__init__(cfg, input_folder, scale)
        self.color_paths = sorted(
            glob.glob(os.path.join(self.input_folder, "color", "*.jpg")))
        self.depth_paths = sorted(
            glob.glob(os.path.join(self.input_folder, "depth", "*.png")))
        self.n_img = len(self.color_paths)
        self._load_poses(os.path.join(self.input_folder, "scene",
                                      "trajectory.log"))

    def _load_poses(self, path):
        if os.path.exists(path):
            with open(path) as f:
                content = f.readlines()
            for i in range(0, len(content), 5):
                c2w = np.array(
                    list(map(float,
                             ("".join(content[i + 1:i + 5])).split()))
                ).reshape(4, 4)
                c2w[:3, 1] *= -1
                c2w[:3, 2] *= -1
                self.poses.append(c2w.astype(np.float32))
        else:
            self.poses = [np.eye(4, dtype=np.float32)
                          for _ in range(self.n_img)]


class RGBDataset(BaseDataset):
    """SyntheticRGBD (NeuralRGBD scenes): images/*.png + depth_gt or
    depth_filtered + poses.txt of stacked 4x4 matrices."""

    def __init__(self, cfg, input_folder=None, scale=1.0):
        super().__init__(cfg, input_folder, scale)
        img_dir = os.path.join(self.input_folder, "images")
        self.color_paths = [
            os.path.join(img_dir, f)
            for f in sorted(os.listdir(img_dir), key=alphanum_key)
            if f.endswith("png")]
        depth_folder = cfg["data"].get("depth_folder", "depth")
        sub = "depth_gt" if depth_folder == "depth" else "depth_filtered"
        d_dir = os.path.join(self.input_folder, sub)
        self.depth_paths = [
            os.path.join(d_dir, f)
            for f in sorted(os.listdir(d_dir), key=alphanum_key)
            if f.endswith("png")]
        self.n_img = len(self.color_paths)
        self.poses, self.valid_poses = self._load_poses(
            os.path.join(self.input_folder, "poses.txt"))

    @staticmethod
    def _load_poses(path):
        with open(path) as f:
            lines = f.readlines()
        poses, valid = [], []
        for i in range(0, len(lines), 4):
            if "nan" in lines[i]:
                valid.append(False)
                poses.append(np.eye(4, dtype=np.float32))
            else:
                valid.append(True)
                mat = np.array(
                    [[float(x) for x in line.split()]
                     for line in lines[i:i + 4]], dtype=np.float32)
                poses.append(mat)
        return poses, valid


dataset_dict = {
    "replica": Replica,
    "scannet": ScanNet,
    "tumrgbd": TUM_RGBD,
    "azure": Azure,
    "systheticrgbd": RGBDataset,  # the JAX package's spelling, kept for configs
    "syntheticrgbd": RGBDataset,
}


def get_dataset(cfg, input_folder: Optional[str] = None, scale: float = 1.0):
    return dataset_dict[cfg["dataset"]](cfg, input_folder, scale)
