"""Dataset loaders: TUM RGB-D, KITTI odometry, EuRoC MAV.

Replaces the per-dataset example drivers' image/timestamp loading
(reference: Examples/Monocular/mono_tum.cc LoadImages, mono_kitti.cc,
mono_euroc.cc, rgbd_tum.cc, stereo_kitti.cc, stereo_euroc.cc) with one
loader family. Also includes the TUM RGB-D association logic that the
reference delegates to the external associate.py (README.md:158-165).

A copy of orb_slam2_detailed_comments_tpu/io/datasets.py whose two image
loaders read PNG through this package's own codec (io/png.py) instead of
PIL: the same float32 arrays, RGB converted to grey as PIL's convert("L").
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from .png import read_png, to_gray


def load_image_gray(path: str) -> np.ndarray:
    """Load a PNG as (H, W) float32 grayscale in [0, 255]. A 16-bit image
    saturates at 255, as PIL's convert("L") of one does."""
    img = read_png(path)
    if img.dtype == np.uint16:
        img = np.minimum(img, 255)
    return to_gray(img).astype(np.float32)


def load_depth_png(path: str, depth_factor: float = 5000.0) -> np.ndarray:
    """TUM 16-bit depth PNG -> meters (reference: Tracking.cc DepthMapFactor
    scaling, :204-211)."""
    d = read_png(path).astype(np.float32)
    return d / depth_factor


class TumRgbdDataset:
    """TUM RGB-D: rgb.txt / depth.txt with 'timestamp path' lines.
    Associates rgb<->depth by nearest timestamp (max_diff 0.02s), the same
    policy as the benchmark's associate.py. Alternatively pass
    ``associations`` — a pre-built association file with
    `ts_rgb rgb_path ts_depth depth_path` lines, the format the reference's
    rgbd_tum driver consumes (reference: Examples/RGB-D/rgbd_tum.cc
    LoadImages)."""

    def __init__(self, root: str, max_diff: float = 0.02, depth_factor: float = 5000.0,
                 associations: Optional[str] = None):
        self.root = root
        self.depth_factor = depth_factor
        self.pairs: List[Tuple[float, str, Optional[str]]] = []
        if associations:
            with open(associations) as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    parts = line.split()
                    self.pairs.append((float(parts[0]), parts[1], parts[3]))
            return
        rgb = self._read_list(os.path.join(root, "rgb.txt"))
        depth = self._read_list(os.path.join(root, "depth.txt"))
        d_ts = np.asarray([t for t, _ in depth]) if depth else np.empty(0)
        for t, p in rgb:
            if len(depth):
                i = int(np.argmin(np.abs(d_ts - t)))
                dp = depth[i][1] if abs(d_ts[i] - t) < max_diff else None
            else:
                dp = None
            self.pairs.append((t, p, dp))

    @staticmethod
    def _read_list(path: str):
        out = []
        if not os.path.exists(path):
            return out
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                out.append((float(parts[0]), parts[1]))
        return out

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i):
        t, rgb_rel, depth_rel = self.pairs[i]
        img = load_image_gray(os.path.join(self.root, rgb_rel))
        depth = (load_depth_png(os.path.join(self.root, depth_rel), self.depth_factor)
                 if depth_rel else None)
        return t, img, depth

    def groundtruth(self) -> Optional[np.ndarray]:
        """(N, 8) array ts,tx,ty,tz,qx,qy,qz,qw if groundtruth.txt exists."""
        path = os.path.join(self.root, "groundtruth.txt")
        if not os.path.exists(path):
            return None
        rows = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                rows.append([float(x) for x in line.split()])
        return np.asarray(rows)


class KittiOdometryDataset:
    """KITTI odometry: image_0/ (left) + image_1/ (right) + times.txt
    (reference: Examples/Stereo/stereo_kitti.cc LoadImages)."""

    def __init__(self, sequence_dir: str, stereo: bool = True):
        self.dir = sequence_dir
        self.stereo = stereo
        with open(os.path.join(sequence_dir, "times.txt")) as f:
            self.times = [float(line.strip()) for line in f if line.strip()]
        self.left_dir = os.path.join(sequence_dir, "image_0")
        self.right_dir = os.path.join(sequence_dir, "image_1")

    def __len__(self):
        return len(self.times)

    def __getitem__(self, i):
        name = f"{i:06d}.png"
        left = load_image_gray(os.path.join(self.left_dir, name))
        right = load_image_gray(os.path.join(self.right_dir, name)) if self.stereo else None
        return self.times[i], left, right


class EurocDataset:
    """EuRoC MAV: mav0/cam0/data + timestamp list file
    (reference: Examples/Monocular/mono_euroc.cc LoadImages with
    EuRoC_TimeStamps)."""

    def __init__(self, root: Optional[str] = None, timestamps_file: Optional[str] = None,
                 stereo: bool = False, cam0_dir: Optional[str] = None,
                 cam1_dir: Optional[str] = None):
        self.stereo = stereo
        self.cam0 = cam0_dir or os.path.join(root, "mav0", "cam0", "data")
        self.cam1 = cam1_dir or (os.path.join(root, "mav0", "cam1", "data") if root else None)
        if timestamps_file and os.path.exists(timestamps_file):
            with open(timestamps_file) as f:
                names = [line.strip() for line in f if line.strip()]
        else:
            names = sorted(os.path.splitext(n)[0] for n in os.listdir(self.cam0))
        self.names = names

    def __len__(self):
        return len(self.names)

    def __getitem__(self, i):
        name = self.names[i]
        t = float(name) / 1e9
        left = load_image_gray(os.path.join(self.cam0, name + ".png"))
        right = (load_image_gray(os.path.join(self.cam1, name + ".png"))
                 if self.stereo else None)
        return t, left, right


class RectifiedStereoDataset:
    """Wrap a stereo dataset yielding raw pairs with per-frame rectification
    (reference: stereo_euroc.cc:165-166 cv::remap before TrackStereo)."""

    def __init__(self, base, rectifier):
        self.base = base
        self.rectifier = rectifier

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        t, left, right = self.base[i]
        left, right = self.rectifier(left, right)
        return t, left, right
