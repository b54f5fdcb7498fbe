"""Stereo rectification: undistort-rectify map construction + remap.

The equivalent of the cv::initUndistortRectifyMap +
cv::remap preprocessing the reference applies to EuRoC raw stereo pairs
(reference: Examples/Stereo/stereo_euroc.cc:60-82 map construction from the
LEFT.*/RIGHT.* YAML calibration, :165-166 per-frame remap; same flow in
Examples/ROS/ORB_SLAM2/src/ros_stereo.cc:71-110,158-162).

Design note: this is host-side IO preprocessing, deliberately done in numpy.
The maps are data-independent (built once per sequence), and the per-frame
remap runs on the host before the frame is handed to the extractor,
exactly as the reference runs cv::remap on the CPU.

A numpy copy of orb_slam2_detailed_comments_tpu/ops/rectify.py.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def init_undistort_rectify_map(K, D, R, P, size: Tuple[int, int]):
    """Build float32 (map_x, map_y) arrays of shape (H, W).

    Same semantics as cv::initUndistortRectifyMap (CV_32FC1 maps): for every
    destination pixel (u, v) of the rectified image, gives the source pixel
    in the raw image to sample.

    K: (3,3) raw intrinsics; D: distortion [k1,k2,p1,p2[,k3]] (any length
    up to 5, missing entries = 0); R: (3,3) rectifying rotation;
    P: (3,3) or (3,4) new (rectified) projection; size: (width, height).
    """
    K = np.asarray(K, np.float64)
    R = np.asarray(R, np.float64)
    P = np.asarray(P, np.float64)[:3, :3]
    d = np.zeros(5)
    Df = np.asarray(D, np.float64).ravel()
    d[: Df.size] = Df[:5]
    k1, k2, p1, p2, k3 = d

    w, h = int(size[0]), int(size[1])
    us, vs = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    ones = np.ones_like(us)
    # back-project through the rectified projection and rotation:
    # [X Y W]^T = (P R)^-1 [u v 1]^T
    iPR = np.linalg.inv(P @ R)
    X = iPR[0, 0] * us + iPR[0, 1] * vs + iPR[0, 2] * ones
    Y = iPR[1, 0] * us + iPR[1, 1] * vs + iPR[1, 2] * ones
    W = iPR[2, 0] * us + iPR[2, 1] * vs + iPR[2, 2] * ones
    x = X / W
    y = Y / W
    # distort (same radial-tangential model as PinholeCamera.distort_normalized)
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    map_x = (K[0, 0] * xd + K[0, 1] * yd + K[0, 2]).astype(np.float32)
    map_y = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
    return map_x, map_y


def remap_bilinear(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray,
                   border_value: float = 0.0) -> np.ndarray:
    """Bilinear remap (cv::remap with INTER_LINEAR + BORDER_CONSTANT).

    img: (H, W) float/uint8; maps: (Hd, Wd) float32 source coordinates.
    Out-of-bounds samples return border_value.
    """
    im = np.asarray(img, np.float32)
    H, W = im.shape
    x = np.asarray(map_x, np.float32)
    y = np.asarray(map_y, np.float32)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    ax = x - x0
    ay = y - y0
    valid = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    x0c = np.clip(x0, 0, W - 1)
    y0c = np.clip(y0, 0, H - 1)
    x1c = np.clip(x0 + 1, 0, W - 1)
    y1c = np.clip(y0 + 1, 0, H - 1)
    out = ((1 - ax) * (1 - ay) * im[y0c, x0c]
           + ax * (1 - ay) * im[y0c, x1c]
           + (1 - ax) * ay * im[y1c, x0c]
           + ax * ay * im[y1c, x1c])
    return np.where(valid, out, np.float32(border_value)).astype(np.float32)


class StereoRectifier:
    """Per-sequence stereo rectification, built from the LEFT.*/RIGHT.*
    calibration entries of a reference-format settings YAML (reference:
    Examples/Stereo/EuRoC.yaml:35-86; consumed by stereo_euroc.cc:60-82)."""

    def __init__(self, K_l, D_l, R_l, P_l, K_r, D_r, R_r, P_r,
                 size_l: Tuple[int, int], size_r: Tuple[int, int]):
        self.maps_l = init_undistort_rectify_map(K_l, D_l, R_l, P_l, size_l)
        self.maps_r = init_undistort_rectify_map(K_r, D_r, R_r, P_r, size_r)

    @classmethod
    def from_settings(cls, settings: dict) -> "StereoRectifier":
        """settings: dict from utils.config.load_settings_raw containing the
        LEFT./RIGHT. matrices. Raises KeyError when calibration is absent
        (mirrors the reference's hard error, stereo_euroc.cc:76-80)."""
        need = ["%s.%s" % (s, k) for s in ("LEFT", "RIGHT")
                for k in ("K", "D", "R", "P", "width", "height")]
        missing = [k for k in need if k not in settings]
        if missing:
            raise KeyError(
                "Calibration parameters to rectify stereo are missing: %s"
                % ", ".join(missing))
        return cls(
            settings["LEFT.K"], settings["LEFT.D"], settings["LEFT.R"],
            settings["LEFT.P"],
            settings["RIGHT.K"], settings["RIGHT.D"], settings["RIGHT.R"],
            settings["RIGHT.P"],
            (settings["LEFT.width"], settings["LEFT.height"]),
            (settings["RIGHT.width"], settings["RIGHT.height"]),
        )

    @classmethod
    def from_settings_yaml(cls, path: str) -> "StereoRectifier":
        from ..utils.config import load_settings_raw
        return cls.from_settings(load_settings_raw(path))

    def rectify_left(self, img: np.ndarray) -> np.ndarray:
        return remap_bilinear(img, *self.maps_l)

    def rectify_right(self, img: np.ndarray) -> np.ndarray:
        return remap_bilinear(img, *self.maps_r)

    def __call__(self, left: np.ndarray, right: np.ndarray):
        return self.rectify_left(left), self.rectify_right(right)


def has_rectification(settings: dict) -> bool:
    """True when the settings carry full LEFT./RIGHT. calibration."""
    need = ["%s.%s" % (s, k) for s in ("LEFT", "RIGHT")
            for k in ("K", "D", "R", "P", "width", "height")]
    return all(k in settings for k in need)
