"""Pinhole camera model with radial-tangential distortion.

Counterpart of orb_slam2_detailed_comments_tpu/geometry/camera.py. The
intrinsics are plain Python floats; the methods act on tensors of any
device and keep their dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class PinholeCamera(NamedTuple):
    """Static camera intrinsics. Fields mirror the reference's YAML config
    keys Camera.{fx,fy,cx,cy,k1,k2,p1,p2,k3,bf} (reference: Tracking.cc:87-151)."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 0.0        # stereo baseline * fx (reference: Tracking.cc:154)
    width: int = 640
    height: int = 480

    def K(self, device="cuda"):
        """(3, 3) float32 intrinsic matrix on `device`."""
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32, device=device)

    @property
    def baseline(self):
        return self.bf / self.fx

    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))

    def backproject(self, uv, depth):
        """Pixel (..., 2) + depth (...,) -> camera-frame points (..., 3).
        (reference: Frame::UnprojectStereo, Frame.cc:1220-1252)."""
        x = (uv[..., 0] - self.cx) / self.fx * depth
        y = (uv[..., 1] - self.cy) / self.fy * depth
        return torch.stack([x, y, depth], dim=-1)

    def undistort_pixels(self, uv):
        """Undistort pixel coords (..., 2) -> undistorted pixel coords, by
        8 steps of the fixed-point iteration of cv::undistortPoints
        (reference: Frame::UndistortKeyPoints, Frame.cc:770-817)."""
        if not self.has_distortion():
            return uv
        xd = (uv[..., 0] - self.cx) / self.fx
        yd = (uv[..., 1] - self.cy) / self.fy
        d = torch.stack([xd, yd], dim=-1)
        xy = d
        for _ in range(8):
            x, y = xy[..., 0], xy[..., 1]
            r2 = x * x + y * y
            radial = 1.0 + r2 * (self.k1 + r2 * (self.k2 + r2 * self.k3))
            dx = 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
            dy = self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
            xy = torch.stack([(d[..., 0] - dx) / radial, (d[..., 1] - dy) / radial], dim=-1)
        u = xy[..., 0] * self.fx + self.cx
        v = xy[..., 1] * self.fy + self.cy
        return torch.stack([u, v], dim=-1)
