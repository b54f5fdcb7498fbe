"""Per-frame container (host side).

Replaces the reference Frame (reference: src/Frame.h:69-496). The heavy
per-frame compute (extraction, undistortion, stereo matching) lives in
ops/; this object holds the fixed-capacity results plus the pose and the
per-keypoint map-point assignment. No feature grid is kept: area queries
are brute-force masked ops over all keypoints on the device (faster than
pointer-chasing a 64x48 bucket grid, reference Frame.cc:432-727).

Counterpart of orb_slam2_detailed_comments_tpu/state/frame.py: a copy, but
for `ensure_desc`, which turns the port's device tensor (the int32 bit-view)
into the (N, 8) uint32 numpy block.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..interop import desc_to_numpy


@dataclasses.dataclass
class FrameData:
    frame_id: int
    timestamp: float
    # fixed-capacity keypoint arrays (capacity N = config.orb.max_keypoints)
    xy: np.ndarray          # (N, 2) float32 undistorted level-0 coords
    response: np.ndarray    # (N,) float32
    octave: np.ndarray      # (N,) int32
    angle: np.ndarray       # (N,) float32 radians
    desc: np.ndarray        # (N, 8) uint32
    valid: np.ndarray       # (N,) bool
    ur: np.ndarray          # (N,) float32 right-image u; <0 if none
    depth: np.ndarray       # (N,) float32 stereo/RGBD depth; <0 if none
    # pose & association
    Tcw: Optional[np.ndarray] = None   # (4, 4) float32 world->cam
    mp: Optional[np.ndarray] = None    # (N,) int32 map point id or -1
    is_outlier: Optional[np.ndarray] = None  # (N,) bool (pose-opt outliers)
    ref_kf: int = -1

    def __post_init__(self):
        n = self.xy.shape[0]
        if self.mp is None:
            self.mp = np.full(n, -1, np.int32)
        if self.is_outlier is None:
            self.is_outlier = np.zeros(n, bool)

    def ensure_desc(self) -> None:
        """Materialize the descriptor block on the host. The fused frame
        path (frontend/tracking._track_fused) leaves `desc` as a device
        tensor (int32 bit-view) — it is only needed on keyframe creation or
        staged fallback, so the 64 KB pull is paid on those frames only."""
        if not isinstance(self.desc, np.ndarray):
            self.desc = desc_to_numpy(self.desc)

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]

    @property
    def n_valid(self) -> int:
        return int(self.valid.sum())

    def camera_center(self) -> np.ndarray:
        R = self.Tcw[:3, :3]
        t = self.Tcw[:3, 3]
        return -R.T @ t
