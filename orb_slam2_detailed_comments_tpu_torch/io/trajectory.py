"""Trajectory recovery + export in TUM / KITTI formats.

Counterpart of orb_slam2_detailed_comments_tpu/io/trajectory.py, the
replacement of System::SaveTrajectoryTUM / SaveTrajectoryKITTI /
SaveKeyFrameTrajectoryTUM (reference: src/System.cc:476-715). Per-frame
poses are recovered as Tcw = Tcr * Trw(ref KF), walking the spanning tree
upward past culled keyframes like the reference (System.cc:534-556).
Host numpy; the quaternion comes from geometry/so3.py on the CPU.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..geometry.so3 import rotmat_to_quat
from ..state.map_store import MapStore


def resolve_ref(ms: MapStore, ref: int) -> Tuple[np.ndarray, int]:
    """Walk up the spanning tree to the nearest live keyframe, chaining the
    relative poses frozen at cull time (reference: mTcp)."""
    Tcorr = np.eye(4, dtype=np.float32)
    while ref >= 0 and not ms.kf_valid[ref]:
        parent = int(ms.parent[ref])
        if parent < 0:
            return Tcorr, -1
        Tcorr = Tcorr @ ms.kf_Tcp[ref]
        ref = parent
    return Tcorr, ref


def recover_frame_trajectory(trajectory: List, ms: MapStore):
    """trajectory entries: (frame_id, ts, Tcr, ref_kf, lost).
    Returns list of (frame_id, ts, Tcw (4,4)) skipping lost frames."""
    out = []
    for frame_id, ts, Tcr, ref, lost in trajectory:
        if lost or ref < 0:
            continue
        Tcorr, live_ref = resolve_ref(ms, int(ref))
        if live_ref < 0:
            continue
        Tcw = Tcr @ Tcorr @ ms.kf_Tcw[live_ref]
        out.append((frame_id, ts, Tcw.astype(np.float32)))
    return out


def _pose_to_tum_line(ts: float, Tcw: np.ndarray) -> str:
    Twc = np.linalg.inv(Tcw)
    t = Twc[:3, 3]
    q = rotmat_to_quat(torch.from_numpy(np.ascontiguousarray(Twc[:3, :3]))).numpy()  # (w, x, y, z)
    return f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}"


def save_trajectory_tum(path: str, trajectory: List, ms: MapStore) -> None:
    """TUM format: 'ts tx ty tz qx qy qz qw' of camera-to-world
    (reference: System::SaveTrajectoryTUM, System.cc:476-581)."""
    frames = recover_frame_trajectory(trajectory, ms)
    with open(path, "w") as f:
        for _, ts, Tcw in frames:
            f.write(_pose_to_tum_line(ts, Tcw) + "\n")


def save_keyframe_trajectory_tum(path: str, ms: MapStore) -> None:
    """reference: System::SaveKeyFrameTrajectoryTUM (System.cc:591-641)."""
    with open(path, "w") as f:
        for k in ms.keyframe_ids():
            f.write(_pose_to_tum_line(float(ms.kf_timestamp[k]), ms.kf_Tcw[k]) + "\n")


def save_trajectory_kitti(path: str, trajectory: List, ms: MapStore) -> None:
    """KITTI format: 12 numbers per line, row-major 3x4 camera-to-world
    (reference: System::SaveTrajectoryKITTI, System.cc:645-715)."""
    frames = recover_frame_trajectory(trajectory, ms)
    with open(path, "w") as f:
        for _, _, Tcw in frames:
            Twc = np.linalg.inv(Tcw)
            row = Twc[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")
