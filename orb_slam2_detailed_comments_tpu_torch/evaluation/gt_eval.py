"""Ground-truth discovery + ATE/RPE evaluation for dataset runs.

The reference points users at the external TUM evaluation scripts
(reference: README.md:192-196, associate.py + online service); here the
parity number is ONE command: examples/run_slam.py auto-discovers the
ground-truth file next to the sequence, associates timestamps, and prints
ATE/RPE against the exported trajectory, so the day real data exists,
the A/B against the published numbers is free.

Supported ground-truth formats:
  * TUM RGB-D:  <seq>/groundtruth.txt         "ts tx ty tz qx qy qz qw"
  * KITTI odometry: <root>/poses/<seq>.txt or <seq>/poses.txt — 12
    numbers/line, row-major 3x4 camera-to-world, one line per frame
  * EuRoC MAV: <mav>/state_groundtruth_estimate0/data.csv
    (ns timestamp, position, quaternion w-first)

A copy of orb_slam2_detailed_comments_tpu/evaluation/gt_eval.py over this
package's evaluation/ate.py.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np


def _quat_to_rot(qx, qy, qz, qw):
    n = max(np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw), 1e-12)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
    ], np.float64)


def load_tum_gt(path: str) -> List[Tuple[float, np.ndarray]]:
    """TUM format: ts tx ty tz qx qy qz qw (camera-to-world)."""
    out = []
    for ln in open(path):
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        v = ln.split()
        if len(v) < 8:
            continue
        ts = float(v[0])
        t = np.array([float(x) for x in v[1:4]])
        qx, qy, qz, qw = (float(x) for x in v[4:8])
        T = np.eye(4)
        T[:3, :3] = _quat_to_rot(qx, qy, qz, qw)
        T[:3, 3] = t
        out.append((ts, T))
    return out


def load_kitti_gt(path: str) -> List[np.ndarray]:
    """KITTI format: 12 numbers per line, row-major 3x4 camera-to-world."""
    out = []
    for ln in open(path):
        v = [float(x) for x in ln.split()]
        if len(v) != 12:
            continue
        T = np.eye(4)
        T[:3, :4] = np.asarray(v).reshape(3, 4)
        out.append(T)
    return out


def load_euroc_gt(path: str) -> List[Tuple[float, np.ndarray]]:
    """EuRoC state_groundtruth_estimate0/data.csv: ns ts, p_xyz, q_wxyz."""
    out = []
    for ln in open(path):
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        v = ln.replace(",", " ").split()
        if len(v) < 8:
            continue
        ts = float(v[0]) * 1e-9
        t = np.array([float(x) for x in v[1:4]])
        qw, qx, qy, qz = (float(x) for x in v[4:8])
        T = np.eye(4)
        T[:3, :3] = _quat_to_rot(qx, qy, qz, qw)
        T[:3, 3] = t
        out.append((ts, T))
    return out


def discover_ground_truth(mode: str, seq_dir: str) -> Optional[Tuple[str, str]]:
    """Return (format, path) of the sequence's ground truth, or None.
    format in {"tum", "kitti", "euroc"}."""
    seq_dir = os.path.abspath(seq_dir)
    if mode.startswith("tum"):
        p = os.path.join(seq_dir, "groundtruth.txt")
        return ("tum", p) if os.path.exists(p) else None
    if mode.startswith("kitti"):
        cands = [os.path.join(seq_dir, "poses.txt")]
        # <root>/sequences/<nn> -> <root>/poses/<nn>.txt
        base = os.path.basename(seq_dir)
        up2 = os.path.dirname(os.path.dirname(seq_dir))
        cands.append(os.path.join(up2, "poses", base + ".txt"))
        for p in cands:
            if os.path.exists(p):
                return ("kitti", p)
        return None
    if mode.startswith("euroc"):
        p = os.path.join(seq_dir, "state_groundtruth_estimate0", "data.csv")
        return ("euroc", p) if os.path.exists(p) else None
    return None


def _associate(ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02):
    """Nearest-timestamp association a->b within max_dt (the TUM
    associate.py policy). Returns (idx_a, idx_b)."""
    ia, ib = [], []
    j = 0
    order = np.argsort(ts_b)
    tsb = ts_b[order]
    for i, t in enumerate(ts_a):
        j = int(np.searchsorted(tsb, t))
        best, bdt = -1, max_dt
        for k in (j - 1, j):
            if 0 <= k < len(tsb) and abs(tsb[k] - t) <= bdt:
                best, bdt = k, abs(tsb[k] - t)
        if best >= 0:
            ia.append(i)
            ib.append(int(order[best]))
    return np.asarray(ia, np.int64), np.asarray(ib, np.int64)


def evaluate_against_gt(mode: str, seq_dir: str, frames, mono: bool,
                        rpe_delta: int = 10) -> Optional[dict]:
    """frames: list of (frame_id, ts, Tcw) from
    io.trajectory.recover_frame_trajectory. Returns the metric dict or
    None when no ground truth exists. mono=True uses similarity (Sim3)
    alignment — scale is unobservable (the reference papers evaluate
    monocular the same way)."""
    gt = discover_ground_truth(mode, seq_dir)
    if gt is None or not frames:
        return None
    fmt, path = gt
    est_Twc = [np.linalg.inv(T) for _, _, T in frames]
    if fmt == "kitti":
        gt_list = load_kitti_gt(path)
        # frame-id indexed (KITTI gt is one line per frame)
        pairs = [(np.asarray(est_Twc[i]), np.asarray(gt_list[fid]))
                 for i, (fid, _, _) in enumerate(frames)
                 if fid < len(gt_list)]
    else:
        gt_list = load_tum_gt(path) if fmt == "tum" else load_euroc_gt(path)
        gt_ts = np.asarray([t for t, _ in gt_list])
        est_ts = np.asarray([ts for _, ts, _ in frames])
        ia, ib = _associate(est_ts, gt_ts)
        pairs = [(est_Twc[i], gt_list[j][1]) for i, j in zip(ia, ib)]
    if len(pairs) < 3:
        return None
    from .ate import align_umeyama, ate_rmse, rpe_rmse
    E = np.stack([p[0] for p in pairs])
    G = np.stack([p[1] for p in pairs])
    ate = ate_rmse(E[:, :3, 3], G[:, :3, 3], with_scale=mono)
    # RPE on scale-aligned estimates for mono (pure relative drift)
    s, _, _ = align_umeyama(E[:, :3, 3], G[:, :3, 3], mono)
    E_s = E.copy()
    E_s[:, :3, 3] *= s
    rpe = rpe_rmse(E_s, G, delta=min(rpe_delta, max(len(pairs) - 1, 1)))
    travel = float(np.linalg.norm(np.diff(G[:, :3, 3], axis=0), axis=1).sum())
    return {
        "gt_file": path, "gt_format": fmt, "n_pairs": len(pairs),
        "ate_rmse_m": round(float(ate), 4),
        "ate_pct_travel": round(100.0 * ate / max(travel, 1e-9), 4),
        "rpe_trans_rmse_m": round(float(rpe), 4),
        "rpe_delta_frames": int(min(rpe_delta, max(len(pairs) - 1, 1))),
        "travel_m": round(travel, 2),
        "alignment": "sim3" if mono else "se3",
    }
