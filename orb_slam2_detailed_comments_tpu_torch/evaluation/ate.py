"""Trajectory accuracy metrics (ATE / RPE).

The reference delegates accuracy evaluation to the external TUM benchmark
scripts (reference: README.md:192-196 points at associate.py / the online
evaluation service); we build the standard metrics in so tests and bench
runs are self-contained. ATE follows Sturm et al. (IROS 2012): similarity
(or rigid) Umeyama alignment, then RMSE over translation residuals.

A copy of orb_slam2_detailed_comments_tpu/evaluation/ate.py.
"""
from __future__ import annotations

import numpy as np


def align_umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning src -> dst.

    src, dst: (N, 3). Returns (s, R, t) with dst ~ s * R @ src + t.
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray, with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE after Umeyama alignment.
    with_scale=True for monocular (scale unobservable), False for stereo/RGB-D."""
    s, R, t = align_umeyama(est_xyz, gt_xyz, with_scale)
    aligned = (s * (R @ est_xyz.T)).T + t
    err = np.linalg.norm(aligned - gt_xyz, axis=-1)
    return float(np.sqrt((err ** 2).mean()))


def rpe_rmse(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1) -> float:
    """Relative pose error (translation) over frame pairs at distance delta.
    est_poses, gt_poses: (N, 4, 4) camera-to-world."""
    errs = []
    for i in range(len(est_poses) - delta):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        e = np.linalg.inv(dg) @ de
        errs.append(np.linalg.norm(e[:3, 3]))
    return float(np.sqrt(np.mean(np.square(errs)))) if errs else 0.0
