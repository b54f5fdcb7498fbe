"""Batched Sim3 RANSAC via Horn's closed-form absolute orientation.

Counterpart of orb_slam2_detailed_comments_tpu/solvers/sim3_solver.py, the
replacement of Sim3Solver (reference: src/Sim3Solver.cc): every 3-point
hypothesis is solved at once (Horn's quaternion method, a batched
eigendecomposition of 4x4 matrices) and all hypotheses are scored against
all correspondences in one bidirectional reprojection pass on `device`.

The samples are drawn on the host with np.random.default_rng(seed) in the
JAX package's order, so both packages score the same hypotheses; the best
is the first of equal inlier counts (torch.argmax, as jnp.argmax).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..geometry.so3 import quat_to_rotmat

N_HYPOTHESES = 300  # reference: RANSAC 300 iterations (LoopClosing.cc:487)
CHI2_SIM3 = 9.210   # reference: Sim3Solver.cc mvnMaxError chi2 th


class Sim3Result(NamedTuple):
    R: np.ndarray
    t: np.ndarray
    s: float
    inliers: np.ndarray
    n_inliers: int


def _horn_batched(p1, p2, fix_scale: bool):
    """p1, p2: (B, S, 3) matched camera-frame points; returns (R (B,3,3),
    t (B,3), s (B,)) with p2 ~ s R p1 + t (Horn 1987, as in
    Sim3Solver::ComputeSim3, reference :329-445). The eigenvector's sign
    is free; q and -q give the same R."""
    c1 = p1.mean(dim=1, keepdim=True)
    c2 = p2.mean(dim=1, keepdim=True)
    q1 = p1 - c1
    q2 = p2 - c2
    M = torch.einsum("bsi,bsj->bij", q1, q2)  # Horn's M; R(q_max) maps 1 -> 2
    Sxx, Sxy, Sxz = M[:, 0, 0], M[:, 0, 1], M[:, 0, 2]
    Syx, Syy, Syz = M[:, 1, 0], M[:, 1, 1], M[:, 1, 2]
    Szx, Szy, Szz = M[:, 2, 0], M[:, 2, 1], M[:, 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)  # (B, 4, 4)
    _, vecs = torch.linalg.eigh(N)
    R = quat_to_rotmat(vecs[..., :, 3])  # largest eigenvalue -> (w, x, y, z)

    # symmetric scale (the reference uses the asymmetric form for mono)
    rot_q1 = torch.einsum("bij,bsj->bsi", R, q1)
    num = torch.sum(q2 * rot_q1, dim=(1, 2))
    den = torch.sum(q1 * q1, dim=(1, 2))
    s = torch.ones_like(num) if fix_scale else num / torch.clamp(den, min=1e-12)
    t = c2[:, 0] - s[:, None] * torch.einsum("bij,bj->bi", R, c1[:, 0])
    return R, t, s


def _ransac_sim3(p1, p2, uv1, uv2, valid, max_err1, max_err2, sample_idx, K,
                 fix_scale: bool):
    """Score all hypotheses; p1/p2 (M, 3) cam-frame points; uv1/uv2 (M, 2)
    observed pixels in each KF; max_err* per-correspondence chi2 limits."""
    R, t, s = _horn_batched(p1[sample_idx], p2[sample_idx], fix_scale)

    def project(P):
        z = torch.where(torch.abs(P[..., 2]) < 1e-9, 1e-9, P[..., 2])
        return torch.stack([K[0, 0] * P[..., 0] / z + K[0, 2],
                            K[1, 1] * P[..., 1] / z + K[1, 2]], dim=-1)

    # forward: p1 -> frame 2
    p12 = s[:, None, None] * torch.einsum("bij,mj->bmi", R, p1) + t[:, None, :]
    e2 = torch.sum((project(p12) - uv2[None]) ** 2, dim=-1)
    # inverse: p2 -> frame 1
    Rt = R.transpose(-1, -2)
    p21 = torch.einsum("bij,bmj->bmi", Rt, p2[None] - t[:, None, :]) / s[:, None, None]
    e1 = torch.sum((project(p21) - uv1[None]) ** 2, dim=-1)

    inl = (e1 < max_err1[None]) & (e2 < max_err2[None]) & valid[None]
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts)
    return R[best], t[best], s[best], inl[best], counts[best]


def solve_sim3_ransac(p1: np.ndarray, p2: np.ndarray, uv1: np.ndarray,
                      uv2: np.ndarray, valid: np.ndarray,
                      octave1: np.ndarray, octave2: np.ndarray,
                      sigma2_levels: np.ndarray, K: np.ndarray,
                      fix_scale: bool, min_inliers: int = 20,
                      seed: int = 0, device="cuda") -> Optional[Sim3Result]:
    """RANSAC Sim3 between two matched camera-frame point sets (host numpy
    in and out, the hypotheses solved and scored on `device`; reference:
    Sim3Solver::iterate, called with minInliers=20, LoopClosing.cc:487-509)."""
    vidx = np.nonzero(valid)[0]
    if vidx.size < 3:
        return None
    rng = np.random.default_rng(seed)
    samples = np.stack([rng.choice(vidx, 3, replace=False)
                        for _ in range(N_HYPOTHESES)])
    max_err1 = CHI2_SIM3 * sigma2_levels[octave1]
    max_err2 = CHI2_SIM3 * sigma2_levels[octave2]

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    R, t, s, inl, n = _ransac_sim3(
        dev(p1), dev(p2), dev(uv1), dev(uv2), dev(valid, torch.bool), dev(max_err1),
        dev(max_err2), dev(samples, torch.int64), dev(K), bool(fix_scale))
    n = int(n)
    if n < min_inliers:
        return None
    return Sim3Result(R=R.cpu().numpy(), t=t.cpu().numpy(), s=float(s),
                      inliers=inl.cpu().numpy(), n_inliers=n)
