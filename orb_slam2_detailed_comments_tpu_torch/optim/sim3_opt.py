"""Sim3 refinement between two keyframes (the loop-closure transform polish).

Counterpart of orb_slam2_detailed_comments_tpu/optim/sim3_opt.py, the
replacement of Optimizer::OptimizeSim3 (reference:
src/Optimizer.cc:1383-1617): one Sim3 vertex with paired forward (points
of KF2 projected into KF1) and inverse (points of KF1 into KF2)
reprojection edges, Huber kernel, mid-schedule chi2 pruning (th2 = 10),
acceptance at >= 20 inliers (the caller's). IRLS Gauss-Newton with
forward-mode Jacobians on the 7-dim tangent: one JVP per direction,
batched over the directions with torch.func.vmap. The tangent is kept as
a (1, 7) row so no 0-dim tensor meets a Python float inside the JVP (that
gives float64 tangents). The iteration counts are fixed and the 7x7 solve
is solve_ex, so a call makes no host sync.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jvp, vmap

from ..geometry.sim3 import exp_sim3, sim3_inverse

CHI2_SIM3_OPT = 10.0  # reference: th2=10 (LoopClosing.cc:552)
DELTA = CHI2_SIM3_OPT ** 0.5


def _project(K, p):
    z = torch.where(torch.abs(p[..., 2]) < 1e-9, 1e-9, p[..., 2])
    return torch.stack([K[0, 0] * p[..., 0] / z + K[0, 2],
                        K[1, 1] * p[..., 1] / z + K[1, 2]], dim=-1)


class Sim3OptResult(NamedTuple):
    S12: torch.Tensor       # (4, 4) optimized Sim3 (cam2 -> cam1 convention)
    inliers: torch.Tensor   # (M,) bool
    n_inliers: torch.Tensor


def optimize_sim3(S12_0, p1, p2, uv1, uv2, valid, inv_sigma2_1, inv_sigma2_2,
                  K, fix_scale: bool = False, n_iters: int = 10,
                  damping: float = 1e-6, device="cuda") -> Sim3OptResult:
    """Optimize S12 mapping cam2-frame points into cam1, on `device`.

    p1/p2: (M, 3) matched points in each camera frame; uv1/uv2: (M, 2)
    observed pixels; inv_sigma2_*: per-match information weights. Arrays
    or tensors; they are moved to `device`.
    """
    def f32(a):
        if isinstance(a, torch.Tensor):
            return a.to(device, torch.float32)
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    S12_0, p1, p2, uv1, uv2, inv_sigma2_1, inv_sigma2_2, K = (
        f32(a) for a in (S12_0, p1, p2, uv1, uv2, inv_sigma2_1, inv_sigma2_2, K))
    valid = f32(valid) > 0
    eye7 = torch.eye(7, device=device)
    xi0 = torch.zeros((1, 7), device=device)
    basis = eye7[:, None, :]

    def residuals(xi, S_base):
        S12 = exp_sim3(xi) @ S_base                               # (1, 4, 4)
        S21 = sim3_inverse(S12)[0]
        S12 = S12[0]
        r1 = _project(K, p2 @ S12[:3, :3].T + S12[:3, 3]) - uv1   # forward, image 1
        r2 = _project(K, p1 @ S21[:3, :3].T + S21[:3, 3]) - uv2   # inverse, image 2
        return torch.cat([r1, r2], dim=-1)                        # (M, 4)

    def jacobian(S):
        cols = vmap(lambda v: jvp(lambda x: residuals(x, S), (xi0,), (v,))[1])(basis)
        return cols.permute(1, 2, 0)                              # (M, 4, 7)

    def chi2_of(r):
        c1 = torch.sum(r[:, :2] ** 2, dim=-1) * inv_sigma2_1
        c2 = torch.sum(r[:, 2:] ** 2, dim=-1) * inv_sigma2_2
        return c1, c2

    def gn_round(S, active, n):
        for _ in range(n):
            r = residuals(xi0, S)
            J = jacobian(S)
            if fix_scale:
                J = torch.cat([J[..., :6], torch.zeros_like(J[..., 6:])], dim=-1)
            c1, c2 = chi2_of(r)
            w1 = torch.clamp(DELTA / torch.sqrt(torch.clamp(c1, min=1e-12)), max=1.0) * inv_sigma2_1
            w2 = torch.clamp(DELTA / torch.sqrt(torch.clamp(c2, min=1e-12)), max=1.0) * inv_sigma2_2
            w = torch.stack([w1, w1, w2, w2], dim=-1) * active[:, None]
            H = torch.einsum("mri,mr,mrj->ij", J, w, J)
            b = torch.einsum("mri,mr,mr->i", J, w, r)
            H = H + damping * eye7 * (1.0 + torch.trace(H) / 7.0)
            if fix_scale:
                H = H + torch.diag(torch.eye(7, device=device)[6])
            dx = -torch.linalg.solve_ex(H, b).result
            S = exp_sim3(dx[None])[0] @ S
        return S

    # phase 1: 5 iterations, then prune chi2 > 10 (reference :1539-1573)
    S12 = gn_round(S12_0, valid.float(), 5)
    c1, c2 = chi2_of(residuals(xi0, S12))
    active = valid & (c1 <= CHI2_SIM3_OPT) & (c2 <= CHI2_SIM3_OPT)
    # phase 2
    S12 = gn_round(S12, active.float(), n_iters)
    c1, c2 = chi2_of(residuals(xi0, S12))
    inl = valid & (c1 <= CHI2_SIM3_OPT) & (c2 <= CHI2_SIM3_OPT)
    return Sim3OptResult(S12=S12, inliers=inl, n_inliers=torch.sum(inl))
