"""Sim(3) similarity transforms for loop closing and the essential graph.

Counterpart of orb_slam2_detailed_comments_tpu/geometry/sim3.py, the
replacement of g2o::Sim3 (reference: Thirdparty/g2o/g2o/types/sim3.h). A
Sim3 S = (s, R, t) acts as x' = s R x + t and is stored as a (..., 4, 4)
matrix whose rotation block is s*R (the reference's cv::Mat encoding).
All functions broadcast over leading batch dimensions. The small-angle
and small-scale closed forms are both computed and selected with
torch.where; the branch not taken is kept finite (its divisors are
clamped or replaced), so theta = 0 and s = 1 give exact results.
"""
from __future__ import annotations

import torch

from .se3 import make_se3
from .so3 import exp_so3, hat, log_so3

_EPS = 1e-8


def make_sim3(R, t, s):
    """(..., 3, 3), (..., 3), (...,) -> (..., 4, 4) with top-left s*R."""
    return make_se3(s[..., None, None] * R, t)


def sim3_scale(S):
    """Recover scale as det(sR)^(1/3)."""
    d = torch.linalg.det(S[..., :3, :3])
    return torch.sign(d) * torch.abs(d) ** (1.0 / 3.0)


def sim3_rotation(S):
    return S[..., :3, :3] / sim3_scale(S)[..., None, None]


def sim3_translation(S):
    return S[..., :3, 3]


def sim3_inverse(S):
    s = sim3_scale(S)
    R = S[..., :3, :3] / s[..., None, None]
    t = S[..., :3, 3]
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    t_inv = -(s_inv[..., None] * (Rt @ t[..., None])[..., 0])
    return make_sim3(Rt, t_inv, s_inv)


def sim3_compose(A, B):
    return A @ B


def sim3_apply(S, p):
    """(..., 4, 4) x (..., N, 3) -> (..., N, 3): x' = s R x + t."""
    return p @ S[..., :3, :3].transpose(-1, -2) + S[..., :3, 3][..., None, :]


def sim3_to_se3(S):
    """Drop scale: [sR | t] -> [R | t/s], the reference's essential-graph
    SE3 recovery (reference: src/Optimizer.cc:1297-1311)."""
    s = sim3_scale(S)
    return make_se3(S[..., :3, :3] / s[..., None, None], S[..., :3, 3] / s[..., None])


def _V(phi, sigma):
    """V = a I + b W + c W^2 with W = hat(phi), the Sim(3) left Jacobian
    block that maps rho to t (Strasdat's thesis, appendix)."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS * _EPS))
    W = hat(phi)
    W2 = W @ W
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(W.shape)
    small_sigma = torch.abs(sigma) < 1e-5
    small_theta = theta_sq < 1e-8

    # sigma ~ 0: the SE(3) coefficients
    c0_A = torch.where(small_theta, 0.5 - theta_sq / 24.0,
                       (1.0 - torch.cos(theta)) / torch.clamp(theta_sq, min=_EPS))
    c0_B = torch.where(small_theta, 1.0 / 6.0 - theta_sq / 120.0,
                       (theta - torch.sin(theta)) / torch.clamp(theta_sq * theta, min=_EPS))
    V0 = eye + c0_A[..., None, None] * W + c0_B[..., None, None] * W2

    # general sigma (sigma replaced by 1 where small: that branch is not taken)
    sig = torch.where(small_sigma, torch.ones_like(sigma), sigma)
    es = torch.exp(sig)
    A_g = (es - 1.0) / sig
    a_gen = es * torch.sin(theta)
    b_gen = es * torch.cos(theta)
    denom = sig * sig + theta_sq
    B_g = torch.where(
        small_theta,
        ((sig - 1.0) * es + 1.0) / torch.clamp(sig * sig, min=_EPS),
        (a_gen * sig + (1.0 - b_gen) * theta) / torch.clamp(theta * denom, min=_EPS))
    C_g = torch.where(
        small_theta,
        ((0.5 * sig * sig - sig + 1.0) * es - 1.0) / torch.clamp(sig * sig * sig, min=_EPS),
        (A_g - ((b_gen - 1.0) * sig + a_gen * theta) / torch.clamp(denom, min=_EPS))
        / torch.clamp(theta_sq, min=_EPS))
    Vg = A_g[..., None, None] * eye + B_g[..., None, None] * W + C_g[..., None, None] * W2
    return torch.where(small_sigma[..., None, None], V0, Vg)


def exp_sim3(xi):
    """Sim(3) exponential. xi = (..., 7) = (rho, phi, sigma): translation
    part (3), rotation (3), log-scale (1)."""
    rho, phi, sigma = xi[..., 0:3], xi[..., 3:6], xi[..., 6]
    t = (_V(phi, sigma) @ rho[..., None])[..., 0]
    return make_sim3(exp_so3(phi), t, torch.exp(sigma))


def log_sim3(S):
    """Inverse of exp_sim3."""
    s = sim3_scale(S)
    R = S[..., :3, :3] / s[..., None, None]
    sigma = torch.log(s)
    phi = log_so3(R)
    # solve_ex: no singularity check, so no host sync (V is invertible)
    rho = torch.linalg.solve_ex(_V(phi, sigma), S[..., :3, 3][..., None]).result[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
