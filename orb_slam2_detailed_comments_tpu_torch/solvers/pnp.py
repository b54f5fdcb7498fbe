"""Batched RANSAC PnP for relocalization.

Counterpart of orb_slam2_detailed_comments_tpu/solvers/pnp.py, the
replacement of the reference's EPnP + RANSAC (reference: src/PnPsolver.cc).
All hypotheses are solved at once and scored against all correspondences
in one masked reduction. Two generators feed one scorer:

  * the 6-point DLT of the 3x4 projection matrix (a batched 12x12 SVD on
    `device`), decomposed into a rotation and a translation;
  * the minimal 3-point P3P (Grunert), host numpy: a quartic per sample
    solved as companion-matrix eigenvalues, then a batched Kabsch fit.
    It is a copy of the JAX package's.

The samples are drawn on the host with np.random.default_rng(seed) in the
JAX package's order, so both packages score the same hypotheses. The
scorer keeps the first of equal counts (torch.argmax, as jnp.argmax).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

N_HYPOTHESES = 300
MIN_SET = 6     # DLT path
P3P_SET = 3     # minimal path


class PnPResult(NamedTuple):
    Tcw: np.ndarray       # (4, 4)
    inliers: np.ndarray   # (M,) bool
    n_inliers: int


def _fit_projection_dlt(pts3d, uv):
    """Batched DLT: (B, 6, 3) + (B, 6, 2) -> (B, 3, 4) projection matrices,
    the right singular vector of the smallest singular value (its sign is
    arbitrary; _decompose_projection absorbs it)."""
    B, S, _ = pts3d.shape
    X = torch.cat([pts3d, torch.ones_like(pts3d[..., :1])], dim=-1)  # (B, 6, 4)
    zeros = torch.zeros_like(X)
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    r1 = torch.cat([X, zeros, -u * X], dim=-1)  # (B, 6, 12)
    r2 = torch.cat([zeros, X, -v * X], dim=-1)
    A = torch.cat([r1, r2], dim=1)  # (B, 12, 12)
    _, _, vt = torch.linalg.svd(A)
    return vt[..., 11, :].reshape(B, 3, 4)


def _decompose_projection(P, K_inv):
    """(B, 3, 4) -> (R (B,3,3), t (B,3)): the scale and sign from cbrt(det)
    of the normalized [R|t] (so P and -P give one pose), R orthonormalized
    via SVD with det +1."""
    M = K_inv @ P  # (B, 3, 4) normalized projection [R|t] up to scale
    R_raw = M[..., :3]
    t_raw = M[..., 3]
    det = torch.linalg.det(R_raw)
    sign = torch.sign(torch.where(torch.abs(det) < 1e-12, 1.0, det))
    scale = torch.abs(det) ** (1.0 / 3.0) * sign
    scale = torch.where(torch.abs(scale) < 1e-12, 1e-12, scale)
    R_n = R_raw / scale[..., None, None]
    t = t_raw / scale[..., None]
    u, _, vt = torch.linalg.svd(R_n)
    d = torch.linalg.det(u @ vt)
    u = torch.cat([u[..., :, :2], u[..., :, 2:] * torch.where(d < 0, -1.0, 1.0)[..., None, None]],
                  dim=-1)
    return u @ vt, t


# ---------------------------------------------------------------------------
# minimal 3-point path (Grunert P3P), host numpy
# ---------------------------------------------------------------------------

def _p3p_poses(pts3d_s: np.ndarray, uv_s: np.ndarray,
               K_inv: np.ndarray) -> tuple:
    """Grunert P3P for B samples of 3 correspondences.

    pts3d_s: (B, 3, 3) world points; uv_s: (B, 3, 2) pixels.
    Returns (R (B*4, 3, 3), t (B*4, 3), ok (B*4,)) — up to 4 poses per
    sample, invalid slots masked.

    Distance equations (s_i = depth of point i along its bearing ray f_i;
    p/q/r = 2 cos of the inter-ray angles; a/b/c = opposite side lengths):
        s2^2 + s3^2 - p s2 s3 = a^2
        s1^2 + s3^2 - q s1 s3 = b^2
        s1^2 + s2^2 - r s1 s2 = c^2
    With u = s2/s1, v = s3/s1 the last two become quadratics in u whose
    resultant in v is the classic quartic; its real roots back-substitute
    to depths, and the camera-frame points fit world->camera by Kabsch.
    """
    B = pts3d_s.shape[0]
    # unit bearing vectors
    ones = np.ones((B, 3, 1), np.float64)
    rays = np.concatenate([uv_s.astype(np.float64), ones], axis=-1) @ K_inv.T
    f = rays / np.linalg.norm(rays, axis=-1, keepdims=True)   # (B, 3, 3)
    P = pts3d_s.astype(np.float64)

    p = 2.0 * np.sum(f[:, 1] * f[:, 2], -1)     # angle between rays 2,3
    q = 2.0 * np.sum(f[:, 0] * f[:, 2], -1)     # rays 1,3
    r = 2.0 * np.sum(f[:, 0] * f[:, 1], -1)     # rays 1,2
    a2 = np.sum((P[:, 1] - P[:, 2]) ** 2, -1)   # |P2-P3|^2
    b2 = np.sum((P[:, 0] - P[:, 2]) ** 2, -1)   # |P1-P3|^2
    c2 = np.sum((P[:, 0] - P[:, 1]) ** 2, -1)   # |P1-P2|^2
    with np.errstate(all="ignore"):
        A = a2 / b2
        Bc = c2 / b2
    bad = ~np.isfinite(A) | ~np.isfinite(Bc) | (b2 <= 0)

    # quadratics in u (coefficients are polynomials in v):
    #   Q1: u^2 + a1(v) u + (b1_2 v^2 + b1_1 v + b1_0) = 0, a1 = -p v
    #   Q2: u^2 + a2c  u + (b2_2 v^2 + b2_1 v + b2_0) = 0, a2c = -r
    n2 = A - Bc - 1.0                   # N = beta2 - beta1 (deg 2)
    n1 = q * (Bc - A)
    n0 = 1.0 - Bc + A
    d1, d0 = -p, r                      # D = alpha1 - alpha2 (deg 1)
    e2, e1, e0 = -Bc, Bc * q, 1.0 - Bc  # beta2
    # resultant quartic: N^2 + a2c N D + beta2 D^2 = 0
    c4 = n2 * n2 + e2 * d1 * d1
    c3 = 2 * n2 * n1 + (-r) * (n2 * d1) + e2 * 2 * d1 * d0 + e1 * d1 * d1
    c2_ = (2 * n2 * n0 + n1 * n1 + (-r) * (n2 * d0 + n1 * d1)
           + e2 * d0 * d0 + e1 * 2 * d1 * d0 + e0 * d1 * d1)
    c1 = (2 * n1 * n0 + (-r) * (n1 * d0 + n0 * d1)
          + e1 * d0 * d0 + e0 * 2 * d1 * d0)
    c0 = n0 * n0 + (-r) * (n0 * d0) + e0 * d0 * d0

    # normalized companion matrices, batched eigvals. Samples with
    # non-finite coefficients (duplicate 3D points -> b2=0 ratios, etc.)
    # are folded into `bad` and given a benign placeholder polynomial.
    coeffs = np.stack([c4, c3, c2_, c1, c0])
    finite = np.all(np.isfinite(coeffs), axis=0)
    bad = bad | ~finite
    coeffs = np.where(finite[None], coeffs, 0.0)
    c4, c3, c2_, c1, c0 = coeffs
    scale = np.maximum(np.max(np.abs(coeffs), 0), 1e-30)
    c4n, c3n, c2n, c1n, c0n = (c / scale for c in (c4, c3, c2_, c1, c0))
    degenerate = np.abs(c4n) < 1e-12
    c4s = np.where(degenerate, 1.0, c4n)
    comp = np.zeros((B, 4, 4), np.float64)
    comp[:, 1, 0] = comp[:, 2, 1] = comp[:, 3, 2] = 1.0
    comp[:, 0, 3] = -c0n / c4s
    comp[:, 1, 3] = -c1n / c4s
    comp[:, 2, 3] = -c2n / c4s
    comp[:, 3, 3] = -c3n / c4s
    roots = np.linalg.eigvals(comp)                    # (B, 4) complex
    real = np.abs(roots.imag) < 1e-6 * (np.abs(roots.real) + 1.0)
    v = roots.real                                     # (B, 4)

    # back-substitution per root
    qe = q[:, None]
    N = n2[:, None] * v * v + n1[:, None] * v + n0[:, None]
    D = d1[:, None] * v + d0[:, None]
    with np.errstate(all="ignore"):
        u = N / D
        den = 1.0 + v * v - qe * v
        s1 = np.sqrt(b2[:, None] / den)
    s2 = u * s1
    s3 = v * s1
    ok = (real & np.isfinite(u) & (den > 1e-12) & np.isfinite(s1)
          & (s1 > 0) & (s2 > 0) & (s3 > 0)
          & ~bad[:, None] & ~degenerate[:, None] & (np.abs(D) > 1e-12))

    # camera-frame points, batched Kabsch world->camera
    s = np.stack([s1, s2, s3], axis=-1)                # (B, 4, 3)
    Xc = s[..., None] * f[:, None, :, :]               # (B, 4, 3pts, 3)
    Pw = np.broadcast_to(P[:, None], Xc.shape)
    cw = Pw.mean(axis=2, keepdims=True)
    cc = Xc.mean(axis=2, keepdims=True)
    H = np.einsum("brpi,brpj->brij", Pw - cw, Xc - cc)
    H = np.where(np.isfinite(H), H, 0.0)
    U, _, Vt = np.linalg.svd(H)
    det = np.linalg.det(np.einsum("brij,brjk->brik",
                                  np.swapaxes(Vt, -1, -2),
                                  np.swapaxes(U, -1, -2)))
    S = np.zeros_like(U)
    S[..., 0, 0] = 1.0
    S[..., 1, 1] = 1.0
    S[..., 2, 2] = det
    R = np.einsum("brij,brjk,brkl->bril", np.swapaxes(Vt, -1, -2), S,
                  np.swapaxes(U, -1, -2))
    t = cc[:, :, 0, :] - np.einsum("brij,brj->bri", R, cw[:, :, 0, :])
    return (R.reshape(-1, 3, 3).astype(np.float32),
            t.reshape(-1, 3).astype(np.float32), ok.reshape(-1))


# ---------------------------------------------------------------------------
# shared pose scorer
# ---------------------------------------------------------------------------

def _score_poses(Rs, ts, hyp_ok, pts3d, uv, valid, octave, K, inv_sigma2_levels):
    """Score all candidate poses: per-octave chi2 < 5.991 (reference:
    PnPsolver sets mvMaxError = 5.991 * sigma2(octave), Tracking.cc:2317).
    Returns (best R, best t, inlier mask, count); the first best on ties."""
    pc = torch.einsum("bij,mj->bmi", Rs, pts3d) + ts[:, None, :]
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u_p = K[0, 0] * pc[..., 0] / zs + K[0, 2]
    v_p = K[1, 1] * pc[..., 1] / zs + K[1, 2]
    err = (u_p - uv[None, :, 0]) ** 2 + (v_p - uv[None, :, 1]) ** 2
    chi2 = err * inv_sigma2_levels[octave.long()][None, :]
    inl = (chi2 < 5.991) & (z > 0) & valid[None, :] & hyp_ok[:, None]
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts)
    return Rs[best], ts[best], inl[best], counts[best]


def solve_pnp_ransac(pts3d: np.ndarray, uv: np.ndarray, valid: np.ndarray,
                     octave: np.ndarray, K: np.ndarray,
                     inv_sigma2_levels: np.ndarray,
                     min_inliers: int = 10, seed: int = 0,
                     device="cuda") -> Optional[PnPResult]:
    """RANSAC PnP over the valid 2D-3D correspondences (host numpy in and
    out; the DLT and the scorer run on `device`).

    Hypothesis pool = N_HYPOTHESES 6-point DLT poses (when there are at
    least MIN_SET correspondences) + up to 4*N_HYPOTHESES minimal P3P
    poses, jointly scored.
    Returns None if no hypothesis reaches min_inliers (reference:
    PnPsolver::iterate returns no-pose, Tracking.cc:2352-2366).
    """
    vidx = np.nonzero(valid)[0]
    if vidx.size < P3P_SET:
        return None
    rng = np.random.default_rng(seed)
    K = np.asarray(K, np.float32)
    K_inv = np.linalg.inv(K)

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    Rs, ts, oks = [], [], []
    if vidx.size >= MIN_SET:
        samples = np.stack([rng.choice(vidx, MIN_SET, replace=False)
                            for _ in range(N_HYPOTHESES)])
        P = _fit_projection_dlt(dev(pts3d[samples]), dev(uv[samples]))
        R_d, t_d = _decompose_projection(P, dev(K_inv))
        Rs.append(R_d.cpu().numpy())
        ts.append(t_d.cpu().numpy())
        oks.append(np.ones(len(R_d), bool))
    samples = np.stack([rng.choice(vidx, P3P_SET, replace=False)
                        for _ in range(N_HYPOTHESES)])
    R_p, t_p, ok_p = _p3p_poses(pts3d[samples], uv[samples], K_inv.astype(np.float64))
    Rs.append(R_p)
    ts.append(t_p)
    oks.append(ok_p)
    R_all = np.concatenate(Rs)
    t_all = np.concatenate(ts)
    ok_all = np.concatenate(oks)
    R_all = np.where(np.isfinite(R_all), R_all, 0.0)
    t_all = np.where(np.isfinite(t_all), t_all, 0.0)
    R, t, inl, n = _score_poses(
        dev(R_all), dev(t_all), dev(ok_all, torch.bool), dev(pts3d), dev(uv),
        dev(valid, torch.bool), dev(octave, torch.int32), dev(K),
        dev(inv_sigma2_levels))
    n = int(n)
    if n < min_inliers:
        return None
    Tcw = np.eye(4, dtype=np.float32)
    Tcw[:3, :3] = R.cpu().numpy()
    Tcw[:3, 3] = t.cpu().numpy()
    return PnPResult(Tcw=Tcw, inliers=inl.cpu().numpy(), n_inliers=n)
