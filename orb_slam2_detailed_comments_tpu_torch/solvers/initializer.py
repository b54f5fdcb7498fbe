"""Monocular two-view initialization: batched H/F RANSAC + reconstruction.

Counterpart of orb_slam2_detailed_comments_tpu/solvers/initializer.py (the
replacement of the reference Initializer, src/Initializer.cc): all 2 x 200
hypotheses are fitted as one batched small SVD and scored as a
(hypotheses x matches) matrix of symmetric transfer errors; the model
choice keeps the reference's rule RH = SH/(SH+SF) > 0.40 -> homography
(Initializer.cc:220-239). The winning model is decomposed on the host
(numpy, as in the JAX package) and its hypotheses ranked by a batched
cheirality/parallax/reprojection check (CheckRT, :1755-1870).

The RANSAC samples come from np.random.default_rng(seed), so both packages
draw the same ones. A null vector from an SVD or an eigendecomposition has
an arbitrary sign, which may differ between jnp and torch; every use of one
here is sign-free as in the JAX package: the scores are invariant to the
sign of H and F, the rank-2 projection keeps it, the homography hypotheses
form a set closed under t -> -t, the essential decomposition fixes the
signs of U and V by their determinants and lists both t and -t, and the
triangulated point divides by w.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..geometry.triangulate import triangulate_dlt

N_RANSAC = 200        # reference: Initializer constructor mMaxIterations=200
SIGMA = 1.0
CHI2_H = 5.991        # reference: CheckHomography th
CHI2_F_LINE = 3.841   # reference: CheckFundamental thScore per direction
CHI2_F_SCORE = 5.991
MIN_PARALLAX_DEG = 1.0
MIN_TRIANGULATED = 50


class TwoViewResult(NamedTuple):
    success: bool
    R: np.ndarray            # (3, 3) rotation cam1->cam2
    t: np.ndarray            # (3,) unit-norm translation
    points3d: np.ndarray     # (M, 3) triangulated points in cam1 frame
    is_triangulated: np.ndarray  # (M,) bool
    used_homography: bool


def _inv(A):
    """Batched inverse without the host check for singular matrices (a
    singular input gives inf/nan, as jnp.linalg.inv does)."""
    return torch.linalg.inv_ex(A)[0]


def _normalize(uv, valid):
    """Hartley normalization over the valid matches
    (reference: Initializer::Normalize, :1485-1526)."""
    w = valid.to(torch.float32)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(uv * w[:, None], dim=0) / n
    d = torch.abs(uv - mean) * w[:, None]
    mean_dev = torch.sum(d, dim=0) / n
    s = 1.0 / torch.clamp(mean_dev, min=1e-9)
    uvn = (uv - mean) * s
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], zero, -mean[0] * s[0]]),
                     torch.stack([zero, s[1], -mean[1] * s[1]]),
                     torch.stack([zero, zero, one])])
    return uvn, T


def _homography_rows(x1, y1, x2, y2):
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    return r1, r2


def _fundamental_rows(x1, y1, x2, y2):
    o = torch.ones_like(x1)
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], dim=-1)


def _rank2(F):
    u, s, vt = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return u @ (s[..., :, None] * vt)


def _fit_homographies(p1, p2):
    """Batched DLT: p1, p2 (B, 8, 2) -> H21 (B, 3, 3) with p2 ~ H p1."""
    B = p1.shape[0]
    r1, r2 = _homography_rows(p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1])
    A = torch.cat([r1, r2], dim=1)  # (B, 16, 9)
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    return vt[..., 8, :].reshape(B, 3, 3)


def _fit_fundamentals(p1, p2):
    """Batched 8-point algorithm with rank-2 projection."""
    A = _fundamental_rows(p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1])  # (B, 8, 9)
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    return _rank2(vt[..., 8, :].reshape(-1, 3, 3))


def _score_homographies(H21, uv1, uv2, valid):
    """Symmetric transfer error score (reference: CheckHomography,
    :1165-1300): per match, sum of truncated (th - chi2) in both directions,
    zero if either direction exceeds th."""
    H12 = _inv(H21)
    inv_s2 = 1.0 / (SIGMA * SIGMA)

    def transfer(H, a, b):
        # H: (B, 3, 3); a, b: (M, 2) -> (B, M) chi2
        ah = torch.cat([a, torch.ones_like(a[..., :1])], dim=-1)
        p = torch.einsum("bij,mj->bmi", H, ah)
        w = torch.where(torch.abs(p[..., 2]) < 1e-9, 1e-9, p[..., 2])
        proj = p[..., :2] / w[..., None]
        return torch.sum((proj - b[None]) ** 2, dim=-1) * inv_s2

    c1 = transfer(H12, uv2, uv1)  # (B, M) err in image 1
    c2 = transfer(H21, uv1, uv2)  # (B, M) err in image 2
    ok = (c1 < CHI2_H) & (c2 < CHI2_H) & valid[None]
    score = torch.sum(torch.where(ok, (CHI2_H - c1) + (CHI2_H - c2), 0.0), dim=-1)
    return score, ok


def _score_fundamentals(F21, uv1, uv2, valid):
    """Epipolar line distance score (reference: CheckFundamental, :1305-1454)."""
    inv_s2 = 1.0 / (SIGMA * SIGMA)

    def line_err(F, a, b):
        # F: (B, 3, 3); line in b's image: l = F a
        ah = torch.cat([a, torch.ones_like(a[..., :1])], dim=-1)
        line = torch.einsum("bij,mj->bmi", F, ah)  # (B, M, 3)
        num = torch.sum(line[..., :2] * b[None], dim=-1) + line[..., 2]
        den = torch.sum(line[..., :2] ** 2, dim=-1)
        return num * num / torch.clamp(den, min=1e-12) * inv_s2

    c2 = line_err(F21, uv1, uv2)
    c1 = line_err(F21.transpose(-1, -2), uv2, uv1)
    ok = (c1 < CHI2_F_LINE) & (c2 < CHI2_F_LINE) & valid[None]
    score = torch.sum(torch.where(ok, (CHI2_F_SCORE - c1) + (CHI2_F_SCORE - c2), 0.0), dim=-1)
    return score, ok


def _refit_homography(n1, n2, w):
    """Weighted DLT over ALL matches (w = inlier mask). Zeroed rows do not
    contribute to the nullspace problem."""
    r1, r2 = _homography_rows(n1[:, 0], n1[:, 1], n2[:, 0], n2[:, 1])
    A = torch.cat([r1 * w[:, None], r2 * w[:, None]], dim=0)
    _, _, vt = torch.linalg.svd(A, full_matrices=False)
    return vt[8, :].reshape(3, 3)


def _refit_fundamental(n1, n2, w):
    A = _fundamental_rows(n1[:, 0], n1[:, 1], n2[:, 0], n2[:, 1]) * w[:, None]
    _, _, vt = torch.linalg.svd(A, full_matrices=False)
    return _rank2(vt[8, :].reshape(3, 3))


def _ransac_models(uv1, uv2, valid, sample_idx):
    """Fit + score all H and F hypotheses, then refit the winner on its
    inlier set (two rounds). Returns ((H21, SH, h_inliers), (F21, SF,
    f_inliers)). argmax takes the first index on ties, as jnp.argmax does."""
    n1, T1 = _normalize(uv1, valid)
    n2, T2 = _normalize(uv2, valid)
    p1 = n1[sample_idx]  # (B, 8, 2)
    p2 = n2[sample_idx]
    T2it = _inv(T2)

    Hn = _fit_homographies(p1, p2)
    H21 = T2it @ Hn @ T1  # denormalize (reference :259)
    sh, h_ok = _score_homographies(H21, uv1, uv2, valid)
    bh = torch.argmax(sh)
    best_H, best_h_ok = H21[bh], h_ok[bh]
    for _ in range(2):
        Hr = T2it @ _refit_homography(n1, n2, best_h_ok.to(n1.dtype)) @ T1
        sh_r, h_ok_r = _score_homographies(Hr[None], uv1, uv2, valid)
        better = sh_r[0] > sh[bh]
        best_H = torch.where(better, Hr, best_H)
        best_h_ok = torch.where(better, h_ok_r[0], best_h_ok)
    sh_best = _score_homographies(best_H[None], uv1, uv2, valid)[0][0]

    Fn = _fit_fundamentals(p1, p2)
    F21 = T2.transpose(-1, -2) @ Fn @ T1
    sf, f_ok = _score_fundamentals(F21, uv1, uv2, valid)
    bf = torch.argmax(sf)
    best_F, best_f_ok = F21[bf], f_ok[bf]
    for _ in range(2):
        Fr = T2.transpose(-1, -2) @ _refit_fundamental(n1, n2, best_f_ok.to(n1.dtype)) @ T1
        sf_r, f_ok_r = _score_fundamentals(Fr[None], uv1, uv2, valid)
        better = sf_r[0] > _score_fundamentals(best_F[None], uv1, uv2, valid)[0][0]
        best_F = torch.where(better, Fr, best_F)
        best_f_ok = torch.where(better, f_ok_r[0], best_f_ok)
    sf_best = _score_fundamentals(best_F[None], uv1, uv2, valid)[0][0]

    return (best_H, sh_best, best_h_ok), (best_F, sf_best, best_f_ok)


def _check_rt_batch(Rs, ts, uv1, uv2, valid, K, chi2_th):
    """Batched CheckRT (reference: Initializer.cc:1755-1870): triangulate
    matches under each (R, t), count points with positive depth in both
    views, parallax, and bounded reprojection error.

    Rs: (Q, 3, 3), ts: (Q, 3). Returns (ngood (Q,), parallax_deg (Q,),
    pts3d (Q, M, 3), good (Q, M))."""
    Q = Rs.shape[0]
    M = uv1.shape[0]
    eye34 = torch.cat([torch.eye(3, device=K.device), torch.zeros((3, 1), device=K.device)], dim=1)
    P1 = K @ eye34  # (3, 4)
    Rt = torch.cat([Rs, ts[:, :, None]], dim=-1)  # (Q, 3, 4)
    P2 = K[None] @ Rt

    uv1b = uv1[None].expand(Q, M, 2)
    uv2b = uv2[None].expand(Q, M, 2)
    pts = triangulate_dlt(P1[None, None], P2[:, None], uv1b, uv2b)  # (Q, M, 3)

    finite = torch.all(torch.isfinite(pts), dim=-1)
    z1 = pts[..., 2]
    pc2 = torch.einsum("qij,qmj->qmi", Rs, pts) + ts[:, None, :]
    z2 = pc2[..., 2]

    # parallax between the two rays
    O2 = -torch.einsum("qij,qi->qj", Rs, ts)  # camera-2 center in cam1 frame
    r1 = pts
    r2 = pts - O2[:, None, :]
    cosp = torch.sum(r1 * r2, dim=-1) / torch.clamp(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1), min=1e-9)

    def reproj_err(P, pts_h, uv):
        ph = torch.cat([pts_h, torch.ones_like(pts_h[..., :1])], dim=-1)
        pr = torch.einsum("qij,qmj->qmi", P, ph)
        w = torch.where(torch.abs(pr[..., 2]) < 1e-9, 1e-9, pr[..., 2])
        return torch.sum((pr[..., :2] / w[..., None] - uv) ** 2, dim=-1)

    e1 = reproj_err(P1[None].expand(Q, 3, 4), pts, uv1b)
    e2 = reproj_err(P2, pts, uv2b)

    good = (
        valid[None]
        & finite
        & (z1 > 0) & (z2 > 0)
        & (cosp < 0.99998)          # parallax > ~0.36 deg (reference :1811)
        & (e1 < chi2_th) & (e2 < chi2_th)
    )
    ngood = torch.sum(good, dim=-1)
    # parallax statistic: the reference takes the 50th smallest angle
    # (:1855-1860); the JAX package takes the 50th best of the good ones
    cosp_good = torch.where(good, cosp, 1.0)
    sorted_cos = torch.sort(cosp_good, dim=-1).values
    idx = torch.clamp(torch.clamp(ngood - 1, min=0), max=49)
    cos50 = torch.gather(sorted_cos, -1, idx[:, None])[:, 0]
    parallax_deg = torch.rad2deg(torch.arccos(torch.clamp(cos50, -1.0, 1.0)))
    return ngood, parallax_deg, pts, good


def _decompose_homography(H21, K):
    """Faugeras SVD decomposition into 8 motion hypotheses
    (reference: ReconstructH, Initializer.cc:1534-1743)."""
    A = np.linalg.inv(K) @ H21 @ K
    U, w, Vt = np.linalg.svd(A)
    V = Vt.T
    s = np.linalg.det(U) * np.linalg.det(V)
    d1, d2, d3 = w
    if d1 / d2 < 1.00001 or d2 / d3 < 1.00001:
        return []

    aux1 = np.sqrt(max((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3), 0.0))
    aux3 = np.sqrt(max((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3), 0.0))
    x1s = [aux1, aux1, -aux1, -aux1]
    x3s = [aux3, -aux3, aux3, -aux3]

    out = []
    # case d' = d2
    aux_st = np.sqrt(max((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / ((d1 + d3) * d2)
    ct = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2)
    st_ = [aux_st, -aux_st, -aux_st, aux_st]
    for i in range(4):
        Rp = np.array([[ct, 0, -st_[i]], [0, 1, 0], [st_[i], 0, ct]])
        R = s * U @ Rp @ Vt
        tp = np.array([x1s[i], 0.0, -x3s[i]]) * (d1 - d3)
        t = U @ tp
        nt = np.linalg.norm(t)
        out.append((R, t / (nt if nt > 0 else 1.0)))
    # case d' = -d2
    aux_sp = np.sqrt(max((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / ((d1 - d3) * d2)
    cp = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2)
    sp_ = [aux_sp, -aux_sp, -aux_sp, aux_sp]
    for i in range(4):
        Rp = np.array([[cp, 0, sp_[i]], [0, -1, 0], [sp_[i], 0, -cp]])
        R = s * U @ Rp @ Vt
        tp = np.array([x1s[i], 0.0, x3s[i]]) * (d1 + d3)
        t = U @ tp
        nt = np.linalg.norm(t)
        out.append((R, t / (nt if nt > 0 else 1.0)))
    return out


def _decompose_essential(F21, K):
    """E = K^T F K -> 4 hypotheses (reference: DecomposeE, :1878-1920 and
    ReconstructF's 4-way check)."""
    E = K.T @ F21 @ K
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / np.linalg.norm(t)
    return [(R1, t), (R1, -t), (R2, t), (R2, -t)]


def initialize_two_view(uv1, uv2, valid, K, seed: int = 0,
                        device="cuda") -> Optional[TwoViewResult]:
    """Full two-view bootstrap following Initializer::Initialize
    (reference: Initializer.cc:123-250).

    uv1/uv2: (M, 2) float32 matched undistorted keypoints; valid: (M,) bool;
    K: (3, 3) intrinsics; all numpy. The 50th-best parallax must reach
    MIN_PARALLAX_DEG and at least MIN_TRIANGULATED points must triangulate.
    The batched work runs on `device`. Returns None on failure — the caller
    keeps its reference frame, so the next attempt pairs a longer baseline
    (Tracking.cc:918-971).
    """
    valid_np = np.asarray(valid, bool)
    if int(valid_np.sum()) < 8:
        return None

    rng = np.random.default_rng(seed)
    vidx = np.nonzero(valid_np)[0]
    samples = np.stack([rng.choice(vidx, 8, replace=False) for _ in range(N_RANSAC)])

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    uv1_t, uv2_t, valid_t = dev(uv1), dev(uv2), dev(valid_np, torch.bool)
    (H21, SH, h_in), (F21, SF, f_in) = _ransac_models(
        uv1_t, uv2_t, valid_t, dev(samples, torch.int64))
    SH, SF = float(SH), float(SF)
    if SH + SF <= 0:
        return None
    RH = SH / (SH + SF)

    K_np = np.asarray(K, np.float64)
    chi2_th = 4.0 * SIGMA * SIGMA  # reference: CheckRT th2 = 4*sigma^2
    min_good_frac = 0.9
    if RH > 0.40:
        hyps = _decompose_homography(H21.cpu().numpy().astype(np.float64), K_np)
        inl, used_h = h_in, True
    else:
        hyps = _decompose_essential(F21.cpu().numpy().astype(np.float64), K_np)
        inl, used_h = f_in, False
    if not hyps:
        return None

    Rs = np.stack([h[0] for h in hyps]).astype(np.float32)
    ts = np.stack([h[1] for h in hyps]).astype(np.float32)
    ngood, parallax, pts, good = _check_rt_batch(
        dev(Rs), dev(ts), uv1_t, uv2_t, inl, dev(K_np), chi2_th)
    ngood = ngood.cpu().numpy()
    parallax = parallax.cpu().numpy()

    n_inl = int(inl.sum())
    best = int(np.argmax(ngood))
    max_good = int(ngood[best])
    n_similar = int(np.sum(ngood > 0.7 * max_good))

    # acceptance (reference: ReconstructF :1085-1128 / ReconstructH
    # :1726-1739): clear winner, enough points (>= 0.9 N on both paths),
    # enough parallax
    if max_good < max(MIN_TRIANGULATED, int(min_good_frac * n_inl)):
        return None
    if n_similar > 1 and not used_h:
        return None
    if parallax[best] < MIN_PARALLAX_DEG:
        return None

    return TwoViewResult(
        success=True,
        R=Rs[best],
        t=ts[best],
        points3d=pts[best].cpu().numpy().astype(np.float32),
        is_triangulated=good[best].cpu().numpy(),
        used_homography=used_h,
    )
