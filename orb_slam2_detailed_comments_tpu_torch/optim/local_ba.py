"""Bundle adjustment with Schur-complement camera reduction, batched.

Counterpart of orb_slam2_detailed_comments_tpu/optim/local_ba.py, the
replacement of Optimizer::LocalBundleAdjustment (reference:
src/Optimizer.cc:631-1030), which builds a g2o sparse graph with
marginalized point vertices. The problem is a fixed-capacity edge list:

  cameras  (C, 4, 4)  world->cam poses, free or fixed per camera
  points   (P, 3)     map point positions (all free; invalid masked)
  edges    (E,)       (cam, point, obs(u,v,ur), octave, valid)

The solve keeps the JAX package's k-major (K, P) edge layout: edges are
grouped point-major into K slots per point once per call (a stable
argsort and searchsorted), every per-point reduction is a sum over K,
camera blocks are one-hot GEMMs against a (C, K*P) one-hot, the
camera-point coupling is a batched (C, K) @ (K, 6) product per point, and
the Schur fill is three (6C, P) @ (P, 6C) GEMMs. The reduced system is
solved by a Cholesky factor and two triangular solves.

Every sum runs in a fixed order (no scatter-add, no atomics), so two
solves of one problem give the same bits, and nothing reads a value back
to the host: the LM step acceptance is a torch.where and the iteration
counts are fixed (5 robust + 10 plain, the reference's schedule,
Optimizer.cc:893-935), so a solve makes no host sync.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.se3 import exp_se3, se3_renormalize
from .robust import CHI2_MONO, CHI2_STEREO, DELTA_MONO, DELTA_STEREO, huber_weight


class BAProblem(NamedTuple):
    """Static-capacity BA problem. Pad all arrays to fixed sizes."""
    cam_Tcw: torch.Tensor      # (C, 4, 4)
    cam_free: torch.Tensor     # (C,) bool — False = fixed vertex
    cam_valid: torch.Tensor    # (C,) bool
    points: torch.Tensor       # (P, 3)
    point_valid: torch.Tensor  # (P,) bool
    edge_cam: torch.Tensor     # (E,) int32
    edge_point: torch.Tensor   # (E,) int32
    edge_obs: torch.Tensor     # (E, 3) (u, v, ur); ur<0 => monocular
    edge_octave: torch.Tensor  # (E,) int32
    edge_valid: torch.Tensor   # (E,) bool


def _edge_terms(cam_Tcw, points, prob: BAProblem, cam_params):
    """Residuals r (E,3), J_cam (E,3,6), J_pt (E,3,3), behind-camera mask."""
    fx, fy, cx, cy, bf = cam_params
    T = cam_Tcw[prob.edge_cam.long()]         # (E, 4, 4)
    X = points[prob.edge_point.long()]        # (E, 3)
    R = T[:, :3, :3]
    t = T[:, :3, 3]
    pc = torch.einsum("eij,ej->ei", R, X) + t
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    zs = torch.clamp(z, min=1e-6)
    iz = 1.0 / zs
    iz2 = iz * iz

    u = fx * x * iz + cx
    v = fy * y * iz + cy
    ur = u - bf * iz
    r = prob.edge_obs - torch.stack([u, v, ur], dim=-1)

    zero = torch.zeros_like(x)
    du = torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1)
    dv = torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1)
    dur = torch.stack([fx * iz, zero, -fx * x * iz2 + bf * iz2], dim=-1)
    dpred_dpc = torch.stack([du, dv, dur], dim=-2)  # (E, 3, 3)

    neg_hat = torch.stack([
        torch.stack([zero, z, -y], dim=-1),
        torch.stack([-z, zero, x], dim=-1),
        torch.stack([y, -x, zero], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    dpc_dxi = torch.cat([eye, neg_hat], dim=-1)       # (E, 3, 6)

    J_cam = -(dpred_dpc @ dpc_dxi)                    # (E, 3, 6)
    J_pt = -(dpred_dpc @ R)                           # (E, 3, 3)  d pc/dX = R
    return r, J_cam, J_pt, z <= 0.0


def _inv3x3(M):
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), (b * f - c * e)], dim=-1),
        torch.stack([B, (a * i - c * g), -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), (a * e - b * d)], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def _stereo_row_mask(prob: BAProblem):
    is_stereo = prob.edge_obs[:, 2] >= 0.0
    one = torch.ones_like(is_stereo, dtype=torch.float32)
    return is_stereo, torch.stack([one, one, is_stereo.float()], dim=-1)


def edge_chi2(cam_Tcw, points, prob: BAProblem, cam_params, inv_sigma2_levels):
    r, _, _, behind = _edge_terms(cam_Tcw, points, prob, cam_params)
    _, row_mask = _stereo_row_mask(prob)
    rw = r * row_mask
    chi2 = torch.sum(rw * rw, dim=-1) * inv_sigma2_levels[prob.edge_octave.long()]
    return chi2, behind


# ---------------------------------------------------------------------------
# The k-major layout (the JAX package's production path): per-edge
# quantities are lists of (K, P) columns, small-matrix algebra is unrolled
# over the columns.
# ---------------------------------------------------------------------------


def _group_edges(edge_point, edge_valid, P: int, K: int):
    """Sort edges point-major and map (point, slot<K) -> flat edge index.

    Returns (sel (P*K,) indices into the edge list, gvalid (P*K,) bool).
    Invalid edges sort to the tail; points with more than K observations
    keep their first K (the reference has no such cap; with K=8 the cap
    only sheds redundant observations of heavily-observed points)."""
    E = edge_point.shape[0]
    dev = edge_point.device
    key = torch.where(edge_valid, edge_point.long(), P)
    order = torch.argsort(key, stable=True)
    sp = key[order]
    pr = torch.arange(P, device=dev)
    start = torch.searchsorted(sp, pr, side="left")
    deg = torch.searchsorted(sp, pr, side="right") - start
    k = torch.arange(K, device=dev)
    gidx = torch.clamp(start[:, None] + k[None, :], max=E - 1)
    gvalid = k[None, :] < torch.clamp(deg, max=K)[:, None]
    return order[gidx.reshape(-1)], gvalid.reshape(-1)


def _edge_cols(T, X, obs, cam_params):
    """Per-edge residual + Jacobian columns.

    T: list of 16 tensors (flattened 4x4 world->cam per edge), X: list of 3
    (point coords per edge), obs: list of 3 (u, v, ur), all of one shape.
    Same math as the reference's analytic Jacobians (g2o
    EdgeSE3ProjectXYZ / EdgeStereoSE3ProjectXYZ, reference:
    Thirdparty/g2o/g2o/types/types_six_dof_expmap.h:59-208)."""
    fx, fy, cx, cy, bf = cam_params
    Xx, Xy, Xz = X
    px = T[0] * Xx + T[1] * Xy + T[2] * Xz + T[3]
    py = T[4] * Xx + T[5] * Xy + T[6] * Xz + T[7]
    pz = T[8] * Xx + T[9] * Xy + T[10] * Xz + T[11]
    zs = torch.clamp(pz, min=1e-6)
    iz = 1.0 / zs
    iz2 = iz * iz

    u = fx * px * iz + cx
    v = fy * py * iz + cy
    ur = u - bf * iz
    r = [obs[0] - u, obs[1] - v, obs[2] - ur]

    zero = torch.zeros_like(px)
    # dpred/dpc rows (3x3)
    D = [
        [fx * iz, zero, -fx * px * iz2],
        [zero, fy * iz, -fy * py * iz2],
        [fx * iz, zero, -fx * px * iz2 + bf * iz2],
    ]
    # dpc/dxi = [I | -skew(pc)]; right-block columns
    Gr = [
        [zero, pz, -py],
        [-pz, zero, px],
        [py, -px, zero],
    ]
    Jc = [
        [-D[rr][0], -D[rr][1], -D[rr][2]]
        + [-(D[rr][0] * Gr[0][j] + D[rr][1] * Gr[1][j] + D[rr][2] * Gr[2][j])
           for j in range(3)]
        for rr in range(3)
    ]
    R3x3 = [[T[0], T[1], T[2]], [T[4], T[5], T[6]], [T[8], T[9], T[10]]]
    Jp = [[-(D[rr][0] * R3x3[0][y] + D[rr][1] * R3x3[1][y] + D[rr][2] * R3x3[2][y])
           for y in range(3)] for rr in range(3)]
    return r, Jc, Jp, pz <= 0.0


def _chi2_cols(r, stereo_w, inv_s2_e):
    return (r[0] * r[0] + r[1] * r[1] + stereo_w * r[2] * r[2]) * inv_s2_e


def _huber_cost_cols(chi2, delta2, use_kernel: bool):
    if not use_kernel:
        return chi2
    return torch.where(chi2 <= delta2, chi2,
                       2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=0.0)) - delta2)


def _inv3x3_cols(H):
    """Closed-form inverse of 3x3s stored as a list of 9 row-major columns."""
    a, b, c, d, e, f, g, h, i = H
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    idet = 1.0 / det
    return [
        A * idet, -(b * i - c * h) * idet, (b * f - c * e) * idet,
        B * idet, (a * i - c * g) * idet, -(a * f - c * d) * idet,
        C * idet, -(a * h - b * g) * idet, (a * e - b * d) * idet,
    ]


def local_bundle_adjustment(prob: BAProblem, cam, inv_sigma2_levels,
                            n_iters_pre: int = 5, n_iters_post: int = 10,
                            damping: float = 1e-5, K: int = 8):
    """Run the reference's local-BA schedule on a BAProblem.

    Returns (cam_Tcw, points, edge_inlier): optimized poses/points and the
    final chi2-based edge classification (the caller erases outlier
    observations from the map, reference: Optimizer.cc:940-1007).

    `K` caps observations-per-point inside the optimization; the final
    inlier classification always uses ALL edges.
    """
    C = prob.cam_Tcw.shape[0]
    P = prob.points.shape[0]
    dev = prob.points.device
    cam_params = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)

    # ---- grouping + per-call constants (hoisted out of the LM loop) ----
    sel, gval0 = _group_edges(prob.edge_point, prob.edge_valid, P, K)
    sel = sel.reshape(P, K).T                                    # (K, P)
    gval0 = gval0.reshape(P, K).T
    g_cam = prob.edge_cam.long()[sel]                            # (K, P)
    g_val = gval0 & prob.edge_valid[sel]
    obs_cols = [prob.edge_obs[:, j][sel] for j in range(3)]      # 3 x (K, P)
    inv_s2_e = inv_sigma2_levels[prob.edge_octave.long()[sel]]
    is_stereo = obs_cols[2] >= 0.0
    stereo_w = is_stereo.float()
    delta_e = torch.where(is_stereo, DELTA_STEREO, DELTA_MONO)
    delta2_e = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    # camera one-hot (C, K, P), and per point (P, C, K) for the coupling
    oh_ckp = (g_cam[None, :, :] == torch.arange(C, device=dev)[:, None, None]).float()
    oh_cE = oh_ckp.reshape(C, K * P)
    oh_pck = oh_ckp.permute(2, 0, 1).contiguous()
    free = prob.cam_free & prob.cam_valid
    free6 = torch.repeat_interleave(free, 6)
    eyeC6 = torch.eye(C * 6, device=dev)
    eyeC = torch.eye(C, device=dev)

    def edge_state(cam_Tcw, points):
        # expand poses to edges: (16, C) @ (C, K*P) GEMM, then 16 columns
        camflat_e = (cam_Tcw.reshape(C, 16).T @ oh_cE).reshape(16, K, P)
        T = [camflat_e[i] for i in range(16)]
        X = [points[:, j][None, :].expand(K, P) for j in range(3)]
        return _edge_cols(T, X, obs_cols, cam_params)

    def cost_from_chi2(chi2, behind, active, use_kernel):
        c = _huber_cost_cols(chi2, delta2_e, use_kernel)
        return torch.sum(torch.where(active & ~behind, c, 0.0))

    def couple(cols, y):
        """(6C, P): for each camera and point, the sum over the point's K
        slots of the one-hot-masked column, a (C, K) @ (K, 6) product per
        point."""
        stack = torch.stack([cols[i][y] for i in range(6)], dim=-1)   # (K, P, 6)
        out = torch.bmm(oh_pck, stack.permute(1, 0, 2))                # (P, C, 6)
        return out.permute(1, 2, 0).reshape(C * 6, P)

    def gn_step(cam_Tcw, points, active, use_kernel, lam):
        r, Jc, Jp, behind = edge_state(cam_Tcw, points)
        chi2 = _chi2_cols(r, stereo_w, inv_s2_e)
        c_old = cost_from_chi2(chi2, behind, active, use_kernel)
        w = huber_weight(chi2, delta_e) if use_kernel else torch.ones_like(chi2)
        w = torch.where(active & ~behind, w * inv_s2_e, 0.0)
        wrow = [w, w, w * stereo_w]

        # --- camera blocks: (27, K*P) @ (K*P, C) one-hot GEMM ---
        hcc_bc = torch.stack(
            [sum(wrow[rr] * Jc[rr][i] * Jc[rr][j] for rr in range(3))
             for i in range(6) for j in range(i, 6)]
            + [sum(wrow[rr] * Jc[rr][i] * r[rr] for rr in range(3))
               for i in range(6)], dim=0).reshape(27, K * P)    # 21 + 6
        Hcc_bc = hcc_bc @ oh_cE.T                                # (27, C)
        ut = [[None] * 6 for _ in range(6)]
        n = 0
        for i in range(6):
            for j in range(i, 6):
                ut[i][j] = Hcc_bc[n]
                ut[j][i] = Hcc_bc[n]
                n += 1
        b_c_cols = [Hcc_bc[21 + i] for i in range(6)]            # 6 x (C,)

        # --- point blocks: sum over the K slots ---
        Hpp = [torch.sum(sum(wrow[rr] * Jp[rr][y] * Jp[rr][z] for rr in range(3)), dim=0)
               for y in range(3) for z in range(3)]              # 9 x (P,)
        b_p = [torch.sum(sum(wrow[rr] * Jp[rr][y] * r[rr] for rr in range(3)), dim=0)
               for y in range(3)]                                # 3 x (P,)

        # --- damping + 3x3 point inverses (columns) ---
        trc = ut[0][0] + ut[1][1] + ut[2][2] + ut[3][3] + ut[4][4] + ut[5][5]
        dscale_c = lam * (trc / 6.0 + 1e-6)                      # (C,)
        Hcc_d = [[ut[i][j] + dscale_c if i == j else ut[i][j] for j in range(6)]
                 for i in range(6)]
        trp = Hpp[0] + Hpp[4] + Hpp[8]
        dscale_p = lam * (trp / 3.0 + 1e-6)
        Hinv = _inv3x3_cols([Hpp[z] + dscale_p if z in (0, 4, 8) else Hpp[z]
                             for z in range(9)])                 # 9 x (P,)

        # --- coupling Y and W = Y Hpp^-1 per edge (columns) ---
        Ycols = [[sum(wrow[rr] * Jc[rr][i] * Jp[rr][y] for rr in range(3))
                  for y in range(3)] for i in range(6)]          # 6x3 of (K,P)
        Wcols = [[sum(Ycols[i][z] * Hinv[z * 3 + y][None, :] for z in range(3))
                  for y in range(3)] for i in range(6)]
        A_y = [couple(Ycols, y) for y in range(3)]
        T_y = [couple(Wcols, y) for y in range(3)]

        # --- Schur fill: 3 GEMMs (6C, P) @ (P, 6C) ---
        S_fill = sum(T_y[y] @ A_y[y].T for y in range(3))
        b_corr = sum(T_y[y] @ b_p[y] for y in range(3))          # (6C,)

        Hcc_blk = torch.stack([torch.stack(Hcc_d[i], dim=-1) for i in range(6)],
                              dim=-2)                            # (C, 6, 6)
        # the camera blocks on the diagonal: [c, i, d, j] = eye[c, d] H_c[i, j]
        S = (eyeC[:, None, :, None] * Hcc_blk[:, :, None, :]).reshape(C * 6, C * 6) - S_fill
        b_sc = torch.stack(b_c_cols, dim=-1).reshape(C * 6) - b_corr

        # gauge: identity rows/cols for fixed/invalid cams
        S = torch.where(free6[:, None] & free6[None, :], S, 0.0)
        S = S + torch.diag(torch.where(free6, 0.0, 1.0))
        b_sc = torch.where(free6, b_sc, 0.0)

        L = torch.linalg.cholesky_ex(S + 1e-8 * eyeC6).L
        y_ = torch.linalg.solve_triangular(L, b_sc[:, None], upper=False)
        dc6 = -torch.linalg.solve_triangular(L.T, y_, upper=True)[:, 0]   # (6C,)
        dc = torch.where(free[:, None], dc6.reshape(C, 6), 0.0)

        # back-substitute: dp = -Hinv (b_p + A^T dc), A^T dc via 3 matvecs
        dcf = dc.reshape(C * 6)
        rhs = [b_p[y] + dcf @ A_y[y] for y in range(3)]
        dp = torch.stack([-(Hinv[y * 3] * rhs[0] + Hinv[y * 3 + 1] * rhs[1]
                            + Hinv[y * 3 + 2] * rhs[2]) for y in range(3)], dim=-1)

        cam_new = exp_se3(dc) @ cam_Tcw
        pts_new = points + torch.where(prob.point_valid[:, None], dp, 0.0)
        return cam_new, pts_new, c_old

    def lm_iterations(n_iters, cam_Tcw, points, active, use_kernel):
        lam = torch.full((), damping, dtype=torch.float32, device=dev)   # no host copy
        for _ in range(n_iters):
            cand_c, cand_p, c_old = gn_step(cam_Tcw, points, active, use_kernel, lam)
            # LM step acceptance (g2o rejects cost-increasing steps too)
            r2, _, _, behind2 = edge_state(cand_c, cand_p)
            c_new = cost_from_chi2(_chi2_cols(r2, stereo_w, inv_s2_e), behind2, active,
                                   use_kernel)
            accept = c_new <= c_old
            cam_Tcw = torch.where(accept, cand_c, cam_Tcw)
            points = torch.where(accept, cand_p, points)
            lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7),
                              torch.clamp(lam * 8.0, max=1e2))
        return cam_Tcw, points

    cam_Tcw, points = lm_iterations(n_iters_pre, prob.cam_Tcw, prob.points, g_val, True)

    # chi2 gate between phases (reference: Optimizer.cc:916-929)
    r, _, _, behind = edge_state(cam_Tcw, points)
    chi2 = _chi2_cols(r, stereo_w, inv_s2_e)
    active = g_val & (chi2 <= delta2_e) & ~behind

    cam_Tcw, points = lm_iterations(n_iters_post, cam_Tcw, points, active, False)

    cam_Tcw = se3_renormalize(cam_Tcw)
    # final classification over ALL flat edges
    camflat_f = cam_Tcw.reshape(C, 16)[prob.edge_cam.long()]
    X_f = points[prob.edge_point.long()]
    stereo_f = (prob.edge_obs[:, 2] >= 0.0).float()
    rf, _, _, behind_f = _edge_cols(
        [camflat_f[:, i] for i in range(16)],
        [X_f[:, j] for j in range(3)],
        [prob.edge_obs[:, j] for j in range(3)], cam_params)
    chi2_f = _chi2_cols(rf, stereo_f, inv_sigma2_levels[prob.edge_octave.long()])
    th_f = torch.where(stereo_f > 0, CHI2_STEREO, CHI2_MONO)
    inlier = prob.edge_valid & (chi2_f <= th_f) & ~behind_f
    return cam_Tcw, points, inlier
