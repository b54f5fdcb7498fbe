"""Global bundle adjustment via matrix-free preconditioned CG on the
Schur-reduced camera system.

Counterpart of the flat small-map solve of
orb_slam2_detailed_comments_tpu/optim/global_ba.py, the replacement of
Optimizer::BundleAdjustment / GlobalBundleAdjustemnt [sic] (reference:
src/Optimizer.cc:62-361). The Schur complement S = Hcc - A Hpp^-1 A^T is
never materialized: its matvec is three edge-parallel passes, so PCG with
a block-Jacobi (6x6 Hcc) preconditioner runs out of edge arrays.

Every per-camera and per-point sum over edges goes through a `Reducer`.
The flat one here (`flat_reducer`) multiplies by one-hot (cameras x
edges) and (points x edges) matrices where the JAX package scatter-adds:
sums in a fixed order, no atomics, so a solve is deterministic. Those
matrices are (P, E) floats, so the caller
(backend/local_mapping.solve_global_ba) keeps E below 4096 and takes
optim/global_ba_grouped.py's layout reducer above that, with this same
LM / PCG solve (`solve_lm`). The iteration counts are fixed and the LM
acceptance is a torch.where, so a solve makes no host sync.

Shares the BAProblem edge-list format with local_ba.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..geometry.se3 import exp_se3, se3_renormalize
from .local_ba import BAProblem, _edge_terms, _inv3x3, _stereo_row_mask, edge_chi2
from .robust import CHI2_MONO, CHI2_STEREO, DELTA_MONO, DELTA_STEREO, huber_weight

# an interruptible solve polls its stop check before every this many LM
# iterations of each phase (the JAX package's chunk of 2)
STOP_POLL_EVERY = 2


def _same(x):
    return x


class Reducer(NamedTuple):
    """Per-camera and per-point sums of per-edge rows: (E, n) -> (C, n)
    and (E, n) -> (P, n), each in a fixed order. `ranks` sums a value
    every rank holds a part of (the robust cost, a dense step's Schur
    complement) over the ranks of a sharded solve
    (parallel/distributed_ba*.py), whose `cam` and, edge-sharded, `point`
    sum over the ranks too; one device leaves it the identity."""
    cam: Callable
    point: Callable
    ranks: Callable = _same


def flat_reducer(prob: BAProblem) -> Reducer:
    """Sums as products with one-hot (C, E) and (P, E) matrices."""
    C = prob.cam_Tcw.shape[0]
    P = prob.points.shape[0]
    dev = prob.points.device
    oh_c = (prob.edge_cam.long()[None, :] == torch.arange(C, device=dev)[:, None]).float()
    oh_p = (prob.edge_point.long()[None, :] == torch.arange(P, device=dev)[:, None]).float()
    return Reducer(cam=lambda x: oh_c @ x, point=lambda x: oh_p @ x)


def _robust_cost(cam_Tcw, points, prob: BAProblem, active, cam_params,
                 inv_sigma2_levels, use_kernel: bool):
    """Total robust objective: sum of Huber rho(chi2) over active edges
    (g2o's activeRobustChi2(), which LM uses for step acceptance)."""
    chi2, behind = edge_chi2(cam_Tcw, points, prob, cam_params, inv_sigma2_levels)
    if use_kernel:
        is_stereo = prob.edge_obs[:, 2] >= 0.0
        delta2 = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
        chi2 = torch.where(chi2 <= delta2, chi2,
                           2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=0.0)) - delta2)
    return torch.sum(torch.where(active & ~behind, chi2, 0.0))


def _assemble(cam_Tcw, points, prob: BAProblem, active, cam_params,
              inv_sigma2_levels, use_kernel: bool, damping, red: Reducer):
    """Per-iteration linearization: returns (Hcc_d, Hpp_inv, Y, g_c, g_p)."""
    C = cam_Tcw.shape[0]
    P = points.shape[0]
    r, J_cam, J_pt, behind = _edge_terms(cam_Tcw, points, prob, cam_params)

    is_stereo, row_mask = _stereo_row_mask(prob)
    inv_s2 = inv_sigma2_levels[prob.edge_octave.long()]
    rw = r * row_mask
    chi2 = torch.sum(rw * rw, dim=-1) * inv_s2
    delta = torch.where(is_stereo, DELTA_STEREO, DELTA_MONO)
    w = huber_weight(chi2, delta) if use_kernel else torch.ones_like(chi2)
    w = torch.where(active & ~behind, w * inv_s2, 0.0)

    Jc = J_cam * row_mask[:, :, None]
    Jp = J_pt * row_mask[:, :, None]

    Hcc = red.cam(torch.einsum("eri,erj,e->eij", Jc, Jc, w).reshape(-1, 36)).reshape(C, 6, 6)
    Hpp = red.point(torch.einsum("eri,erj,e->eij", Jp, Jp, w).reshape(-1, 9)).reshape(P, 3, 3)
    g_c = red.cam(torch.einsum("eri,er,e->ei", Jc, rw, w))
    g_p = red.point(torch.einsum("eri,er,e->ei", Jp, rw, w))
    Y = torch.einsum("eri,erj,e->eij", Jc, Jp, w)  # (E, 6, 3)

    eye3 = torch.eye(3, device=points.device)
    eye6 = torch.eye(6, device=points.device)
    tr_p = torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1)
    tr_c = torch.diagonal(Hcc, dim1=-2, dim2=-1).sum(-1)
    Hpp_d = Hpp + damping * (tr_p[:, None, None] / 3.0 + 1e-6) * eye3
    Hcc_d = Hcc + damping * (tr_c[:, None, None] / 6.0 + 1e-6) * eye6
    return Hcc_d, _inv3x3(Hpp_d), Y, g_c, g_p


def _schur_matvec(x, Hcc_d, Hpp_inv, Y, edge_cam, edge_point, free_mask, red: Reducer):
    """S x = Hcc x - A Hpp^-1 A^T x, all edge-parallel."""
    x = x * free_mask[:, None]
    u = torch.einsum("cij,cj->ci", Hcc_d, x)
    v = red.point(torch.einsum("eij,ei->ej", Y, x[edge_cam]))      # A^T x
    wv = torch.einsum("pij,pj->pi", Hpp_inv, v)                    # Hpp^-1 A^T x
    u = u - red.cam(torch.einsum("eij,ej->ei", Y, wv[edge_point]))
    return u * free_mask[:, None]


def _pcg(matvec, b, Minv, n_iters: int):
    """Fixed-iteration preconditioned CG."""
    x = torch.zeros_like(b)
    r = b
    z = torch.einsum("cij,cj->ci", Minv, r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(n_iters):
        Ap = matvec(p)
        pAp = torch.sum(p * Ap)
        alpha = rz / torch.where(torch.abs(pAp) < 1e-20, 1e-20, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = torch.einsum("cij,cj->ci", Minv, r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.where(torch.abs(rz) < 1e-20, 1e-20, rz)
        p = z + beta * p
        rz = rz_new
    return x


def _gba_iteration(cam_Tcw, points, prob: BAProblem, active, cam_params,
                   inv_sigma2_levels, use_kernel, damping, cg_iters, red: Reducer):
    Hcc_d, Hpp_inv, Y, g_c, g_p = _assemble(
        cam_Tcw, points, prob, active, cam_params, inv_sigma2_levels,
        use_kernel, damping, red)
    free = (prob.cam_free & prob.cam_valid).float()
    e_cam, e_pt = prob.edge_cam.long(), prob.edge_point.long()

    # rhs: -(g_c - A Hpp^-1 g_p)
    hg = torch.einsum("pij,pj->pi", Hpp_inv, g_p)
    rhs = -(g_c - red.cam(torch.einsum("eij,ej->ei", Y, hg[e_pt])))
    rhs = rhs * free[:, None]

    eye6 = torch.eye(6, device=points.device)
    Minv = torch.linalg.inv_ex(Hcc_d + (1.0 - free)[:, None, None] * eye6).inverse
    dc = _pcg(lambda x: _schur_matvec(x, Hcc_d, Hpp_inv, Y, e_cam, e_pt, free, red),
              rhs, Minv, cg_iters)

    # back-substitute points: dp = -Hpp^-1 (g_p + A^T dc)
    atdc = red.point(torch.einsum("eij,ei->ej", Y, dc[e_cam]))
    dp = -torch.einsum("pij,pj->pi", Hpp_inv, g_p + atdc)

    dc = dc * free[:, None]
    cam_new = exp_se3(dc) @ cam_Tcw
    dp = torch.where(prob.point_valid[:, None], dp, 0.0)
    return cam_new, points + dp


def global_bundle_adjustment(prob: BAProblem, cam, inv_sigma2_levels,
                             n_iters: int = 10, cg_iters: int = 50,
                             damping: float = 1e-5, stop_check=None):
    """LM iterations with PCG-Schur inner solves (the reference runs 10 or
    20 LM iterations for global BA, Optimizer.cc:80 / Tracking.cc:1089).
    Robust kernel active on the first half of the iterations only. A step
    is accepted only if it does not increase the robust objective; a
    rejected one raises the damping (g2o's Levenberg rollback). None when
    `stop_check` stopped it (solve_lm)."""
    return solve_lm(prob, cam, inv_sigma2_levels, n_iters, cg_iters, damping,
                    flat_reducer(prob), stop_check)


def lm_cost(prob: BAProblem, cam_Tcw, points, active, cam_params, inv_sigma2_levels,
            use_kernel: bool, red: Reducer):
    """The objective LM compares, summed over the ranks (red.ranks), so
    every rank takes the same accept / reject branch."""
    return red.ranks(_robust_cost(cam_Tcw, points, prob, active, cam_params,
                                  inv_sigma2_levels, use_kernel))


def lm_steps(prob: BAProblem, cam_Tcw, points, active, use_kernel: bool, lam, c_cur, n: int,
             cam_params, inv_sigma2_levels, cg_iters: int, red: Reducer, step=_gba_iteration):
    """n LM iterations from the carried damping `lam` and cost `c_cur`:
    a step is kept only if it does not raise the robust objective; a
    rejected one raises the damping (g2o's Levenberg rollback). Returns
    (cam_Tcw, points, lam, c_cur)."""
    for _ in range(n):
        cand_c, cand_p = step(cam_Tcw, points, prob, active, cam_params, inv_sigma2_levels,
                              use_kernel, lam, cg_iters, red)
        c_new = lm_cost(prob, cand_c, cand_p, active, cam_params, inv_sigma2_levels,
                        use_kernel, red)
        accept = c_new <= c_cur
        cam_Tcw = torch.where(accept, cand_c, cam_Tcw)
        points = torch.where(accept, cand_p, points)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7),
                          torch.clamp(lam * 8.0, max=1e2))
        c_cur = torch.where(accept, c_new, c_cur)
    return cam_Tcw, points, lam, c_cur


def inlier_edges(prob: BAProblem, cam_Tcw, points, cam_params, inv_sigma2_levels):
    """Valid edges in front of their camera with chi2 under the reference's
    thresholds (5.991 mono, 7.815 stereo)."""
    chi2, behind = edge_chi2(cam_Tcw, points, prob, cam_params, inv_sigma2_levels)
    chi2_th = torch.where(prob.edge_obs[:, 2] >= 0.0, CHI2_STEREO, CHI2_MONO)
    return prob.edge_valid & (chi2 <= chi2_th) & ~behind


def solve_lm(prob: BAProblem, cam, inv_sigma2_levels, n_iters: int, cg_iters: int,
             damping: float, red: Reducer, stop_check=None, step=_gba_iteration):
    """The LM schedule of global_bundle_adjustment with its sums taken by
    `red` and its GN steps by `step` (the PCG one, or a layout's dense
    one). Returns (cam_Tcw, points, edge_inlier over prob's edges).

    `stop_check`, a host callable, is polled before every STOP_POLL_EVERY LM
    iterations of each phase (the reference's mbStopGBA, polled between g2o
    iterations, LoopClosing.cc:699-712); when it returns True the solve
    returns None. The damping, the cost and the activation carry across
    the polls, so a solve the check never stops is the unpolled solve, op
    for op; a poll reads no device value."""
    dev = prob.points.device
    cam_params = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)

    def lm_phase(n, cam_Tcw, points, active, use_kernel):
        lam = torch.full((), damping, dtype=torch.float32, device=dev)   # no host copy
        c_cur = lm_cost(prob, cam_Tcw, points, active, cam_params, inv_sigma2_levels,
                        use_kernel, red)
        for i in range(0, n, STOP_POLL_EVERY):
            if stop_check is not None and stop_check():
                return None
            cam_Tcw, points, lam, c_cur = lm_steps(
                prob, cam_Tcw, points, active, use_kernel, lam, c_cur,
                min(STOP_POLL_EVERY, n - i), cam_params, inv_sigma2_levels, cg_iters, red, step)
        return cam_Tcw, points

    n_pre = max(n_iters // 2, 1)
    out = lm_phase(n_pre, prob.cam_Tcw, prob.points, prob.edge_valid, True)
    if out is None:
        return None
    cam_Tcw, points = out

    # chi2-gate outliers before dropping the robust kernel (the reference
    # erases outlier edges between its two optimize() calls,
    # Optimizer.cc:916-935)
    active = inlier_edges(prob, cam_Tcw, points, cam_params, inv_sigma2_levels)
    out = lm_phase(n_iters - n_pre, cam_Tcw, points, active, False)
    if out is None:
        return None
    cam_Tcw = se3_renormalize(out[0])
    return cam_Tcw, out[1], inlier_edges(prob, cam_Tcw, out[1], cam_params, inv_sigma2_levels)
