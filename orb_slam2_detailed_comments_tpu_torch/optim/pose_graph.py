"""Essential-graph Sim3 pose-graph optimization (loop correction).

Counterpart of orb_slam2_detailed_comments_tpu/optim/pose_graph.py, the
replacement of Optimizer::OptimizeEssentialGraph (reference:
src/Optimizer.cc:1050-1381): 7-DoF Sim3 vertices per keyframe, relative
Sim3 edges (new loop connections, spanning tree, past loops, strong
covisibility), solved with Gauss-Newton. The per-edge 7x14 Jacobians come
from forward-mode differentiation of the Sim3 log-composition error
(torch.func.vmap over torch.func.jacfwd of `_edge_error`).

Three backends, as in the JAX package; backend="auto" picks one by size
and shape (`pose_graph_backend`):

  * "dense" (K <= DENSE_MAX_VERTICES): the normal system as one GEMM of
    the dense (7E, 7K) Jacobian with itself, a Cholesky factor and two
    triangular solves;
  * "banded" (larger K, when the graph bands in keyframe order, which
    odometry plus covisibility plus a few loop edges always do): a
    block-banded Cholesky plus a Woodbury correction for the long edges
    and the float32 stiffness anchors, then two refinement steps. The
    band of half-width W vertex blocks is factored as a block-tridiagonal
    matrix of W-vertex super-blocks, a Python loop over about K/W blocks
    (the JAX package scans over the K vertices);
  * "cg" (larger K that does not band): matrix-free Gauss-Newton in
    spanning-tree-relative coordinates with block-Jacobi PCG. The inner
    loop stops on its residual, as the JAX package's while_loop, so each
    CG step reads one value back to the host.

Every sum over edges is a SegmentSum (optim/segments.py) or a GEMM, in a
fixed order: no scatter-add. The problem is nondimensionalized by its
trajectory scale first, a deliberate deviation from g2o (see
optimize_pose_graph). The host prepares the problem (numpy), then the
solve runs on `device`.

Edge error (g2o EdgeSim3 convention): e = log(Sji . Si . Sj^-1) where Si,
Sj are world->keyframe Sim3 and Sji the measured relative transform.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jvp, vmap

from ..geometry.sim3 import exp_sim3, log_sim3, sim3_inverse
from .segments import SegmentSum


class PoseGraphProblem(NamedTuple):
    """Numpy arrays or tensors (any device)."""
    S_init: object        # (K, 4, 4) initial world->KF Sim3 (sR | t)
    vertex_fixed: object  # (K,) bool (loop KF + origin fixed)
    vertex_valid: object  # (K,) bool
    edge_i: object        # (E,) int32
    edge_j: object        # (E,) int32
    edge_Sji: object      # (E, 4, 4) measured relative Sim3
    edge_valid: object    # (E,) bool
    edge_weight: object   # (E,) float32


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _edge_error(xi_i, xi_j, Si, Sj, Sji):
    """(E, 7) errors of the edges with tangent perturbations (E, 7) of
    their two vertices."""
    return log_sim3(Sji @ (exp_sim3(xi_i) @ Si) @ sim3_inverse(exp_sim3(xi_j) @ Sj))


def _edge_terms(Si, Sj, Sji):
    """Residuals r (E, 7) and Jacobians Ji, Jj (E, 7, 7) at zero tangents."""
    zero = Si.new_zeros((Si.shape[0], 7))
    basis = torch.eye(7, dtype=Si.dtype, device=Si.device)[:, None, :].expand(7, Si.shape[0], 7)
    r = log_sim3(Sji @ Si @ sim3_inverse(Sj))

    def column(fn):
        return vmap(lambda v: jvp(fn, (zero,), (v,))[1])(basis).permute(1, 2, 0)

    Ji = column(lambda x: _edge_error(x, zero, Si, Sj, Sji))
    Jj = column(lambda x: _edge_error(zero, x, Si, Sj, Sji))
    return r, Ji, Jj


def _safeguard_step(dx):
    """GN step safeguard (no LM acceptance in these solvers): cap the
    rotation+scale tangent (dx[:, 3:7]) at 1.5 so exp_sim3 stays in its
    domain and the translation tangent at 100, far above any legitimate
    correction in nondimensionalized units but finite."""
    rmax = torch.max(torch.sqrt(torch.sum(dx[:, 3:7] ** 2, dim=1)))
    dx = dx * torch.where(rmax > 1.5, 1.5 / rmax, 1.0)
    tmax = torch.max(torch.sqrt(torch.sum(dx[:, :3] ** 2, dim=1)))
    return dx * torch.where(tmax > 100.0, 100.0 / tmax, 1.0)


def _blocks(Ji, Jj, r, w):
    """Per-edge normal-equation blocks Hii, Hjj, Hij (E, 7, 7), bi, bj (E, 7)."""
    return (torch.einsum("eri,erj,e->eij", Ji, Ji, w),
            torch.einsum("eri,erj,e->eij", Jj, Jj, w),
            torch.einsum("eri,erj,e->eij", Ji, Jj, w),
            torch.einsum("eri,er,e->ei", Ji, r, w),
            torch.einsum("eri,er,e->ei", Jj, r, w))


def _solve_dense(S0, free, ei, ej, Sji, w, n_iters: int, damping: float):
    K = S0.shape[0]
    E = ei.shape[0]
    dev = S0.device
    free7 = torch.repeat_interleave(free, 7)
    ar = torch.arange(K, device=dev)
    ohi = (ei[:, None] == ar[None, :]).float()              # (E, K)
    ohj = (ej[:, None] == ar[None, :]).float()
    w_rows = torch.repeat_interleave(w, 7)
    eye = torch.eye(K * 7, device=dev)
    S = S0
    for _ in range(n_iters):
        r, Ji, Jj = _edge_terms(S[ei], S[ej], Sji)
        # the dense (7E, 7K) Jacobian: H = J^T W J and b = J^T W r as GEMMs
        Jf = (ohi[:, None, :, None] * Ji[:, :, None, :]
              + ohj[:, None, :, None] * Jj[:, :, None, :]).reshape(E * 7, K * 7)
        WJ = w_rows[:, None] * Jf
        H = Jf.T @ WJ
        b = WJ.T @ r.reshape(E * 7)
        Hd = torch.where(free7[:, None] & free7[None, :], H, 0.0)
        Hd = Hd + torch.diag(torch.where(free7, damping, 1.0))
        Hd = Hd + damping * torch.trace(Hd) / (K * 7) * eye
        bd = torch.where(free7, b, 0.0)
        L = torch.linalg.cholesky_ex(Hd).L
        y = torch.linalg.solve_triangular(L, bd[:, None], upper=False)
        dx = -torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0].reshape(K, 7)
        S = exp_sim3(torch.where(free[:, None], dx, 0.0)) @ S
    return S


# ---- banded + Woodbury --------------------------------------------------------

BANDED_W_CHOICES = (4, 8, 16)   # quantized half-bandwidths (block units)
BANDED_LONG_CAP = 48            # max Woodbury edges
BANDED_ANCHOR_STRIDE = 96       # f32 conditioning: anchor every ~96th vertex


def _partition_edges_banded(edge_i, edge_j, edge_valid, vertex_valid, vertex_fixed):
    """Host-side routing: the smallest quantized bandwidth that leaves at
    most BANDED_LONG_CAP long-range edges, and the f32 stiffness-anchor
    vertices (free, every ~96th). Returns (W, short_sel, long_sel,
    anchor_sel) or None if the graph doesn't band."""
    K = int(vertex_valid.shape[0])
    d = np.abs(edge_i.astype(np.int64) - edge_j.astype(np.int64))
    free_idx = np.nonzero(vertex_valid & ~vertex_fixed)[0]
    anchors = free_idx[BANDED_ANCHOR_STRIDE // 2::BANDED_ANCHOR_STRIDE]
    for Wc in BANDED_W_CHOICES:
        if Wc >= K - 1:
            break
        long_mask = edge_valid & (d > Wc)
        if int(long_mask.sum()) + anchors.size <= BANDED_LONG_CAP:
            return (Wc, np.nonzero(edge_valid & (d <= Wc))[0], np.nonzero(long_mask)[0],
                    anchors)
    return None


class _SuperBlocks:
    """The block band of half-width W vertex blocks of a (7K, 7K) matrix
    as a block-tridiagonal one over n = ceil(K / W) super-blocks of W
    vertices (padding vertices get identity blocks): every coupling within
    W vertices falls in one super-block or between two adjacent ones. The
    index tables are built on the host once per solve."""

    def __init__(self, K: int, W: int, device):
        self.W, self.n = W, -(-K // W)
        k = np.arange(K)
        kk, dd = np.meshgrid(k, np.arange(W), indexing="ij")
        m = kk - dd - 1
        ok = m >= 0
        kk, dd, m = kk[ok], dd[ok], m[ok]
        same = kk // W == m // W

        def t(a):
            return torch.as_tensor(a, dtype=torch.int64).to(device)

        self.diag_idx = (t(k // W), t(k % W))
        self.pad = t(np.arange(K, self.n * W))
        self.off_kd = (t(kk), t(dd))
        self.same = (t(np.nonzero(same)[0]), t(kk[same] // W), t(kk[same] % W), t(m[same] % W))
        self.cross = (t(np.nonzero(~same)[0]), t(kk[~same] // W), t(kk[~same] % W),
                      t(m[~same] % W))

    def build(self, diag, off):
        """diag (K, 7, 7), off (K, W, 7, 7) with off[k, d] = H[k, k-d-1]
        -> (D (n, 7W, 7W) diagonal super-blocks, B (n, 7W, 7W) with B[s] =
        H[super-block s, super-block s-1])."""
        n, W = self.n, self.W
        D = diag.new_zeros((n, W, 7, W, 7))
        B = diag.new_zeros((n, W, 7, W, 7))
        sb, loc = self.diag_idx
        D[sb, loc, :, loc, :] = diag
        eye7 = torch.eye(7, dtype=diag.dtype, device=diag.device)
        D[self.pad // W, self.pad % W, :, self.pad % W, :] = eye7
        X = off[self.off_kd[0], self.off_kd[1]]
        sel, s, a, c = self.same
        Xs = X[sel]
        D[s, a, :, c, :] = Xs
        D[s, c, :, a, :] = Xs.transpose(-1, -2)
        sel, s, a, c = self.cross
        B[s, a, :, c, :] = X[sel]
        return D.reshape(n, 7 * W, 7 * W), B.reshape(n, 7 * W, 7 * W)


def _tridiag_cholesky(D, B):
    """Block-tridiagonal Cholesky: L[s] lower factors of the diagonal
    super-blocks, C[s - 1] = L[s, s-1] for s >= 1."""
    Ls, Cs = [], []
    for s in range(D.shape[0]):
        A = D[s]
        if s:
            C = torch.linalg.solve_triangular(Ls[-1], B[s].T, upper=False).T
            A = A - C @ C.T
            Cs.append(C)
        Ls.append(torch.linalg.cholesky_ex(A).L)
    return Ls, Cs


def _tridiag_solve(Ls, Cs, R):
    """Solve L L^T X = R for R (n, 7W, m)."""
    n = len(Ls)
    y = []
    for s in range(n):
        rhs = R[s] if s == 0 else R[s] - Cs[s - 1] @ y[-1]
        y.append(torch.linalg.solve_triangular(Ls[s], rhs, upper=False))
    x = [None] * n
    for s in reversed(range(n)):
        rhs = y[s] if s == n - 1 else y[s] - Cs[s].T @ x[s + 1]
        x[s] = torch.linalg.solve_triangular(Ls[s].T, rhs, upper=True)
    return torch.stack(x)


def _solve_banded(S0, free, ei, ej, ei_h, ej_h, Sji, w, part, n_iters: int, damping: float):
    """Exact direct GN solve at KITTI-00 scale: banded block Cholesky plus
    a Woodbury long-range correction, as the JAX package's
    _optimize_pose_graph_banded.

    In keyframe order the essential graph is nearly block banded: only
    loop(-connection) edges are long-range. So H = B + U D U^T with B
    block-banded (half-bandwidth W blocks) and the low-rank part carrying
    (a) the sqrt-weighted Jacobian rows of the M long edges (D = +I) and
    (b) negative copies of stiffness anchors added to B (D = -I): a
    one-end-anchored pose chain has condition ~K^2, beyond float32 at
    K = 1408; sigma I at every ~96th free vertex caps the segment length
    inside B and the Woodbury term subtracts the anchors exactly. Two
    refinement steps against the true H mop up the float32 cancellation."""
    K = S0.shape[0]
    dev = S0.device
    W, short_sel, long_sel, anchor_sel = part
    M, Ca = int(long_sel.size), int(anchor_sel.size)
    s_i, s_j = ei_h[short_sel], ej_h[short_sel]
    delta = np.abs(s_i - s_j)
    in_band = delta > 0                    # a self-loop has no off-diagonal block
    seg_ends = SegmentSum(np.concatenate([ei_h, ej_h]), K, dev)
    seg_diag = SegmentSum(np.concatenate([s_i, s_j]), K, dev)
    seg_off = SegmentSum((np.maximum(s_i, s_j) * W + delta - 1)[in_band], K * W, dev)
    blocks = _SuperBlocks(K, W, dev)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64).to(dev)

    short_t, long_t, anchor_t = t(short_sel), t(long_sel), t(anchor_sel)
    band_t, i_row_t = t(np.nonzero(in_band)[0]), torch.as_tensor(s_i > s_j).to(dev)
    l_i, l_j = t(ei_h[long_sel]), t(ej_h[long_sel])
    arM, arC = torch.arange(M, device=dev), M + torch.arange(Ca, device=dev)
    is_anchor = torch.zeros(K, dtype=torch.bool, device=dev)
    is_anchor[anchor_t] = True
    freef = free.float()[:, None]
    eye7 = torch.eye(7, device=dev)
    n_lr = 7 * (M + Ca)
    dsign = torch.cat([torch.ones(7 * M, device=dev), -torch.ones(7 * Ca, device=dev)])

    def band_solve(Ls, Cs, R):
        """R (7K, m) -> B^-1 R."""
        m = R.shape[1]
        Rp = R.new_zeros((blocks.n * W * 7, m))
        Rp[:K * 7] = R
        return _tridiag_solve(Ls, Cs, Rp.reshape(blocks.n, 7 * W, m)).reshape(-1, m)[:K * 7]

    S = S0
    for _ in range(n_iters):
        r, Ji, Jj = _edge_terms(S[ei], S[ej], Sji)
        # fixed-vertex columns masked at the Jacobian level
        Jim = Ji * free[ei].float()[:, None, None]
        Jjm = Jj * free[ej].float()[:, None, None]
        Hii, Hjj, Hij, bi, bj = _blocks(Jim, Jjm, r, w)
        b = seg_ends(torch.cat([bi, bj]))
        D = seg_ends(torch.cat([Hii, Hjj]))
        tr = torch.sum(torch.diagonal(D, dim1=-2, dim2=-1).sum(-1) * freef[:, 0])
        nfree = torch.clamp(torch.sum(freef), min=1.0)
        lam = damping * tr / (7.0 * nfree) + 1e-10
        sigma = 1e-2 * tr / (7.0 * nfree)

        # banded part: short edges and the anchors
        diag = seg_diag(torch.cat([Hii[short_t], Hjj[short_t]]))
        diag = diag + torch.where(is_anchor[:, None, None], sigma * eye7, 0.0)
        diag = torch.where(free[:, None, None], diag + lam * eye7, eye7)
        sHij = Hij[short_t][band_t]
        X = torch.where(i_row_t[band_t][:, None, None], sHij, sHij.transpose(-1, -2))
        off = seg_off(X).reshape(K, W, 7, 7)   # block (hi, lo): Hij if i is the row
        Ls, Cs = _tridiag_cholesky(*blocks.build(diag, off))
        rhs = (-b * freef).reshape(K * 7)

        def matvec_H(x):
            xk = x.reshape(K, 7)
            xi, xj = xk[ei], xk[ej]
            yi = torch.einsum("eij,ej->ei", Hii, xi) + torch.einsum("eij,ej->ei", Hij, xj)
            yj = torch.einsum("eji,ej->ei", Hij, xi) + torch.einsum("eij,ej->ei", Hjj, xj)
            return ((seg_ends(torch.cat([yi, yj])) + lam * xk) * freef).reshape(K * 7)

        if n_lr:
            Ucols = S0.new_zeros((K, 7, M + Ca, 7))
            if M:
                sw = torch.sqrt(w[long_t])[:, None, None]
                Ucols[l_i, :, arM, :] = sw * Jim[long_t].transpose(-1, -2)
                Ucols[l_j, :, arM, :] = Ucols[l_j, :, arM, :] + sw * Jjm[long_t].transpose(-1, -2)
            if Ca:
                Ucols[anchor_t, :, arC, :] = torch.sqrt(sigma) * eye7
            U = Ucols.reshape(K * 7, n_lr)
            Y = band_solve(Ls, Cs, torch.cat([rhs[:, None], U], dim=1))
            Z = Y[:, 1:]
            core = torch.diag(dsign) + U.T @ Z          # indefinite -> LU
            # symmetric equilibration: mixed rotation/translation scales
            ds = torch.sqrt(torch.clamp(torch.abs(torch.diagonal(core)), min=1e-12))
            LU, piv, _ = torch.linalg.lu_factor_ex(core / ds[:, None] / ds[None, :])

            def apply_Minv(v, y_pre=None):
                yv = band_solve(Ls, Cs, v[:, None])[:, 0] if y_pre is None else y_pre
                tt = torch.linalg.lu_solve(LU, piv, ((U.T @ yv) / ds)[:, None])[:, 0] / ds
                return yv - Z @ tt

            x = apply_Minv(rhs, Y[:, 0])
            for _ in range(2):
                x = x + apply_Minv(rhs - matvec_H(x))
        else:
            x = band_solve(Ls, Cs, rhs[:, None])[:, 0]
        S = exp_sim3(_safeguard_step(x.reshape(K, 7) * freef)) @ S
    return S


# ---- relative-coordinate CG -------------------------------------------------------

def _ancestor_matrix(parent: np.ndarray, K: int) -> np.ndarray:
    """(K, K) bool: anc[k, a] = a is an ancestor-or-self of k. Host-side,
    tolerant of unordered ids and broken chains (unresolved nodes become
    roots after K passes)."""
    anc = np.zeros((K, K), bool)
    done = np.zeros(K, bool)
    parent = np.asarray(parent)
    roots = (parent < 0) | (parent >= K) | (parent == np.arange(K))
    for k in np.nonzero(roots)[0]:
        anc[k, k] = True
        done[k] = True
    for _ in range(K):
        todo = np.nonzero(~done)[0]
        if todo.size == 0:
            break
        progress = False
        for k in todo:
            p = parent[k]
            if done[p]:
                anc[k] = anc[p]
                anc[k, k] = True
                done[k] = True
                progress = True
        if not progress:
            for k in np.nonzero(~done)[0]:  # cycle fallback: self-rooted
                anc[k, k] = True
                done[k] = True
            break
    return anc


def _spanning_tree_from_edges(edge_i, edge_j, edge_valid, vertex_fixed) -> np.ndarray:
    """BFS parents over the edge list, rooted at the fixed vertices (or
    vertex 0). Used when the caller has no spanning tree at hand."""
    K = vertex_fixed.shape[0]
    adj = [[] for _ in range(K)]
    for a, b in zip(edge_i[edge_valid], edge_j[edge_valid]):
        adj[int(a)].append(int(b))
        adj[int(b)].append(int(a))
    parent = np.full(K, -1, np.int64)
    seen = np.zeros(K, bool)
    queue = list(np.nonzero(vertex_fixed)[0]) or [0]
    for q in queue:
        seen[q] = True
    while queue:
        a = queue.pop(0)
        for b in adj[a]:
            if not seen[b]:
                seen[b] = True
                parent[b] = a
                queue.append(b)
    return parent


def _solve_cg(S0, free, ei, ej, ei_h, ej_h, Sji, w, anc, n_iters: int, cg_iters: int,
              damping: float):
    """Matrix-free GN in relative (spanning-tree) coordinates, as the JAX
    package's _optimize_pose_graph_cg. With x = P u, P = diag(free) A
    diag(free) and A[k, a] = 1 iff a is an ancestor-or-self of k, one
    coordinate u_a moves the whole subtree below a, so the low-frequency
    drift modes a loop closure must fix converge in tens of block-Jacobi
    PCG iterations. The preconditioner is the exact block diagonal of
    P^T H P. Each CG step reads its residual back to the host for the
    exit test."""
    K = S0.shape[0]
    E = ei.shape[0]
    dev = S0.device
    freef = free.float()[:, None]
    seg_ends = SegmentSum(np.concatenate([ei_h, ej_h]), K, dev)
    P = anc.float() * freef * freef[:, 0][None, :]
    Pi, Pj = P[ei], P[ej]                                   # (E, K) path indicators
    col_live = (torch.abs(P).sum(dim=0) > 0.5)[:, None, None]
    eye7 = torch.eye(7, device=dev)
    S = S0
    for _ in range(n_iters):
        r, Ji, Jj = _edge_terms(S[ei], S[ej], Sji)
        Hii, Hjj, Hij, bi, bj = _blocks(Ji, Jj, r, w)
        b = seg_ends(torch.cat([bi, bj])) * freef
        # Levenberg scale from the absolute-space block diagonal
        D = seg_ends(torch.cat([Hii, Hjj]))
        tr = torch.sum(torch.diagonal(D, dim1=-2, dim2=-1).sum(-1) * freef[:, 0])
        lam = damping * tr / (7.0 * torch.clamp(torch.sum(freef), min=1.0)) + 1e-10

        def matvec_u(v):
            xm = (P @ v) * freef
            xi, xj = xm[ei], xm[ej]
            yi = torch.einsum("eij,ej->ei", Hii, xi) + torch.einsum("eij,ej->ei", Hij, xj)
            yj = torch.einsum("eji,ej->ei", Hij, xi) + torch.einsum("eij,ej->ei", Hjj, xj)
            return P.T @ ((seg_ends(torch.cat([yi, yj])) + lam * xm) * freef)

        # exact block diagonal of P^T H P: for ancestor column a,
        # D_u[a] = sum_e [Pi_a Hii + Pi_a Pj_a (Hij + Hij^T) + Pj_a Hjj]
        D_u = (Pi.T @ Hii.reshape(E, 49) + (Pi * Pj).T @ (Hij + Hij.transpose(-1, -2)).reshape(E, 49)
               + Pj.T @ Hjj.reshape(E, 49)).reshape(K, 7, 7)
        Minv = torch.linalg.inv_ex(torch.where(col_live, D_u + lam * eye7, eye7)).inverse

        def precond(rr):
            return torch.einsum("kij,kj->ki", Minv, rr)

        rhs = -(P.T @ b)
        x = torch.zeros_like(rhs)
        rr = rhs
        z = precond(rhs)
        p = z
        rz = torch.sum(rhs * z)
        # stop once the preconditioned residual has dropped 1e8x, or at the cap
        tol = 1e-8 * torch.clamp(rz, min=0.0) + 1e-30
        for _ in range(cg_iters):
            if not bool(rz > tol):          # the exit test: one host sync a step
                break
            Ap = matvec_u(p)
            pAp = torch.sum(p * Ap)
            alpha = rz / torch.where(torch.abs(pAp) < 1e-20, 1e-20, pAp)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = torch.sum(rr * z)
            beta = rz_new / torch.where(torch.abs(rz) < 1e-20, 1e-20, rz)
            p = z + beta * p
            rz = rz_new
        S = exp_sim3(_safeguard_step((P @ x) * freef)) @ S
    return S


DENSE_MAX_VERTICES = 256  # dense (7K, 7K) Cholesky fine up to here


def pose_graph_backend(prob: PoseGraphProblem, backend: str = "auto") -> str:
    """The backend optimize_pose_graph takes: "auto" is "dense" up to
    DENSE_MAX_VERTICES vertices, else "banded" when the graph bands in
    keyframe order, else "cg". A forced "banded" on a graph that does not
    band raises."""
    K = int(_host(prob.vertex_valid).shape[0])
    if backend not in ("auto", "dense", "banded", "cg"):
        raise ValueError(f"unknown pose-graph backend {backend!r}")
    if backend != "auto" and backend != "banded":
        return backend
    if backend == "auto" and K <= DENSE_MAX_VERTICES:
        return "dense"
    banded = _partition_edges_banded(*(_host(a) for a in (
        prob.edge_i, prob.edge_j, prob.edge_valid, prob.vertex_valid, prob.vertex_fixed))) is not None
    if backend == "banded" and not banded:
        raise ValueError("the pose graph does not band in keyframe order: use backend='cg'")
    return "banded" if banded else "cg"


def optimize_pose_graph(prob: PoseGraphProblem, n_iters: int = 20,
                        damping: float = 1e-8, backend: str = "auto",
                        cg_iters: int = 0, parent=None, device="cuda"):
    """Optimize the essential graph on `device`; returns (K, 4, 4) Sim3
    poses there. `backend` as pose_graph_backend. `parent` is the spanning
    tree (parent[k] < 0 for roots) for the cg backend; if absent, a BFS
    tree over the edges is used. `cg_iters` caps the CG steps (0: 2K,
    within [256, 8192])."""
    backend = pose_graph_backend(prob, backend)
    S_init, fixed, vvalid, ei, ej, Sji, ev, ew = (_host(a) for a in prob)
    K = S_init.shape[0]
    # Nondimensionalize: scale translations by the trajectory scale (a
    # world-coordinate scaling conjugation). Raw KITTI-class units put
    # translation Jacobians at O(100) against O(1) rotations, which costs
    # ~4 decimal digits of f32 conditioning in every backend.
    #
    # DELIBERATE DEVIATION from g2o: the per-edge error becomes
    # (rho/L, phi, sigma), i.e. the implicit information matrix weights
    # translation residuals by 1/L^2 relative to rotation instead of the
    # reference's identity in raw meters (Optimizer.cc:1129 matLambda =
    # identity). Neither weighting is covariance-derived; raw-meter
    # identity makes the objective unit-dependent, scaled identity makes
    # it scale-invariant and f32-solvable. At the near-zero residuals a
    # consistent essential graph reaches the optima coincide.
    L = max(1.0, float(np.sqrt(np.mean(S_init[:, :3, 3].astype(np.float32) ** 2))))
    S_init = np.array(S_init, np.float32)
    Sji = np.array(Sji, np.float32)
    if L > 1.0:
        S_init[:, :3, 3] /= L
        Sji[:, :3, 3] /= L
    # invalid edges made numerically inert: endpoints at vertex 0 and an
    # identity measurement, so their residual and Jacobian are finite and
    # weight 0 masks them without NaN * 0
    ev = ev.astype(bool)
    ei = np.where(ev, ei, 0).astype(np.int64)
    ej = np.where(ev, ej, 0).astype(np.int64)
    Sji = np.where(ev[:, None, None], Sji, np.eye(4, dtype=np.float32))

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)

    S0 = t(S_init)
    free = t(vvalid.astype(bool) & ~fixed.astype(bool), torch.bool)
    ei_t, ej_t, Sji_t = t(ei, torch.int64), t(ej, torch.int64), t(Sji)
    w = t(np.where(ev, ew, 0.0))
    if backend == "dense":
        S = _solve_dense(S0, free, ei_t, ej_t, Sji_t, w, n_iters, damping)
    elif backend == "banded":
        part = _partition_edges_banded(ei, ej, ev, vvalid.astype(bool), fixed.astype(bool))
        S = _solve_banded(S0, free, ei_t, ej_t, ei, ej, Sji_t, w, part, n_iters, damping)
    else:
        if parent is None:
            parent = _spanning_tree_from_edges(ei, ej, ev, fixed.astype(bool))
        if not cg_iters:
            # a cap, not a schedule: the residual test exits early
            cg_iters = int(min(max(2 * K, 256), 8192))
        anc = t(_ancestor_matrix(parent, K), torch.bool)
        S = _solve_cg(S0, free, ei_t, ej_t, ei, ej, Sji_t, w, anc, n_iters, cg_iters, damping)
    if L > 1.0:
        S = S.clone()
        S[:, :3, 3] *= L
    return S
