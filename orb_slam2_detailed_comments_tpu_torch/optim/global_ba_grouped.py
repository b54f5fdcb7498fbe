"""Grouped global bundle adjustment: the whole-map solve past the flat
solver's size.

Counterpart of orb_slam2_detailed_comments_tpu/optim/global_ba_grouped.py
(the replacement of Optimizer::GlobalBundleAdjustemnt [sic], reference:
src/Optimizer.cc:62-361). It solves the same problem as optim/global_ba.py
with the same LM schedule and Schur PCG (`global_ba.solve_lm`); only the
per-camera and per-point sums differ. The flat solver takes them as
products with (C, E) and (P, E) one-hot matrices, which grow with the map
(a 360k-edge map would need about 90 GB of them). Here a layout built once
per solve on the host takes them, in a fixed order and without atomics:

  * point-major grid (Kp, P): storage slot k * P + p holds point p's k-th
    valid edge, so a per-point sum is a sum over Kp. A point with more
    than Kp edges puts the rest in a spill grid (Ks, Us) over the Us such
    points, summed over Ks and added to those (distinct) points;
  * camera-major selection (Kc, C): the storage slot of camera c's k-th
    edge, so a per-camera sum is one gather and a sum over Kc. A camera
    with more than Kc edges puts the rest in a spill selection (Kcs, Uc),
    summed the same way and added to those (distinct) cameras.

No edge is dropped: the layout covers every valid edge once. The solve
is the JAX package's "gather" formulation in exact float32; its "gemm"
(bfloat16 one-hot limbs on the MXU) computes the same function for the
TPU and is not carried over, and "gemm" names this formulation in the
port. Its "dense" step (`dense_step`: the Schur complement S = Hcc -
A Hpp^-1 A^T materialized as a (6C, 6C) matrix and solved by LU) is, for
the sharded solve (parallel/distributed_ba_grouped.py), which takes it
at C <= DENSE_MAX_CAMS: one cross-rank sum of S a GN step instead of one
a CG matvec. The layout is host numpy; after it a solve makes no host
sync (global_ba.solve_lm).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..geometry.se3 import exp_se3
from .global_ba import Reducer, _assemble, solve_lm
from .local_ba import BAProblem
from .segments import grid_dims, ragged_grid

# the sharded solve takes the dense step up to this many cameras (the JAX
# package's DENSE_MAX_CAMS: (6C)^2 x 3P products stay cheap)
DENSE_MAX_CAMS = 512


class GroupedGBA(NamedTuple):
    """A BAProblem with its edges in storage order, and the index grids
    that sum per camera and per point over that order."""
    prob: BAProblem           # S storage slots as edges; padding slots invalid
    shape: Tuple[int, int, int, int]   # (Kp, P, Ks, Us): the two point grids
    s_point: torch.Tensor     # (Us,) int64 point of each spill column
    c_sel: torch.Tensor       # (Kc, C) int64 storage slot
    c_valid: torch.Tensor     # (Kc, C) bool
    cs_sel: torch.Tensor      # (Kcs, Uc) int64 storage slot
    cs_valid: torch.Tensor    # (Kcs, Uc) bool
    cs_cam: torch.Tensor      # (Uc,) int64 camera of each spill column
    slot_edge: torch.Tensor   # (S,) int64 edge of each slot, -1 for padding
    edge_slot: torch.Tensor   # (E,) int64 slot of each valid edge, 0 otherwise


def layout_dims(prob: BAProblem, kp_cap: int = 32, kc_cap: int = 1024):
    """(Kp, Ks, Us, Kc, Kcs, Uc): the shape group_global_problem gives
    `prob`'s layout, from its degrees alone. The point grid (Kp, P) and
    spill (Ks, Us), the camera grid (Kc, C) and spill (Kcs, Uc)."""
    val = prob.edge_valid.cpu().numpy()
    deg_p = np.bincount(prob.edge_point.cpu().numpy()[val], minlength=int(prob.points.shape[0]))
    deg_c = np.bincount(prob.edge_cam.cpu().numpy()[val], minlength=int(prob.cam_Tcw.shape[0]))
    return grid_dims(deg_p, kp_cap) + grid_dims(deg_c, kc_cap)


def group_global_problem(prob: BAProblem, kp_cap: int = 32, kc_cap: int = 1024,
                         dims=None) -> GroupedGBA:
    """Build the layout on the host (numpy), in the JAX package's orders:
    stable sorts by point and by camera over edge ids. Kp = min(largest
    point degree, kp_cap), Kc = min(largest camera degree, kc_cap).

    `dims` (Kp, Ks, Us, Kc, Kcs, Uc) pins the grids' depths and the least
    spill shapes (the JAX package's force_kp, force_kc, min_sp and min_sc),
    so that the shards of a sharded problem share one shape; with dims =
    layout_dims(prob) the layout is the one built without them."""
    kp = kcs = (0, (0, 0))
    if dims is not None:
        kp, kcs = (dims[0], tuple(dims[1:3])), (dims[3], tuple(dims[4:6]))
    dev = prob.points.device
    e_pt = prob.edge_point.cpu().numpy().astype(np.int64)
    e_cam = prob.edge_cam.cpu().numpy().astype(np.int64)
    e_obs = prob.edge_obs.cpu().numpy()
    e_oct = prob.edge_octave.cpu().numpy()
    e_val = prob.edge_valid.cpu().numpy()
    P = int(prob.points.shape[0])
    C = int(prob.cam_Tcw.shape[0])
    E = e_pt.shape[0]
    eids = np.arange(E, dtype=np.int64)

    # ---- point-major storage ----
    ve = eids[e_val]
    order = ve[np.argsort(e_pt[ve], kind="stable")]
    g_sel, g_val, s_pts, s_sel, s_val = ragged_grid(order, e_pt[order], P, kp_cap, *kp)
    Kp, Ks, Us = g_sel.shape[0], s_sel.shape[0], s_pts.size
    slot_edge = np.concatenate([np.where(g_val, g_sel, -1).ravel(),
                                np.where(s_val, s_sel, -1).ravel()])
    slot_point = np.concatenate([np.broadcast_to(np.arange(P), (Kp, P)).ravel(),
                                 np.broadcast_to(s_pts, (Ks, Us)).ravel()])
    live = slot_edge >= 0
    e = np.maximum(slot_edge, 0)
    obs = np.where(live[:, None], e_obs[e], np.array([0.0, 0.0, -1.0], np.float32))
    edge_slot = np.zeros(E, np.int64)
    edge_slot[slot_edge[live]] = np.nonzero(live)[0]

    # ---- camera-major selection over the stored edges ----
    stored = eids[e_val]
    corder = stored[np.argsort(e_cam[stored], kind="stable")]
    c_sel, c_val, cs_cam, cs_sel, cs_val = ragged_grid(corder, e_cam[corder], C, kc_cap, *kcs)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(dev)

    sprob = BAProblem(
        cam_Tcw=prob.cam_Tcw, cam_free=prob.cam_free, cam_valid=prob.cam_valid,
        points=prob.points, point_valid=prob.point_valid,
        edge_cam=t(np.where(live, e_cam[e], 0), torch.int32),
        edge_point=t(slot_point, torch.int32), edge_obs=t(obs, torch.float32),
        edge_octave=t(np.where(live, e_oct[e], 0), torch.int32), edge_valid=t(live, torch.bool))
    return GroupedGBA(
        prob=sprob, shape=(Kp, P, Ks, Us), s_point=t(s_pts, torch.int64),
        c_sel=t(np.where(c_val, edge_slot[c_sel], 0), torch.int64), c_valid=t(c_val, torch.bool),
        cs_sel=t(np.where(cs_val, edge_slot[cs_sel], 0), torch.int64),
        cs_valid=t(cs_val, torch.bool), cs_cam=t(cs_cam, torch.int64),
        slot_edge=t(slot_edge, torch.int64), edge_slot=t(edge_slot, torch.int64))


def layout_reducer(gp: GroupedGBA) -> Reducer:
    """Per-camera and per-point sums over storage rows (S, n): sums over
    the grids' first axis, then the spill columns added to their distinct
    cameras / points (an indexed write, no atomics)."""
    Kp, P, Ks, Us = gp.shape
    n_grid = Kp * P

    def point(x):
        out = x[:n_grid].reshape(Kp, P, -1).sum(0)
        if Us:
            spill = x[n_grid:].reshape(Ks, Us, -1).sum(0)
            out[gp.s_point] = out[gp.s_point] + spill
        return out

    def cam(x):
        out = torch.where(gp.c_valid[..., None], x[gp.c_sel], 0.0).sum(0)
        if gp.cs_cam.numel():
            spill = torch.where(gp.cs_valid[..., None], x[gp.cs_sel], 0.0).sum(0)
            out[gp.cs_cam] = out[gp.cs_cam] + spill
        return out

    return Reducer(cam=cam, point=point)


def dense_step(gp: GroupedGBA):
    """The JAX package's _gba_dense_iteration as a solve_lm step on this
    layout: the coupling A (P, C, 6, 3) of every point with every camera,
    summed from the storage slots (a point meets each camera once in a row
    of the grids, so each row is one indexed add with distinct indices,
    in a fixed order), S = Hcc - A Hpp^-1 A^T as a dense (6C, 6C) matrix and
    one LU solve (solve_ex: no host sync) in place of the PCG. `red.ranks`
    sums S and the gradient's correction over ranks once a step."""
    Kp, P, Ks, Us = gp.shape
    n_grid = Kp * P
    rows = [(slice(k * P, (k + 1) * P), None) for k in range(Kp)]
    rows += [(slice(n_grid + k * Us, n_grid + (k + 1) * Us), gp.s_point) for k in range(Ks)]

    def step(cam_Tcw, points, prob, active, cam_params, inv_sigma2_levels, use_kernel,
             damping, cg_iters, red: Reducer):
        C = cam_Tcw.shape[0]
        dev = points.device
        Hcc_d, Hpp_inv, Y, g_c, g_p = _assemble(cam_Tcw, points, prob, active, cam_params,
                                                inv_sigma2_levels, use_kernel, damping, red)
        free = (prob.cam_free & prob.cam_valid).float()
        cam_of = prob.edge_cam.long()
        A = torch.zeros(P * C, 18, device=dev)
        for sl, pt in rows:
            key = (torch.arange(P, device=dev) if pt is None else pt) * C + cam_of[sl]
            A[key] = A[key] + Y[sl].reshape(-1, 18)
        A3 = A.reshape(P, C * 6, 3)
        A2 = A3.permute(1, 0, 2).reshape(C * 6, P * 3)                 # (6C, 3P)
        G2 = torch.bmm(A3, Hpp_inv).permute(1, 0, 2).reshape(C * 6, P * 3)  # A Hpp^-1
        S = -red.ranks(G2 @ A2.T)
        hg = torch.einsum("pij,pj->pi", Hpp_inv, g_p)
        corr = red.ranks(A2 @ hg.reshape(-1))
        idx = torch.arange(C, device=dev)
        S4 = S.reshape(C, 6, C, 6)
        S4[idx, :, idx, :] += Hcc_d
        m = free.repeat_interleave(6)
        S = S * m[:, None] * m[None, :] + torch.diag(1.0 - m)
        rhs = -(g_c - corr.reshape(C, 6)) * free[:, None]
        dc = torch.linalg.solve_ex(S, rhs.reshape(-1)).result.reshape(C, 6) * free[:, None]
        atdc = (A2.T @ dc.reshape(-1)).reshape(P, 3)
        dp = -torch.einsum("pij,pj->pi", Hpp_inv, g_p + atdc)
        return exp_se3(dc) @ cam_Tcw, points + torch.where(prob.point_valid[:, None], dp, 0.0)

    return step


def solve_grouped(gp: GroupedGBA, cam, inv_sigma2_levels, n_iters: int = 10,
                  cg_iters: int = 50, damping: float = 1e-5, stop_check=None):
    """The two-phase LM schedule on the grouped layout. Returns (cam_Tcw,
    points, inlier per storage slot), or None when `stop_check` stopped it
    (global_ba.solve_lm)."""
    return solve_lm(gp.prob, cam, inv_sigma2_levels, n_iters, cg_iters, damping,
                    layout_reducer(gp), stop_check)


def global_bundle_adjustment_grouped(prob: BAProblem, cam, inv_sigma2_levels,
                                     n_iters: int = 10, cg_iters: int = 50,
                                     damping: float = 1e-5, kp_cap: int = 32,
                                     kc_cap: int = 1024):
    """API-compatible with optim.global_ba.global_bundle_adjustment:
    returns (cam_Tcw, points, edge_inlier (E,) bool)."""
    gp = group_global_problem(prob, kp_cap, kc_cap)
    cam_Tcw, points, inl = solve_grouped(gp, cam, inv_sigma2_levels, n_iters, cg_iters, damping)
    return cam_Tcw, points, prob.edge_valid & inl[gp.edge_slot]
