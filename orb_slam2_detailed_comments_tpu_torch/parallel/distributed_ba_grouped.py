"""Point-sharded global bundle adjustment over the grouped layout.

Counterpart of orb_slam2_detailed_comments_tpu/parallel/
distributed_ba_grouped.py (beyond the reference, which has no distributed
runtime: SURVEY.md section 2.3). The map points are split over the ranks
in degree-balanced shards (`partition_points`); each rank holds its
points with every observation of them, laid out by the single-device
grouped layout (optim/global_ba_grouped.group_global_problem), and the
cameras replicated. So every per-point sum (Hpp, g_p, A^T x) stays on its
rank, and every per-camera sum (Hcc, g_c, A Hpp^-1 A^T x) is the rank's
own followed by one all-reduce of a (C, n) tensor:

  "gemm"  (the port's gather-PCG; C > DENSE_MAX_CAMS): one (C, 6) sum a
          PCG matvec;
  "dense" (optim/global_ba_grouped.dense_step; C <= DENSE_MAX_CAMS): one
          (6C, 6C) sum of the Schur complement a GN step, the same LU solve
          on every rank.

The robust cost LM compares is summed over the ranks too, so every rank
takes the same accept / reject branch and the replicated cameras stay
equal. The solve is the single-device one (optim/global_ba.solve_lm) with
that reducer: a world of one rank is solve_grouped bit for bit. The
points come back in the problem's order on every rank.

Divergences on purpose. Each shard's points are not padded to the TPU's
128 lanes, only to the largest shard. Under a stop check every rank polls
its own and the ranks agree on the flag (Mesh.any), so all stop at the
same poll and one LM schedule runs across the polls; JAX polls on one
process and restarts the schedule per chunk when there are several
(backend/local_mapping.py:205-218 of the JAX package). JAX's bfloat16
one-hot limbs (k_mv) and its XLA cost analysis (analyze) are TPU tools
and not carried over.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ..geometry.se3 import se3_renormalize
from ..optim.global_ba import (Reducer, _gba_iteration, inlier_edges, lm_cost, lm_steps,
                               solve_lm)
from ..optim.global_ba_grouped import (DENSE_MAX_CAMS, dense_step,
                                       group_global_problem, layout_dims, layout_reducer)
from ..optim.local_ba import BAProblem
from .multihost import Mesh, global_ba_mesh

AXIS = "pt"


def make_grouped_mesh(device="cuda") -> Mesh:
    return global_ba_mesh(AXIS, device)


def partition_points(e_point, e_valid, n_points: int, n_shards: int) -> List[np.ndarray]:
    """Degree-balanced point partition: a round robin over the points
    sorted by observation count (descending, stable) keeps the shards' edge
    totals within one largest degree of each other. Returns each shard's
    global point ids, ascending; with one shard, every point in order."""
    deg = np.bincount(np.asarray(e_point)[np.asarray(e_valid)], minlength=n_points)
    order = np.argsort(-deg, kind="stable")
    return [np.sort(order[s::n_shards]) for s in range(n_shards)]


def shard_grouped_problem(prob: BAProblem, n_shards: int, kp_cap: int = 32,
                          kc_cap: int = 1024, shards=None, device=None):
    """Split `prob` into `n_shards` point shards, each laid out by
    group_global_problem at one common shape (the largest of the shards'
    own: JAX's two passes, the first on degrees alone here). Returns
    ([GroupedGBA of each shard in `shards`, all by default], point_map
    (n_shards, Pl) of global point ids, -1 past a shard's points).

    A shard's points are padded to Pl = the largest shard (invalid, at the
    origin); a shard with no observed point gets one invalid placeholder
    edge. Its slot_edge holds global edge ids; its edge_slot is indexed by
    the shard's edges, those of its points in global order."""
    device = prob.points.device if device is None else torch.device(device)
    e_pt = prob.edge_point.cpu().numpy().astype(np.int64)
    e_val = prob.edge_valid.cpu().numpy()
    pts = prob.points.cpu().numpy()
    pval = prob.point_valid.cpu().numpy()
    host = {f: getattr(prob, f).cpu() for f in ("edge_cam", "edge_obs", "edge_octave")}
    cams = {f: getattr(prob, f).to(device) for f in ("cam_Tcw", "cam_free", "cam_valid")}
    Pn = pts.shape[0]
    parts = partition_points(e_pt, e_val, Pn, n_shards)
    Pl = max(1, max(len(p) for p in parts))

    def sub_problem(ids, dev):
        local_of = np.full(Pn, -1, np.int64)
        local_of[ids] = np.arange(len(ids))
        se = np.nonzero(local_of[e_pt] >= 0)[0]
        placeholder = se.size == 0
        if placeholder:
            se = np.zeros(1, np.int64)
        sub_pts = np.zeros((Pl, 3), np.float32)
        sub_pts[:len(ids)] = pts[ids]
        sub_val = np.zeros(Pl, bool)
        sub_val[:len(ids)] = pval[ids]
        sel = torch.from_numpy(se)
        sub = BAProblem(
            **cams, points=torch.from_numpy(sub_pts).to(dev),
            point_valid=torch.from_numpy(sub_val).to(dev),
            edge_point=torch.from_numpy(np.maximum(local_of[e_pt[se]], 0).astype(np.int32)),
            edge_valid=torch.from_numpy(np.zeros(1, bool) if placeholder else e_val[se]),
            **{f: a[sel] for f, a in host.items()})
        return sub, se

    dims = np.max([layout_dims(sub_problem(ids, "cpu")[0], kp_cap, kc_cap)
                   for ids in parts], axis=0)
    out = []
    for s in range(n_shards) if shards is None else shards:
        sub, se = sub_problem(parts[s], device)
        gp = group_global_problem(sub, kp_cap, kc_cap, dims=tuple(int(d) for d in dims))
        ge = gp.slot_edge.cpu().numpy()
        out.append(gp._replace(slot_edge=torch.from_numpy(
            np.where(ge >= 0, se[np.maximum(ge, 0)], -1)).to(device)))
    point_map = np.full((n_shards, Pl), -1, np.int64)
    for s, ids in enumerate(parts):
        point_map[s, :len(ids)] = ids
    return out, point_map


class DistributedGroupedGBA:
    """This rank's part of a point-sharded solve, with the solver's state
    (replicated cameras, the rank's points) kept between calls.

    `solve` runs the whole two-phase LM schedule (optim/global_ba.solve_lm)
    from the problem's state, polling `stop_check` as a stop poll all ranks
    agree on. The phase pieces, for a caller that drives the schedule
    itself (the JAX handle's interface): `all_valid_activation` and
    `activation` (the chi2 gate at the current state) give a phase's
    active edges, `cost` its starting objective, `run_phase` runs LM
    iterations in place carrying the damping and the cost, and `result`
    gives (renormalized cameras, the points in global order). Chunks of
    run_phase that add up to a phase are that phase op for op."""

    def __init__(self, prob: BAProblem, cam, inv_sigma2_levels, mesh: Mesh,
                 cg_iters: int = 40, damping: float = 1e-5, kp_cap: int = 32,
                 kc_cap: int = 1024, backend: str = "auto"):
        if backend == "auto":
            backend = "dense" if int(prob.cam_Tcw.shape[0]) <= DENSE_MAX_CAMS else "gemm"
        if backend not in ("gemm", "dense"):
            raise ValueError(f"backend {backend!r}: 'gemm', 'dense' or 'auto'")
        self.backend = backend
        self.mesh = mesh
        self.cam = cam
        self.cam_params = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
        self.cg_iters = cg_iters
        self.damping = damping
        dev = mesh.device
        (self.gp,), point_map = shard_grouped_problem(prob, mesh.size, kp_cap, kc_cap,
                                                      shards=[mesh.rank], device=dev)
        self.inv_s2 = torch.as_tensor(inv_sigma2_levels, dtype=torch.float32).to(dev)
        local = layout_reducer(self.gp)
        self.red = Reducer(cam=lambda x: mesh.sum(local.cam(x)), point=local.point,
                           ranks=mesh.sum)
        self.step = dense_step(self.gp) if backend == "dense" else _gba_iteration
        ids = point_map[mesh.rank]
        self._global_ids = torch.from_numpy(ids[ids >= 0]).to(dev)
        self._n_points = int(prob.points.shape[0])
        self.cam_Tcw, self.points = self.gp.prob.cam_Tcw, self.gp.prob.points

    def solve(self, n_iters: int = 10, stop_check=None):
        """The fused schedule from the problem's state: (cam_Tcw, points in
        global order), or None when the ranks agreed to stop."""
        poll = None if stop_check is None else (lambda: self.mesh.any(stop_check()))
        out = solve_lm(self.gp.prob, self.cam, self.inv_s2, n_iters, self.cg_iters,
                       self.damping, self.red, poll, self.step)
        if out is None:
            return None
        self.cam_Tcw, self.points = out[0], out[1]
        return self.cam_Tcw, self._gather(self.points)

    def all_valid_activation(self) -> torch.Tensor:
        return self.gp.prob.edge_valid

    def activation(self) -> torch.Tensor:
        return inlier_edges(self.gp.prob, self.cam_Tcw, self.points, self.cam_params, self.inv_s2)

    def cost(self, use_kernel: bool, act) -> torch.Tensor:
        return lm_cost(self.gp.prob, self.cam_Tcw, self.points, act, self.cam_params,
                       self.inv_s2, use_kernel, self.red)

    def run_phase(self, n_iters: int, use_kernel: bool, act, lam, c_cur):
        """n_iters LM iterations in place; returns the carried (lam, c_cur)."""
        lam = torch.as_tensor(lam, dtype=torch.float32).to(self.mesh.device)
        self.cam_Tcw, self.points, lam, c_cur = lm_steps(
            self.gp.prob, self.cam_Tcw, self.points, act, use_kernel, lam, c_cur, n_iters,
            self.cam_params, self.inv_s2, self.cg_iters, self.red, self.step)
        return lam, c_cur

    def result(self):
        return se3_renormalize(self.cam_Tcw), self._gather(self.points)

    def _gather(self, points: torch.Tensor) -> torch.Tensor:
        """Every rank's points at their global ids: each rank writes its own
        into zeros and the ranks sum (shards are disjoint, so the sum is a
        copy; all_reduce, which Gloo also runs on CUDA tensors)."""
        out = torch.zeros(self._n_points, 3, dtype=points.dtype, device=points.device)
        out[self._global_ids] = points[:self._global_ids.shape[0]]
        return self.mesh.sum(out)


def distributed_global_ba_grouped(prob: BAProblem, cam, inv_sigma2_levels, mesh: Mesh,
                                  n_iters: int = 10, cg_iters: int = 40,
                                  damping: float = 1e-5, kp_cap: int = 32,
                                  kc_cap: int = 1024, backend: str = "auto",
                                  stop_check: Optional[Callable] = None):
    """The point-sharded solve on every rank of `mesh` (each rank passes the
    whole problem): (cam_Tcw (C,4,4), points (P,3)) in `prob`'s point order
    on the rank's device, or None when `stop_check` stopped it.
    backend="auto": "dense" at C <= DENSE_MAX_CAMS (one collective a GN
    step), "gemm" beyond (one small collective a PCG matvec)."""
    h = DistributedGroupedGBA(prob, cam, inv_sigma2_levels, mesh, cg_iters, damping,
                              kp_cap, kc_cap, backend)
    return h.solve(n_iters, stop_check)
