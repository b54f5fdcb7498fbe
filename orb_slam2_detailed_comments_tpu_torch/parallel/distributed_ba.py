"""Edge-sharded global bundle adjustment over torch.distributed ranks.

Counterpart of orb_slam2_detailed_comments_tpu/parallel/distributed_ba.py
(beyond the reference, which has no distributed runtime: SURVEY.md
section 2.3). The observations (edges) are padded to a multiple of the
rank count and split by rank; cameras and points are replicated. Each
rank linearizes its edges, and the per-camera and per-point sums are
all-reduced (parallel/multihost.Mesh.sum), as JAX psums them:

  per GN iteration : Hcc, Hpp, g_c, g_p, the rhs correction A Hpp^-1 g_p,
                     the back-substitution's A^T dc
  per PCG matvec   : A^T x and A (Hpp^-1 A^T x)

The schedule is the JAX function's: n_iters Gauss-Newton steps, the
robust kernel on the first half, all valid edges throughout, no LM gate
and no renormalization at the end (optim/global_ba.solve_lm, the
single-device schedule, differs on all three). The GN step is the
single-device one (optim/global_ba._gba_iteration) with a reducer that
sums over the ranks; its sums are the flat solver's one-hot products,
(P, E / ranks) floats a rank, so it is for maps the flat solver takes
(under FLAT_GBA_MAX_EDGES edges a rank) and for checks, as in the JAX
package, where the grouped solver is the production path.
"""
from __future__ import annotations

import numpy as np
import torch

from ..optim.global_ba import Reducer, _gba_iteration, flat_reducer
from ..optim.local_ba import BAProblem
from .multihost import Mesh, global_ba_mesh, make_global_array

AXIS = "edge"
_EDGE_FIELDS = ("edge_cam", "edge_point", "edge_obs", "edge_octave", "edge_valid")


def make_ba_mesh(device="cuda") -> Mesh:
    return global_ba_mesh(AXIS, device)


def distributed_global_ba(prob: BAProblem, cam, inv_sigma2_levels, mesh: Mesh,
                          n_iters: int = 10, cg_iters: int = 40, damping: float = 1e-5):
    """Run the edge-sharded global BA on every rank of `mesh`; each rank
    passes the whole problem. Returns (cam_Tcw, points) on every rank, on
    the rank's device."""
    E = int(prob.edge_cam.shape[0])
    pad = (-E) % mesh.size

    def shard(t):
        a = t.cpu().numpy()
        a = np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])  # invalid edges
        return make_global_array(a, mesh)

    sp = prob._replace(**{f: getattr(prob, f).to(mesh.device) for f in BAProblem._fields
                          if f not in _EDGE_FIELDS},
                       **{f: shard(getattr(prob, f)) for f in _EDGE_FIELDS})
    base = flat_reducer(sp)
    red = Reducer(cam=lambda x: mesh.sum(base.cam(x)), point=lambda x: mesh.sum(base.point(x)))
    inv_s2 = torch.as_tensor(inv_sigma2_levels, dtype=torch.float32).to(mesh.device)
    cam_params = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
    cam_Tcw, points = sp.cam_Tcw, sp.points
    for i in range(n_iters):
        cam_Tcw, points = _gba_iteration(cam_Tcw, points, sp, sp.edge_valid, cam_params, inv_s2,
                                         i < n_iters // 2, damping, cg_iters, red)
    return cam_Tcw, points
