"""Entry points of the port: its twins of the JAX package's
__graft_entry__.py.

entry(device)                   -> (fn, example_args): the fused monocular
                                   frame on the packed local-map pad.
dryrun_multichip(n, device,     -> runs the sharded global BA on n ranks on
                 backend)          a tiny problem (4 cameras, 64 points) and
                                   fails unless each sharded solve agrees with
                                   the single-device one.

    python -m orb_slam2_detailed_comments_tpu_torch.graft_entry [--device cpu]
"""
from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

# the sharded solves' largest distance from the single-device one on the
# dry run's problem (the JAX dry run's limit: one GN step, other reduction
# orders and, for "dense", an exact inner solve)
DRYRUN_TOL = 1e-2


def entry(device="cuda"):
    """The fused monocular frame (models/slam_step.fused_mono_frame) and its
    example arguments (example_tracking_args) with the local map packed as
    [pos, normal, min_d, max_d], as the tracker's pad holds it."""
    from .models.slam_step import example_tracking_args, fused_mono_frame
    img, Tcw, pos, normal, mind, maxd, desc, valid, orb, cam = example_tracking_args(device=device)
    packed = torch.cat([pos, normal, mind[:, None], maxd[:, None]], dim=1)
    fn = functools.partial(fused_mono_frame, orb=orb, cam=cam)
    return fn, (img, Tcw, packed, desc, valid)


def dryrun_problem(device):
    """The JAX dry run's problem: 4 cameras 0.3 m apart on x, the first two
    fixed, 64 points 4-8 m ahead seen by every camera (exact monocular
    observations), the points perturbed by 1 cm; numpy from seed 0."""
    from .optim.local_ba import BAProblem
    rng = np.random.default_rng(0)
    C, P = 4, 64
    pts = rng.uniform([-2, -2, 4], [2, 2, 8], (P, 3)).astype(np.float32)
    cams = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    cams[:, 0, 3] = -0.3 * np.arange(C)
    pc = np.einsum("cij,pj->cpi", cams[:, :3, :3], pts) + cams[:, None, :3, 3]
    u = 500 * pc[..., 0] / pc[..., 2] + 320
    v = 500 * pc[..., 1] / pc[..., 2] + 240
    E = C * P
    obs = np.stack([u.ravel(), v.ravel(), np.full(E, -1.0)], -1).astype(np.float32)
    noisy = pts + rng.normal(0, 0.01, pts.shape).astype(np.float32)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    return BAProblem(
        cam_Tcw=t(cams, torch.float32), cam_free=t([False, False] + [True] * (C - 2), torch.bool),
        cam_valid=t(np.ones(C, bool), torch.bool), points=t(noisy, torch.float32),
        point_valid=t(np.ones(P, bool), torch.bool),
        edge_cam=t(np.repeat(np.arange(C), P), torch.int32),
        edge_point=t(np.tile(np.arange(P), C), torch.int32), edge_obs=t(obs, torch.float32),
        edge_octave=t(np.zeros(E), torch.int32), edge_valid=t(np.ones(E, bool), torch.bool))


def _dryrun_rank(device):
    """One rank of the dry run: the grouped solve ("gemm" and "dense") and
    the flat edge-sharded one, each against the single-device flat solve.
    Returns {solve: (largest camera delta, largest point delta)}."""
    from .geometry.camera import PinholeCamera
    from .optim.global_ba import global_bundle_adjustment
    from .parallel.distributed_ba import distributed_global_ba, make_ba_mesh
    from .parallel.distributed_ba_grouped import (distributed_global_ba_grouped,
                                                  make_grouped_mesh)
    prob = dryrun_problem(device)
    cam = PinholeCamera(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
    inv_s2 = torch.tensor([1.0 / (1.2 ** (2 * i)) for i in range(8)], dtype=torch.float32)
    gmesh = make_grouped_mesh(device)
    runs = {
        "grouped-gemm": distributed_global_ba_grouped(prob, cam, inv_s2, gmesh, n_iters=1,
                                                      cg_iters=8, backend="gemm", kp_cap=8,
                                                      kc_cap=8),
        "grouped-dense": distributed_global_ba_grouped(prob, cam, inv_s2, gmesh, n_iters=1,
                                                       backend="dense", kp_cap=8, kc_cap=8),
        "flat-pcg": distributed_global_ba(prob, cam, inv_s2, make_ba_mesh(device), n_iters=1,
                                          cg_iters=8),
    }
    ref = global_bundle_adjustment(prob, cam, inv_s2.to(device), n_iters=1, cg_iters=8)
    out = {}
    for name, (cams, pts) in runs.items():
        dc = float((cams - ref[0]).abs().max())
        dp = float((pts - ref[1]).abs().max())
        if not (dc < DRYRUN_TOL and dp < DRYRUN_TOL):
            raise AssertionError(f"multichip {name} diverged from the single-device solver: "
                                 f"max camera delta {dc:.2e}, max point delta {dp:.2e}")
        out[name] = (dc, dp)
    return out


def dryrun_multichip(n_devices: int, device="cuda", backend=None, timeout: float = 120.0):
    """Run the sharded solves on `n_devices` ranks, spawned as processes
    (parallel/multihost.run_ranks; backend None: NCCL on the card, Gloo on
    the CPU). Raises if a solve diverges from the single-device one, if a
    rank fails, and, without backend="gloo", if there are more ranks than
    cards. Returns rank 0's {solve: (camera delta, point delta)}."""
    from .parallel.multihost import run_ranks
    return run_ranks(_dryrun_rank, n_devices, backend=backend, device=device,
                     timeout=timeout)[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from .models.slam_step import unpack_host_blob
    fn, ex = entry(args.device)
    blob, desc = fn(*ex)
    _, tcw_stats, _ = unpack_host_blob(blob, desc.shape[0])
    print("entry OK: blob", tuple(blob.shape), "desc", tuple(desc.shape),
          "inliers", int(tcw_stats[16]))
    print("dryrun_multichip(1):", dryrun_multichip(1, args.device,
                                                   "gloo" if args.device == "cpu" else None))


if __name__ == "__main__":
    main()
