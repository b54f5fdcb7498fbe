#!/usr/bin/env python
"""Scaling of the point-sharded global BA over ranks.

Twin of the JAX package's examples/bench_scaling.py. Its problem
(`build_problem`, the same numpy draws): a KITTI-00..10-batch-scale
global BA, 1408 cameras on a long noisy forward path, 60,000 points and
256 monocular observations a camera (360,448 edges), the first two
cameras fixed. It spawns the largest rank count's ranks once
(parallel/multihost.run_ranks); each builds the problem from the seed
once, and each row runs on a process group of the first n ranks (the
JAX tool's mesh over the first n devices) while the others wait. A row
shards the problem (parallel/distributed_ba_grouped.DistributedGroupedGBA),
warms up with a one-iteration solve and then solves it --reps times (at
least once), each solve started by a rendezvous of the row's ranks and
ended by a device sync. A row's time is the median over the solves of the
slowest rank's. Rows are JSON: ranks, process-group backend, solver
("gemm" or "dense"), device, whether the ranks share one card, the point
order, ms per GN iteration, t(1) / (n t(n)), the host ms to shard and lay
out the rank's part, and, against the first row's solution, the largest
camera and point distance, the edges the chi2 inlier gate takes otherwise
(an edge at the gate flips with the float order of the camera sums, and
its point moves with it) and the robust cost. The last line sums up.

--permuted-rows K adds K last rows: one rank on the same problem with its
points relabelled by the permutation of seed 1, 2, ..., K (the solution
mapped back). Each solves the same function in another float order
alone, so their distances are what float order moves, the yardstick for
the other rows' distances.

    python -m orb_slam2_detailed_comments_tpu_torch.examples.bench_scaling \\
        [--ranks 1,2,4] [--backend gloo] [--cams 1408] [--points 60000]
        [--obs-per-cam 256] [--iters 4] [--cg 30] [--reps 3] [--permuted-rows 0]
        [--device cuda]

NCCL wants a card a rank; ranks that share one card need --backend gloo,
which moves every sum through host memory: such times measure no
interconnect, and a row says so ("shared_card"). Not carried over from
the JAX tool: --solver flat (the port's flat solver sums with (P, E)
one-hot products, meant for maps under 4096 edges) and --analytic (XLA's
cost analysis).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

if __package__ in (None, ""):   # run as a script path: the repository root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402

CAM = dict(fx=718.0, fy=718.0, cx=607.0, cy=185.0)
INV_S2 = np.array([1.0 / 1.2 ** (2 * i) for i in range(8)], np.float32)


def problem_arrays(n_cams, n_points, obs_per_cam, seed=0):
    """The JAX tool's build_problem draws, in its order, as numpy arrays
    named as BAProblem's fields: cameras on a long noisy forward path,
    each observing obs_per_cam random points (monocular, 0.5 px of
    noise); the first two cameras fixed, the points perturbed by 5 cm."""
    rng = np.random.default_rng(seed)
    cams = np.tile(np.eye(4, dtype=np.float32), (n_cams, 1, 1))
    cams[:, 0, 3] = -np.cumsum(rng.uniform(0.5, 1.5, n_cams)).astype(np.float32)
    pts = rng.uniform([-50, -10, 5], [50, 10, 80], (n_points, 3)).astype(np.float32)
    E = n_cams * obs_per_cam
    e_cam = np.repeat(np.arange(n_cams, dtype=np.int32), obs_per_cam)
    e_pt = rng.integers(0, n_points, E).astype(np.int32)
    fx, fy, cx, cy = CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"]
    pc = np.einsum("eij,ej->ei", cams[e_cam, :3, :3], pts[e_pt]) + cams[e_cam, :3, 3]
    pc[:, 2] = np.abs(pc[:, 2]) + 1.0
    u = fx * pc[:, 0] / pc[:, 2] + cx + rng.normal(0, 0.5, E)
    v = fy * pc[:, 1] / pc[:, 2] + cy + rng.normal(0, 0.5, E)
    e_obs = np.stack([u, v, np.full(E, -1.0)], -1).astype(np.float32)
    return dict(
        cam_Tcw=cams, cam_free=np.asarray([False, False] + [True] * (n_cams - 2)),
        cam_valid=np.ones(n_cams, bool),
        points=pts + rng.normal(0, 0.05, pts.shape).astype(np.float32),
        point_valid=np.ones(n_points, bool), edge_cam=e_cam, edge_point=e_pt, edge_obs=e_obs,
        edge_octave=np.zeros(E, np.int32), edge_valid=np.ones(E, bool))


def build_problem(n_cams, n_points, obs_per_cam, seed=0, device="cuda"):
    """problem_arrays as a BAProblem on `device`."""
    import torch
    from orb_slam2_detailed_comments_tpu_torch.optim.local_ba import BAProblem
    d = problem_arrays(n_cams, n_points, obs_per_cam, seed)
    return BAProblem(**{k: torch.from_numpy(v).to(device) for k, v in d.items()})


def permute_points(d, seed):
    """problem_arrays' dict `d` with its points relabelled: point i of the
    result is point perm[i] of `d`. Returns (the dict, perm)."""
    perm = np.random.default_rng(seed).permutation(d["points"].shape[0])
    new_id = np.empty_like(perm)
    new_id[perm] = np.arange(perm.size)
    out = dict(d, points=d["points"][perm], point_valid=d["point_valid"][perm],
               edge_point=new_id[d["edge_point"]].astype(np.int32))
    return out, perm


def _rank(device, cfg):
    """One rank of the run: for each row it takes part in, its solve times
    (ms), its host preparation (ms) and, on rank 0, the solution as numpy
    (in the problem's point order); None for a row it sits out."""
    import torch
    import torch.distributed as dist
    from orb_slam2_detailed_comments_tpu_torch.geometry.camera import PinholeCamera
    from orb_slam2_detailed_comments_tpu_torch.optim.local_ba import BAProblem
    from orb_slam2_detailed_comments_tpu_torch.parallel.distributed_ba_grouped import (
        AXIS, DistributedGroupedGBA)
    from orb_slam2_detailed_comments_tpu_torch.parallel.multihost import Mesh
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    rank = dist.get_rank()
    d = problem_arrays(cfg["cams"], cfg["points"], cfg["obs_per_cam"])

    def meet():                       # every rank of the run, on the host
        dist.all_reduce(torch.zeros(1))

    out = []
    for n, seed in cfg["rows"]:
        group = dist.new_group(list(range(n)))
        if rank >= n:
            out.append(None)
            meet()
            continue
        arrays, perm = (d, None) if seed is None else permute_points(d, seed)
        prob = BAProblem(**{k: torch.from_numpy(v).to(device) for k, v in arrays.items()})
        mesh = Mesh(AXIS, device, group)
        t0 = time.perf_counter()
        h = DistributedGroupedGBA(prob, PinholeCamera(**CAM), INV_S2, mesh, cg_iters=cfg["cg"])
        sync()
        prep_ms = 1e3 * (time.perf_counter() - t0)
        h.solve(1)              # warm-up: each kernel and collective of a solve once
        times = []
        for _ in range(cfg["reps"]):
            mesh.any(False)                        # a rendezvous of the row's ranks
            t0 = time.perf_counter()
            sol = h.solve(cfg["iters"])
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
        if rank == 0:
            cams_n, pts_n = sol[0].cpu().numpy(), sol[1].cpu().numpy()
            if perm is not None:
                pts_n = pts_n[np.argsort(perm)]
            sol = (cams_n, pts_n)
        out.append(dict(ms=times, prep_ms=prep_ms, solver=h.backend,
                        solution=sol if rank == 0 else None))
        del prob, h
        meet()
    return out


def scaling_rows(ranks=(1, 2, 4), cams=1408, points=60000, obs_per_cam=256, iters=4, cg=30,
                 reps=3, device="cuda", backend=None, timeout=900.0, permuted=0):
    """One row per rank count (module docstring), then `permuted`
    one-rank rows on permuted points, and each row's solution (cam_Tcw,
    points) as numpy. The first row's is the one the rows' distances are taken
    from, and its time t(1) (the JAX tool's t(1) is its first row's too).
    `timeout` bounds the whole run."""
    import torch
    from orb_slam2_detailed_comments_tpu_torch.geometry.camera import PinholeCamera
    from orb_slam2_detailed_comments_tpu_torch.optim import global_ba as GBA
    from orb_slam2_detailed_comments_tpu_torch.parallel.multihost import run_ranks
    if reps < 1:
        raise ValueError(f"reps={reps}: a row times at least one solve")
    plan = [(n, None) for n in ranks] + [(1, seed) for seed in range(1, permuted + 1)]
    cfg = dict(cams=cams, points=points, obs_per_cam=obs_per_cam, iters=iters, cg=cg, reps=reps,
               rows=plan)
    dev = torch.device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    res = run_ranks(_rank, max(ranks), args=(cfg,), backend=backend, device=device,
                    timeout=timeout)
    prob = build_problem(cams, points, obs_per_cam, device=dev)
    cam = PinholeCamera(**CAM)
    cam_params = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
    inv_s2 = torch.from_numpy(INV_S2).to(dev)

    def judged(sol):         # (inlier edges, robust cost)
        c, x = (torch.from_numpy(a).to(dev) for a in sol)
        return (GBA.inlier_edges(prob, c, x, cam_params, inv_s2).cpu().numpy(),
                float(GBA._robust_cost(c, x, prob, prob.edge_valid, cam_params, inv_s2, True)))

    rows, sols, t1 = [], [], None
    for i, (n, seed) in enumerate(plan):
        part = [r[i] for r in res[:n]]
        ms = statistics.median(max(r["ms"][j] for r in part) for j in range(reps))
        sols.append(part[0]["solution"])
        cams_n, pts_n = sols[-1]
        ref, t1 = sols[0], t1 or ms
        inl, cost = judged(sols[-1])
        if i == 0:
            inl_1, cost_1 = inl, cost
        rows.append({
            "ranks": n, "backend": backend or ("nccl" if dev.type == "cuda" else "gloo"),
            "solver": part[0]["solver"],
            "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
            "shared_card": dev.type == "cuda" and n > cards,
            "point_order": "given" if seed is None else "permuted", "order_seed": seed,
            "ms_per_gn_iter": ms / iters, "scaling_efficiency": t1 / (n * ms),
            "prep_ms": max(r["prep_ms"] for r in part),
            "cam_delta": float(np.abs(cams_n - ref[0]).max()),
            "point_delta": float(np.abs(pts_n - ref[1]).max()),
            "flipped_edges": int((inl != inl_1).sum()), "robust_cost": cost,
            "cost_vs_first": cost / cost_1 - 1})
    return rows, sols


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cams", type=int, default=1408)       # 11 sequences x 128 keyframes
    ap.add_argument("--points", type=int, default=60000)
    ap.add_argument("--obs-per-cam", type=int, default=256)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--cg", type=int, default=30)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ranks", default="1,2,4")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="process-group backend (default: NCCL on the card, Gloo on the CPU)")
    ap.add_argument("--permuted-rows", type=int, default=0,
                    help="add this many one-rank rows on seeded point orders (module docstring)")
    ap.add_argument("--timeout", type=float, default=900.0, help="seconds the run may take")
    from orb_slam2_detailed_comments_tpu_torch.examples._driver import (
        add_device_argument, check_device)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    try:
        ranks = [int(x) for x in args.ranks.split(",")]
    except ValueError:
        raise SystemExit(f"--ranks must be comma-separated ints, got {args.ranks!r}")
    rows, _ = scaling_rows(ranks, args.cams, args.points, args.obs_per_cam, args.iters, args.cg,
                           args.reps, check_device(args.device), args.backend, args.timeout,
                           args.permuted_rows)
    for r in rows:
        print(json.dumps(r))
    last = [r for r in rows if r["point_order"] == "given"][-1]
    print(json.dumps({"metric": "distributed_gba_scaling", "value": last["scaling_efficiency"],
                      "unit": "efficiency_at_max_ranks", "ranks": last["ranks"],
                      "edges": args.cams * args.obs_per_cam, "rows": rows}))
    return rows


if __name__ == "__main__":
    main()
