#!/usr/bin/env python
"""Single-device global-BA benchmark: the grouped PCG solve, the grouped
layout's "dense" Schur step and the flat solver, on the KITTI-00..10-batch
problem of examples/bench_scaling.py.

The port's twin of the JAX package's examples/bench_gba.py, on the same
problem (bench_scaling.build_problem: the same numpy draws). Each solver
runs --iters GN iterations of --cg CG steps once to warm up, then once
between CUDA events; a row is its ms per GN iteration. The flat solver
sums with (P, E) one-hot products, and "dense" holds the coupling of every
point with every camera (P x C x 18 floats, four copies): a solver whose
tensors would not fit the card's free memory is reported skipped with the
gigabytes it needs, not run.

Usage:
  python -m orb_slam2_detailed_comments_tpu_torch.examples.bench_gba \\
      [--cams 1408] [--points 60000] [--obs-per-cam 256] [--iters 2] [--cg 30]
      [--skip-flat] [--skip-dense] [--device cuda]

Prints one JSON line a solver.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):   # run as a script path: the repository root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from orb_slam2_detailed_comments_tpu_torch.examples._driver import (  # noqa: E402
    add_device_argument, check_device, timed_ms)


def free_bytes(device) -> float:
    """Bytes a solver may still allocate on `device` (the CPU: unbounded)."""
    import torch
    if torch.device(device).type != "cuda":
        return float("inf")
    free, _ = torch.cuda.mem_get_info(torch.device(device))
    return float(free)


def run(cams=1408, points=60000, obs_per_cam=256, iters=2, cg=30, skip_flat=False,
        skip_dense=False, device="cuda"):
    """One row a solver: {"solver", "ms_per_gn_iter"} or {"solver",
    "skipped"}."""
    import torch
    from orb_slam2_detailed_comments_tpu_torch.examples.bench_scaling import (
        CAM, INV_S2, build_problem)
    from orb_slam2_detailed_comments_tpu_torch.geometry.camera import PinholeCamera
    from orb_slam2_detailed_comments_tpu_torch.optim.global_ba import (
        global_bundle_adjustment, solve_lm)
    from orb_slam2_detailed_comments_tpu_torch.optim.global_ba_grouped import (
        dense_step, group_global_problem, layout_reducer, solve_grouped)

    cam = PinholeCamera(**CAM)
    inv_s2 = torch.from_numpy(INV_S2).to(device)
    prob = build_problem(cams, points, obs_per_cam, device=device)
    E = int(prob.edge_cam.shape[0])
    print(f"# {cams} cams, {points} pts, {E} edges, {iters} GN x {cg} CG", file=sys.stderr)
    t0 = time.perf_counter()
    gp = group_global_problem(prob)
    print(f"# grouping (host): {1e3 * (time.perf_counter() - t0):.0f} ms, layout "
          f"{tuple(gp.shape)}", file=sys.stderr, flush=True)

    solvers = [("grouped-gemm", 0.0, lambda: solve_grouped(gp, cam, inv_s2, iters, cg))]
    if not skip_dense:
        solvers.append(("grouped-dense", 4.0 * points * cams * 18 * 4,
                        lambda: solve_lm(gp.prob, cam, inv_s2, iters, cg, 1e-5,
                                         layout_reducer(gp), step=dense_step(gp))))
    if not skip_flat:
        solvers.append(("flat", 4.0 * (points + cams) * E,
                        lambda: global_bundle_adjustment(prob, cam, inv_s2, n_iters=iters,
                                                         cg_iters=cg)))
    rows = []
    for name, need, fn in solvers:
        if need > free_bytes(device):
            row = {"solver": name, "skipped": f"needs about {need / 1e9:.1f} GB, "
                                              f"{free_bytes(device) / 1e9:.1f} GB free"}
        else:
            row = {"solver": name, "ms_per_gn_iter": round(timed_ms(fn, device, 1) / iters, 3)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cams", type=int, default=1408)
    ap.add_argument("--points", type=int, default=60000)
    ap.add_argument("--obs-per-cam", type=int, default=256)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--cg", type=int, default=30)
    ap.add_argument("--skip-flat", action="store_true")
    ap.add_argument("--skip-dense", action="store_true")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    run(args.cams, args.points, args.obs_per_cam, args.iters, args.cg, args.skip_flat,
        args.skip_dense, check_device(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
