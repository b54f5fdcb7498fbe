#!/usr/bin/env python
"""Benchmark of the essential-graph optimizer at KITTI-00 keyframe counts.

The port's twin of the JAX package's examples/bench_pose_graph.py, on the
same circle graphs (circle_problem: the same numpy draws): K keyframes on a
50 m circle, Sim3 odometry edges with drift noise, a closing edge and a
covisibility edge every 4 keyframes. Each backend (optim/pose_graph.py:
"dense" factors the (7K, 7K) normal matrix, "banded" factors super-blocks
of the band, "cg" is matrix-free PCG over the spanning tree) runs its
n_iters twice; the second run, between CUDA events, is reported, as the
JAX tool reports its second.

Usage:
  python -m orb_slam2_detailed_comments_tpu_torch.examples.bench_pose_graph \\
      [--cases 256:dense,256:cg,704:cg,704:banded,1408:cg,1408:banded] [--device cuda]

Prints one line a case: ms per GN iteration and the mean translation error
before and after.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

if __package__ in (None, ""):   # run as a script path: the repository root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402

from orb_slam2_detailed_comments_tpu_torch.examples._driver import (  # noqa: E402
    add_device_argument, check_device, timed_ms)

CASES = [(256, "dense"), (256, "cg"), (704, "cg"), (704, "banded"), (1408, "cg"),
         (1408, "banded")]


def _small_sim3(xi):
    """exp_sim3 for small tangents in numpy (Rodrigues for the rotation,
    exp for the scale, V to second order: enough for drift-scale noise)."""
    rho, phi, sigma = xi[:3], xi[3:6], xi[6]
    th = np.linalg.norm(phi)
    Wm = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]], [-phi[1], phi[0], 0]])
    if th < 1e-8:
        R = np.eye(3) + Wm
    else:
        R = np.eye(3) + np.sin(th) / th * Wm + (1 - np.cos(th)) / th ** 2 * (Wm @ Wm)
    V = np.eye(3) + 0.5 * (Wm + sigma * np.eye(3))
    S = np.eye(4)
    S[:3, :3] = np.exp(sigma) * R
    S[:3, 3] = V @ rho
    return S.astype(np.float32)


def circle_arrays(Kn, seed=7, drift=0.01, covis_every=4):
    """The JAX tool's circle_problem draws, in its order: (PoseGraphProblem
    fields as numpy arrays, S_true, S_est)."""
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(Kn) / Kn
    c, s = np.cos(ang), np.sin(ang)
    R_all = np.zeros((Kn, 3, 3))
    R_all[:, 0, 0], R_all[:, 0, 2], R_all[:, 1, 1] = c, s, 1.0
    R_all[:, 2, 0], R_all[:, 2, 2] = -s, c
    C_all = 50.0 * np.stack([np.sin(ang), np.zeros(Kn), 1 - np.cos(ang)], -1)
    S_true = np.tile(np.eye(4), (Kn, 1, 1))
    S_true[:, :3, :3] = R_all
    S_true[:, :3, 3] = -np.einsum("kij,kj->ki", R_all, C_all)
    S_true = S_true.astype(np.float32)
    S_true_inv = np.linalg.inv(S_true.astype(np.float64))

    def rel(i, j):
        return (S_true[j].astype(np.float64) @ S_true_inv[i]).astype(np.float32)

    S_est = [S_true[0]]
    for i in range(1, Kn):
        noise = _small_sim3(np.concatenate([rng.normal(0, drift, 6), [rng.normal(0, drift / 2)]]))
        S_est.append((noise @ rel(i - 1, i) @ S_est[i - 1]).astype(np.float32))
    S_est = np.stack(S_est)
    e_i = list(range(Kn - 1)) + [Kn - 1] + list(range(0, Kn - covis_every, covis_every))
    e_j = list(range(1, Kn)) + [0] + [i + covis_every
                                      for i in range(0, Kn - covis_every, covis_every)]
    E = len(e_i)
    prob = dict(S_init=S_est, vertex_fixed=np.arange(Kn) == 0, vertex_valid=np.ones(Kn, bool),
                edge_i=np.asarray(e_i, np.int32), edge_j=np.asarray(e_j, np.int32),
                edge_Sji=np.stack([rel(i, j) for i, j in zip(e_i, e_j)]),
                edge_valid=np.ones(E, bool), edge_weight=np.ones(E, np.float32))
    return prob, S_true, S_est


def run(Kn, backend, n_iters=10, device="cuda"):
    """(ms per GN iteration, edges, mean |t| error before, after)."""
    from orb_slam2_detailed_comments_tpu_torch.optim.pose_graph import (
        PoseGraphProblem, optimize_pose_graph)
    arrays, S_true, S_est = circle_arrays(Kn)
    prob = PoseGraphProblem(**arrays)
    out = []
    ms = timed_ms(lambda: out.append(optimize_pose_graph(prob, n_iters=n_iters, backend=backend,
                                                         device=device)), device, 1)
    S = out[-1].detach().cpu().numpy()
    err0 = np.linalg.norm(S_est[:, :3, 3] - S_true[:, :3, 3], axis=1).mean()
    err1 = np.linalg.norm(S[:, :3, 3] - S_true[:, :3, 3], axis=1).mean()
    return ms / n_iters, len(arrays["edge_i"]), float(err0), float(err1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cases", default=",".join(f"{k}:{b}" for k, b in CASES))
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = check_device(args.device)
    for case in args.cases.split(","):
        k, backend = case.split(":")
        Kn = int(k)
        ms, E, err0, err1 = run(Kn, backend, 20 if backend == "banded" else 10, device)
        print(f"K={Kn:5d} E={E:5d} backend={backend:6s} {ms:10.3f} ms/GN-iter   "
              f"mean |t| err {err0:.3f} -> {err1:.4f} m ({100.0 * err1 / err0:.2f}% of init)",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
