#!/usr/bin/env python3
"""A saved local-BA problem solved by the port on several devices and in
several edge orders: is a solve's outcome a property of the problem, of
the device, or of the order of its sums?

    python3 tools/ba_problem_devices.py FILE ... [--devices cuda cpu]
                                        [--orders 3]

FILE is a problem saved by `tools/circuit_trace.py --dump-ba` (the
problem, its window and the result the run merged). For each device it
runs optim/local_ba.local_bundle_adjustment on the problem as saved and
with its valid edges in `--orders` seeded random orders (the same
function up to the order of its sums), and prints for each solve the
window's largest free-keyframe move from the start, the edges kept as
inliers, and the largest keyframe-centre distance from the saved result.
`python tests/torch_parity.py ba_problem FILE` solves the same file with
the JAX package on the CPU.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def solve(path, device, order_seed=None):
    """(largest free-keyframe move in m, inliers, centres of the free
    keyframes, their centres in the saved result) of one solve of the
    saved problem."""
    import torch
    from orb_slam2_detailed_comments_tpu_torch.geometry.camera import PinholeCamera
    from orb_slam2_detailed_comments_tpu_torch.optim import local_ba as TB

    d = np.load(path)
    fields = {k[len("prob_"):]: d[k] for k in d.files if k.startswith("prob_")}
    E = int(d["E"])
    if order_seed is not None:
        perm = np.concatenate([np.random.default_rng(order_seed).permutation(E),
                               np.arange(E, fields["edge_cam"].shape[0])])
        for k in ("edge_cam", "edge_point", "edge_obs", "edge_octave", "edge_valid"):
            fields[k] = fields[k][perm]
    prob = TB.BAProblem(**{k: torch.from_numpy(v).to(device) for k, v in fields.items()})
    fx, fy, cx, cy, bf, w, h = d["camera"]
    cam = PinholeCamera(fx=fx, fy=fy, cx=cx, cy=cy, bf=bf, width=int(w), height=int(h))
    cams, _, inl = TB.local_bundle_adjustment(prob, cam,
                                              torch.from_numpy(d["inv_sigma2"]).to(device))
    free = np.nonzero(d["cam_free"][:len(d["cams"])])[0]

    def centres(T):
        T = np.asarray(T, np.float64)[free]
        return -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])
    c = centres(cams.cpu().numpy())
    move = np.linalg.norm(c - centres(fields["cam_Tcw"]), axis=1).max()
    return move, int(inl.cpu().numpy().sum()), c, centres(d["new_cams"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("files", nargs="+")
    ap.add_argument("--devices", nargs="+", default=["cuda", "cpu"])
    ap.add_argument("--orders", type=int, default=3)
    args = ap.parse_args(argv)
    for path in args.files:
        d = np.load(path)
        print(f"{path}: {len(d['cams'])} cameras, {int(d['cam_free'].sum())} free, "
              f"{int(d['E'])} edges", flush=True)
        for device in args.devices:
            for seed in [None] + list(range(args.orders)):
                move, inl, c, saved = solve(path, device, seed)
                print(f"  {device} {'as saved' if seed is None else f'order {seed}'}: largest "
                      f"keyframe move {move:.4f} m, inliers {inl}, "
                      f"{np.linalg.norm(c - saved, axis=1).max():.4f} m from the run's",
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
