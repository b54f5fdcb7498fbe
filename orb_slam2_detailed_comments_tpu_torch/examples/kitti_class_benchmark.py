#!/usr/bin/env python
"""KITTI-00-class rendered accuracy benchmark (dataset-less fallback).

The port's twin of the JAX package's examples/kitti_class_benchmark.py:
the same rendered street-canyon circuit (a camera on a circle inside a
textured CylinderWorld, several laps so the loop closer must find and
correct the revisit), the same SlamConfig, System with loop closing and
the global BA after a loop on, and the same result dict: the ATE of the
exported trajectory (every frame recomputed from its corrected reference
keyframe) against the exact ground truth, gated as a share of the travel;
for mono the ATE is scale-aligned and each lap's similarity scale is
reported with the lap-to-lap drift; the BoW place-recognition margins.

One key is added, `ms_per_frame`: the median and p90 of the host clock
around each track_* call, ended by torch.cuda.synchronize() on a card (on
the CPU the call's own end). `wall_s` holds the rendering too.

Usage:
  python -m orb_slam2_detailed_comments_tpu_torch.examples.kitti_class_benchmark \\
      [--frames 1000] [--width 640 --height 480] [--features 2000]
      [--radius 50] [--laps 2] [--sensor stereo|rgbd|mono]
      [--trajectory loop|route] [--blackout-at F --blackout-frames N]
      [--json out.json] [--device cuda]

Without a CUDA device it stops unless given --device cpu.
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

from orb_slam2_detailed_comments_tpu_torch.examples._driver import (  # noqa: E402
    add_device_argument, check_device, load_synthetic_world)


def run(n_frames=1000, width=640, height=480, features=2000, radius=50.0,
        laps=2.0, path_ratio=0.5, seed=0, progress=True, sensor="stereo",
        trajectory="loop", blackout_at=-1.0, blackout_frames=30, device="cuda"):
    """The result dict of one circuit (see circuit)."""
    return circuit(n_frames, width, height, features, radius, laps, path_ratio, seed,
                   progress, sensor, trajectory, blackout_at, blackout_frames, device)[0]


def _world(width, height, radius, seed):
    """The street canyon: a textured CylinderWorld of `radius`, fx scaled
    so the angular feature flow matches the 320x240 loop tests that
    validated this world; and the stereo baseline, radius/100 * 1.2 (it
    keeps the close-point threshold sane)."""
    fx = 180.0 * (width / 320.0)
    world = load_synthetic_world().CylinderWorld(fx=fx, fy=fx, cx=width / 2, cy=height / 2,
                                                 width=width, height=height, radius=radius,
                                                 texture_seed=seed)
    return world, radius / 100.0 * 1.2


def circuit_poses(n_frames, radius, laps=2.0, path_ratio=0.5, trajectory="loop"):
    """The true Tcw of every frame: the camera circles at path_ratio *
    radius inside the canyon (laps of it, the last overlapping the first),
    or synthetic_world.route_trajectory's route."""
    sw = load_synthetic_world()
    if trajectory == "route":
        return sw.route_trajectory(n_frames, radius)
    overlap = max(int(n_frames * 0.12 / max(laps, 1.0)), 12)
    return sw.loop_trajectory(n_frames, path_radius=path_ratio * radius, laps=laps,
                              overlap=overlap)


def _frame_images(world, Tcw, sensor, baseline, kidnapped):
    """One frame's images: (left, right) for stereo (the right camera
    offset by the baseline along the camera x-axis: Tcw_r = Tb @ Tcw),
    (image, depth) for RGB-D, (image,) for mono; black (and zero depth)
    while kidnapped."""
    black = np.zeros((world.height, world.width), np.float32)
    if kidnapped:
        return (black, black) if sensor != "mono" else (black,)
    img = world.render(Tcw)
    if sensor == "stereo":
        Tb = np.eye(4, dtype=np.float32)
        Tb[0, 3] = -baseline
        return img, world.render((Tb @ Tcw).astype(np.float32))
    return (img, world.render_depth(Tcw)) if sensor == "rgbd" else (img,)


_RENDER = None      # a render worker's (world, sensor, baseline)


def _render_init(width, height, radius, seed, sensor):
    global _RENDER
    world, baseline = _world(width, height, radius, seed)
    _RENDER = (world, sensor, baseline)


def _render_job(job):
    Tcw, kidnapped = job
    world, sensor, baseline = _RENDER
    return _frame_images(world, Tcw, sensor, baseline, kidnapped)


def render_frames(jobs, width, height, radius, seed, sensor, workers):
    """_frame_images of every (Tcw, kidnapped) job, in order, rendered in
    `workers` spawned processes."""
    import concurrent.futures
    import multiprocessing
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"), initializer=_render_init,
            initargs=(width, height, radius, seed, sensor)) as pool:
        return list(pool.map(_render_job, jobs, chunksize=8))


def circuit(n_frames=1000, width=640, height=480, features=2000, radius=50.0,
            laps=2.0, path_ratio=0.5, seed=0, progress=True, sensor="stereo",
            trajectory="loop", blackout_at=-1.0, blackout_frames=30, device="cuda",
            render_workers=0):
    """Runs the circuit; returns (result dict, the System after shutdown,
    the run's record: each frame's host ms and, for each frame that closed
    a loop, (frame, keyframe, the loop closer's stage ms in that frame)).

    sensor="stereo": the right image is rendered from the baseline-offset
    pose and the stereo matcher runs; "rgbd" takes the rendered depth;
    "mono" runs the monocular pipeline (free-scale Sim3 loops,
    scale-aligned ATE, per-lap scale drift). trajectory="route" is
    synthetic_world.route_trajectory's four-phase exploration route;
    blackout_at (a share of the run) injects `blackout_frames` black frames
    (a kidnap) and the result records whether relocalization recovered.
    Frames are rendered as the run reaches them, or with render_workers
    > 0 all before it in that many spawned processes (the same images)."""
    import torch
    from orb_slam2_detailed_comments_tpu_torch.evaluation.ate import ate_rmse
    from orb_slam2_detailed_comments_tpu_torch.frontend.tracking import Sensor, TrackingState
    from orb_slam2_detailed_comments_tpu_torch.geometry.camera import PinholeCamera
    from orb_slam2_detailed_comments_tpu_torch.io.trajectory import recover_frame_trajectory
    from orb_slam2_detailed_comments_tpu_torch.system import System
    from orb_slam2_detailed_comments_tpu_torch.utils import counters
    from orb_slam2_detailed_comments_tpu_torch.utils.config import OrbConfig, SlamConfig

    world, baseline = _world(width, height, radius, seed)
    fx = world.fx
    poses = circuit_poses(n_frames, radius, laps, path_ratio, trajectory)
    kp_cap = 1 << int(np.ceil(np.log2(features + 1)))
    cfg = SlamConfig(
        camera=PinholeCamera(fx=fx, fy=fx, cx=width / 2, cy=height / 2, width=width,
                             height=height, bf=fx * baseline),
        orb=OrbConfig(n_features=features, max_keypoints=kp_cap),
        fps=10.0, th_depth=40.0, max_keyframes=1024, max_map_points=200000)
    stereo = sensor == "stereo"
    mono = sensor == "mono"
    sen = Sensor.STEREO if stereo else Sensor.MONOCULAR if mono else Sensor.RGBD
    slam = System(cfg, sen, enable_loop_closing=True, enable_global_ba_on_loop=True,
                  device=device)
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    bo_start = int(blackout_at * n_frames) if blackout_at > 0 else -1
    bo_end = bo_start + blackout_frames if bo_start > 0 else -1
    jobs = [(poses[i], bo_start <= i < bo_end) for i in range(n_frames)]
    t_start = time.perf_counter()
    frames = (render_frames(jobs, width, height, radius, seed, sensor, render_workers)
              if render_workers > 0 else None)

    lc = slam.loop_closer
    est, gt, states, frame_ms, loop_frames = [], [], [], [], []
    kfs_live = []            # live keyframes at each loop closure
    reloc_frame = -1         # first OK frame after the blackout
    n_loops_seen = 0
    track = slam.track_stereo if stereo else slam.track_monocular if mono else slam.track_rgbd
    for i in range(n_frames):
        imgs = (frames[i] if frames is not None
                else _frame_images(world, jobs[i][0], sensor, baseline, jobs[i][1]))
        seen = {k: len(v) for k, v in lc.timer.samples.items()}
        t0 = time.perf_counter()
        Tcw = track(*imgs, i * 0.1)
        sync()
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        states.append(slam.tracking_state)
        if lc.n_loops_closed > n_loops_seen:
            n_loops_seen = lc.n_loops_closed
            kfs_live.append((i, int(slam.map.n_keyframes())))
            loop_frames.append((i, int(lc.last_loop_kf), {
                k: 1e3 * sum(v[seen.get(k, 0):]) for k, v in lc.timer.samples.items()
                if len(v) > seen.get(k, 0)}))
        if (reloc_frame < 0 and bo_end > 0 and i >= bo_end
                and slam.tracking_state == TrackingState.OK):
            reloc_frame = i
        if Tcw is not None and slam.tracking_state == TrackingState.OK:
            est.append(np.linalg.inv(Tcw)[:3, 3])
            gt.append(-poses[i, :3, :3].T @ poses[i, :3, 3])
        if progress and i % 50 == 0:
            el = time.perf_counter() - t_start
            print(f"frame {i}/{n_frames} state={slam.tracking_state.name} "
                  f"kfs={slam.map.n_keyframes()} mps={slam.map.n_map_points()} "
                  f"loops={lc.n_loops_closed} [{el:.0f}s]", flush=True)
    slam.shutdown()

    est = np.asarray(est)
    gt = np.asarray(gt)
    travel = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    # ATE on the exported trajectory, the reference's evaluation model
    # (System::SaveTrajectoryTUM recomputes every frame from its corrected
    # reference keyframe, System.cc:476-581)
    rec = recover_frame_trajectory(slam.tracker.trajectory, slam.map)
    est_rec = np.asarray([np.linalg.inv(T)[:3, 3] for _, _, T in rec])
    gt_rec = np.asarray([-poses[f, :3, :3].T @ poses[f, :3, 3] for f, _, _ in rec])
    # mono: the scale is unobservable -> scale-aligned ATE
    ate = float(ate_rmse(est_rec, gt_rec, with_scale=mono))
    ate_live = float(ate_rmse(est, gt, with_scale=mono)) if len(est) else -1.0
    n_ok = sum(1 for s in states if s == TrackingState.OK)
    res = {
        "frames": n_frames, "resolution": f"{width}x{height}",
        "sensor": sensor, "trajectory": trajectory,
        "features": features, "travel_m": round(travel, 2),
        "ate_rmse_m": round(ate, 4),
        "ate_live_m": round(ate_live, 4),
        "ate_pct_travel": round(100.0 * ate / max(travel, 1e-9), 4),
        "tracked_frac": round(n_ok / max(len(states), 1), 4),
        "keyframes": int(slam.map.n_keyframes()),
        "map_points": int(slam.map.n_map_points()),
        "loops_closed": int(lc.n_loops_closed),
        "wall_s": round(time.perf_counter() - t_start, 1),
        "lost_streaks": lost_streaks(states, TrackingState.OK)[:10],
        "kfs_live_at_loops": kfs_live,
        "fused_frames": int(getattr(slam.tracker, "fused_frames", 0)),
        "staged_frames": int(getattr(slam.tracker, "staged_frames", 0)),
        "ms_per_frame": {"median": round(statistics.median(frame_ms), 3),
                         "p90": round(float(np.percentile(frame_ms, 90)), 3)},
    }
    if bo_start > 0:
        res["blackout"] = [bo_start, bo_end]
        res["reloc_recovered"] = reloc_frame >= 0
        res["reloc_latency_frames"] = reloc_frame - bo_end if reloc_frame >= 0 else -1
    if mono:
        res.update(lap_scale_drift(est_rec, gt_rec, [f for f, _, _ in rec], n_frames, laps))
    disc = bow_discrimination(slam, poses)
    if disc is not None:
        res.update(disc)
    if counters.snapshot():
        res["truncations"] = counters.snapshot()
    return res, slam, dict(frame_ms=frame_ms, loop_frames=loop_frames)


def lost_streaks(states, ok):
    """The runs of consecutive frames whose state is not `ok`, as [first,
    last] pairs in frame order."""
    streaks = []
    for i, s in enumerate(states):
        if s == ok:
            continue
        if streaks and i == streaks[-1][1] + 1:
            streaks[-1][1] = i
        else:
            streaks.append([i, i])
    return [(a, b) for a, b in streaks]


def lap_scale_drift(est_rec, gt_rec, rec_frames, n_frames, laps):
    """Per-lap scale drift of a monocular run: each lap's exported segment
    aligned to the ground truth with its own similarity; the lap-to-lap
    ratio of those scales is the drift."""
    from orb_slam2_detailed_comments_tpu_torch.evaluation.ate import align_umeyama
    fpl = n_frames / max(laps, 1.0)
    lap_scales = []
    rec_f = np.asarray(rec_frames)
    for lap in range(int(round(laps))):
        sel = np.nonzero((rec_f >= lap * fpl) & (rec_f < (lap + 1) * fpl))[0]
        if sel.size > 10:
            s, _, _ = align_umeyama(est_rec[sel], gt_rec[sel], True)
            lap_scales.append(round(float(s), 4))
    out = {"lap_scales": lap_scales}
    if len(lap_scales) >= 2:
        out["scale_drift_pct"] = round(100.0 * (lap_scales[-1] / lap_scales[0] - 1.0), 3)
    return out


def bow_discrimination(slam, poses):
    """Place-recognition quality over the run: for each keyframe with a
    true revisit (spatially close, temporally far), its best true-revisit
    BoW score against its best false score (a spatially far keyframe).
    A median margin above 1 means the vocabulary separates revisits from
    perceptual aliasing at this scale."""
    lc = slam.loop_closer
    if lc is None or not lc.kf_bow:
        return None
    mp = slam.map
    kfs = [k for k in lc.kf_bow if mp.kf_valid[k]]
    if len(kfs) < 20:
        return None
    n_frames = len(poses)
    fid = {k: int(mp.kf_frame_id[k]) for k in kfs}
    C = {k: -poses[fid[k], :3, :3].T @ poses[fid[k], :3, 3] for k in kfs}
    ordered = sorted(kfs, key=lambda k: fid[k])
    steps = [np.linalg.norm(C[a] - C[b]) for a, b in zip(ordered[:-1], ordered[1:])]
    step = float(np.median(steps)) if steps else 1.0
    near_th, far_th = 3.0 * step, 10.0 * step
    n_words = lc.voc.n_words
    margins, trues, falses = [], [], []
    for k in kfs:
        ids_k, vals_k = lc.kf_bow[k]
        dense_k = np.zeros(n_words, np.float32)
        dense_k[ids_k] = vals_k
        t_best, f_best, has_true = 0.0, 0.0, False
        for j in kfs:
            if j == k:
                continue
            d = float(np.linalg.norm(C[j] - C[k]))
            sep = abs(fid[j] - fid[k])
            ids_j, vals_j = lc.kf_bow[j]
            s = float(np.minimum(dense_k[ids_j], vals_j).sum())
            if d < near_th and sep > 0.2 * n_frames:
                t_best, has_true = max(t_best, s), True
            elif d > far_th:
                f_best = max(f_best, s)
        if has_true and f_best > 0:
            margins.append(t_best / f_best)
            trues.append(t_best)
            falses.append(f_best)
    if not margins:
        return None
    return {
        "bow_true_revisit_score_median": round(float(np.median(trues)), 4),
        "bow_best_false_score_median": round(float(np.median(falses)), 4),
        "bow_margin_median": round(float(np.median(margins)), 3),
        "bow_margin_p10": round(float(np.percentile(margins, 10)), 3),
        "bow_pairs": len(margins),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--features", type=int, default=2000)
    ap.add_argument("--radius", type=float, default=50.0)
    ap.add_argument("--laps", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sensor", choices=("stereo", "rgbd", "mono"), default="stereo")
    ap.add_argument("--trajectory", choices=("loop", "route"), default="loop")
    ap.add_argument("--blackout-at", type=float, default=-1.0,
                    help="share of the run at which to inject a blackout (kidnap test)")
    ap.add_argument("--blackout-frames", type=int, default=30)
    ap.add_argument("--json", default="")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    res = run(args.frames, args.width, args.height, args.features, args.radius,
              laps=args.laps, seed=args.seed, sensor=args.sensor, trajectory=args.trajectory,
              blackout_at=args.blackout_at, blackout_frames=args.blackout_frames,
              device=check_device(args.device))
    print(json.dumps(res))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
