#!/usr/bin/env python3
"""End-to-end System loop of the PyTorch port on the card, sync or async.

The port's twin of examples/bench_e2e.py: the whole System (tracking,
local mapping, loop closing and the global BA after a loop) sustained over
a rendered loop, the camera on a circle of half the radius inside a
CylinderWorld of radius 50 m, looking outward, at KITTI stereo geometry
(1241x376, 2000 features; th_depth 60, 1024 keyframes). The frames are
rendered to uint8 in host memory before the run (pinned on a card) and
are not timed; everything else is. Each frame's images are copied to the
card one frame ahead on a copy stream, which the tracking stream waits for
through an event (the JAX benchmark's double buffer, the camera-DMA analog).

A frame's latency is the host clock around System.track_stereo, ended by
the tracking stream's synchronize(): a device-wide synchronize would also
wait for the mapping worker's and the global-BA thread's streams and hide
the overlap that async mode is for. The first WARMUP frames are left out
of the statistics, as the JAX benchmark does. After the last frame the run
drains (System.shutdown: the worker's queue and a running global BA) and
then reads the map, the loops and the exported trajectory's ATE against
the rendered ground truth.

    python3 tools/bench_e2e.py [--frames 265] [--laps 1] [--overlap 31] [--async]
                               [--progress 50] [--json PATH]

prints one JSON object: examples/bench_e2e.py's fields, plus the largest
frame time, the frames that saw a loop closed with their times, each
loop-closing call of the LoopCloser (its keyframe, ms and stages) and the
exported ATE just before and after its correction (the global BA's merge
comes later; read from copies taken in the call and computed after the
run, so the call's time holds no evaluation), the exported trajectory's
RMS error per 50-frame window, the mapper's
n_processed (keyframes the mapping worker finished; in sync mode every
keyframe, mapped inline), n_ba_aborted, n_ba_stale and n_kf_deferred, the
frames after which a keyframe still waited in the worker's queue (how far
the worker lags; 0 in sync mode), the global-BA
runner's n_completed and n_aborted, the exported ATE, the drain's seconds
and the card. It needs a CUDA card unless run_e2e is given device="cpu".
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import multiprocessing
import os
import sys
import time
import types
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

WARMUP = 60           # frames left out of the statistics, as the JAX benchmark's
FPS_BUDGET = 10.0     # KITTI stereo's camera rate (BASELINE.md)
GEOMETRY = dict(width=1241, height=376, features=2000)


def _world(radius: float, seed: int):
    from orb_slam2_detailed_comments_tpu_torch.examples._driver import load_synthetic_world
    sw = load_synthetic_world()
    width, height = GEOMETRY["width"], GEOMETRY["height"]
    fx = 180.0 * (width / 320.0)
    return sw, sw.CylinderWorld(fx=fx, fy=fx, cx=width / 2, cy=height / 2, width=width,
                                height=height, radius=radius, texture_seed=seed)


_RENDER_WORLD = None     # a render worker's world (set by its initializer)


def _render_init(radius: float, seed: int):
    global _RENDER_WORLD
    _RENDER_WORLD = _world(radius, seed)[1]


def _render_pair(args):
    """One uint8 (left, right) frame of the world in this process."""
    T, T_rl = args
    return (_RENDER_WORLD.render(T).astype(np.uint8),
            _RENDER_WORLD.render((T_rl @ T).astype(np.float32)).astype(np.uint8))


def render_loop(n_frames: int = 265, laps: float = 1.0, overlap: int = 31,
                radius: float = 50.0, seed: int = 0, workers: int = 0):
    """The run's SlamConfig, ground-truth poses (world -> camera) and uint8
    (left, right) frames. The JAX benchmark's 500 frames, 2 laps and overlap
    30 turn 2*pi/235 rad a frame; 265 frames, 1 lap and overlap 31 turn
    2*pi/234, one lap plus the revisit that closes the loop. `workers` > 1
    renders in that many spawned processes (the same images), which are
    shut down before it returns."""
    from orb_slam2_detailed_comments_tpu_torch.geometry.camera import PinholeCamera
    from orb_slam2_detailed_comments_tpu_torch.utils.config import OrbConfig, SlamConfig
    sw, world = _world(radius, seed)
    width, height = GEOMETRY["width"], GEOMETRY["height"]
    fx = world.fx
    baseline = radius / 100.0 * 1.2
    poses = sw.loop_trajectory(n_frames, path_radius=0.5 * radius, laps=laps, overlap=overlap)
    features = GEOMETRY["features"]
    cfg = SlamConfig(
        camera=PinholeCamera(fx=fx, fy=fx, cx=width / 2, cy=height / 2, width=width,
                             height=height, bf=fx * baseline),
        orb=OrbConfig(n_features=features, max_keypoints=1 << int(np.ceil(np.log2(features + 1)))),
        # 60 baselines (0.72 radius) covers the wall the way KITTI's 35
        # covers its streets (examples/bench_e2e.py)
        fps=10.0, th_depth=60.0, max_keyframes=1024, max_map_points=200000)
    T_rl = np.eye(4, dtype=np.float32)
    T_rl[0, 3] = -baseline
    jobs = [(T, T_rl) for T in poses]
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx,
                                                    initializer=_render_init,
                                                    initargs=(radius, seed)) as pool:
            frames = list(pool.map(_render_pair, jobs, chunksize=8))
    else:
        _render_init(radius, seed)
        frames = [_render_pair(j) for j in jobs]
    return cfg, poses, frames


SEGMENT = 50          # frames per window of exported_errors' breakdown


def trajectory_snapshot(slam):
    """What the exported trajectory is made of, copied (a few hundred KB):
    the tracker's log and the keyframe poses and spanning tree."""
    ms = slam.map
    return list(slam.tracker.trajectory), types.SimpleNamespace(
        kf_valid=ms.kf_valid.copy(), parent=ms.parent.copy(), kf_Tcp=ms.kf_Tcp.copy(),
        kf_Tcw=ms.kf_Tcw.copy())


def exported_errors(snapshot, poses):
    """The exported trajectory of a trajectory_snapshot (every tracked frame
    from its corrected reference keyframe) against the ground truth after
    one rigid alignment: its ATE, its frame count and the RMS error of each
    SEGMENT-frame window (where along the run the error sits)."""
    from orb_slam2_detailed_comments_tpu_torch.evaluation.ate import align_umeyama
    from orb_slam2_detailed_comments_tpu_torch.io.trajectory import recover_frame_trajectory
    rec = recover_frame_trajectory(*snapshot)
    f = np.asarray([i for i, _, _ in rec])
    est = np.asarray([np.linalg.inv(T)[:3, 3] for _, _, T in rec], np.float64)
    gt = np.asarray([np.linalg.inv(poses[i])[:3, 3] for i in f], np.float64)
    _, R, t = align_umeyama(est, gt, with_scale=False)
    err = np.linalg.norm(est @ R.T + t - gt, axis=1)
    windows = {f"{a}-{a + SEGMENT}": round(float(np.sqrt(np.mean(err[(f >= a) & (f < a + SEGMENT)]
                                                                    ** 2))), 4)
               for a in range(0, len(poses), SEGMENT) if ((f >= a) & (f < a + SEGMENT)).any()}
    return float(np.sqrt(np.mean(err ** 2))), len(rec), windows


def run_e2e(n_frames: int = 265, laps: float = 1.0, overlap: int = 31,
            async_mapping: bool = False, device="cuda", progress_every: int = 50,
            scene=None):
    """Drive System(cfg, STEREO) with loop closing and the global BA on over
    the rendered loop. `scene` is render_loop's result, to share one
    rendering between runs. Returns the result dict."""
    import torch
    from orb_slam2_detailed_comments_tpu_torch.frontend.tracking import Sensor
    from orb_slam2_detailed_comments_tpu_torch.system import System
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_e2e needs a CUDA card (or device='cpu')")
    cfg, poses, frames = scene if scene is not None else render_loop(n_frames, laps, overlap)
    n_frames = len(frames)
    slam = System(cfg, Sensor.STEREO, enable_loop_closing=True, enable_global_ba_on_loop=True,
                  async_mapping=async_mapping, device=dev)
    on_card = dev.type == "cuda"
    if on_card:
        frames = [tuple(torch.from_numpy(a).pin_memory() for a in fr) for fr in frames]
        track_stream, copy_stream = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    else:
        track_stream = copy_stream = None

    def stage(fr):
        """Start frame `fr`'s copy to the card; returns its images and the
        event that marks the copy done."""
        if not on_card:
            return fr, None
        with torch.cuda.stream(copy_stream):
            imgs = tuple(a.to(dev, non_blocking=True) for a in fr)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return imgs, done

    lc = slam.loop_closer
    closing = []     # (keyframe, ms, {stage: ms}) of each loop-closing call
    corrections = []  # (keyframe, trajectory snapshots before and after) each loop correction
    on_kf, correct = lc.on_new_keyframe, lc._correct_loop

    def measured_correct(kf, *a):
        # the snapshots are copies; their ATEs are computed after the run
        before = trajectory_snapshot(slam)
        out = correct(kf, *a)
        corrections.append((int(kf), before, trajectory_snapshot(slam)))
        return out

    def timed_on_kf(kf):
        seen = {k: len(v) for k, v in lc.timer.samples.items()}
        t0 = time.perf_counter()
        closed = on_kf(kf)
        if closed:
            closing.append((int(kf), round(1e3 * (time.perf_counter() - t0), 3), {
                k: round(1e3 * sum(v[seen.get(k, 0):]), 3) for k, v in lc.timer.samples.items()
                if len(v) > seen.get(k, 0)}))
        return closed

    lc.on_new_keyframe = timed_on_kf      # both run on the thread that maps, under the map lock
    lc._correct_loop = measured_correct
    lat, loop_frames = [], []
    n_ok = n_waiting = 0
    queue_len = getattr(slam.local_mapper, "queue_len", lambda: 0)
    t_run = time.perf_counter()
    nxt = stage(frames[0])
    with torch.cuda.stream(track_stream) if on_card else contextlib.nullcontext():
        for i in range(n_frames):
            (left, right), done = nxt
            t0 = time.perf_counter()
            if on_card:
                track_stream.wait_event(done)
                for a in (left, right):     # made on the copy stream, read on this one
                    a.record_stream(track_stream)
            nxt = stage(frames[i + 1]) if i + 1 < n_frames else None
            n_loops = lc.n_loops_closed
            Tcw = slam.track_stereo(left, right, i / cfg.fps)
            if on_card:
                track_stream.synchronize()
            lat.append(time.perf_counter() - t0)
            n_ok += Tcw is not None and slam.tracking_state.name == "OK"
            n_waiting += queue_len() > 0
            if lc.n_loops_closed > n_loops:
                loop_frames.append((i, round(1e3 * lat[-1], 3)))
            if progress_every and i % progress_every == 0:
                print(f"frame {i}/{n_frames} state={slam.tracking_state.name} "
                      f"kfs={slam.map.n_keyframes()} lat={1e3 * lat[-1]:.1f}ms", flush=True)
    wall = time.perf_counter() - t_run
    t_drain = time.perf_counter()
    slam.shutdown()
    drain = time.perf_counter() - t_drain
    ate, n_exported, windows = exported_errors(trajectory_snapshot(slam), poses)
    loop_ate = [(kf, round(exported_errors(b, poses)[0], 4), round(exported_errors(a, poses)[0], 4))
                for kf, b, a in corrections]

    steady = np.asarray(lat[WARMUP:]) if len(lat) > WARMUP else np.asarray(lat)
    mapper = slam.local_mapper
    trk = slam.tracker
    dm = trk._dev_map
    stages = {name: {k: {"median_ms": round(v["median_ms"], 3), "mean_ms": round(v["mean_ms"], 3),
                         "n": v["count"]} for k, v in timer.summary().items()}
              for name, timer in (("tracker", trk.timer), ("local_mapper", mapper.timer),
                                  ("loop_closer", lc.timer))}
    return {
        "metric": "e2e_stereo_fps_1241x376_2000feat" + ("_async" if async_mapping else ""),
        "value": round(1.0 / float(steady.mean()), 3),
        "unit": "frames/s",
        "vs_baseline": round(1.0 / float(steady.mean()) / FPS_BUDGET, 3),
        "extra": {
            "median_ms": round(1e3 * float(np.median(steady)), 3),
            "mean_ms": round(1e3 * float(steady.mean()), 3),
            "p90_ms": round(1e3 * float(np.percentile(steady, 90)), 3),
            "max_ms": round(1e3 * float(steady.max()), 3),
            "frames": n_frames, "warmup_excluded": WARMUP if len(lat) > WARMUP else 0,
            "tracked": n_ok, "tracked_frac": round(n_ok / n_frames, 4),
            "keyframes": int(slam.map.n_keyframes()), "keyframes_allocated": int(slam.map.n_kf),
            "map_points": int(slam.map.n_map_points()),
            "loops_closed": int(lc.n_loops_closed), "loop_frames_ms": loop_frames,
            "loop_calls_ms": closing, "loop_ate_m": loop_ate,
            "ate_m": round(float(ate), 6), "exported_frames": n_exported,
            "error_by_window_m": windows,
            "fused_frames": int(trk.fused_frames), "staged_frames": int(trk.staged_frames),
            "pad_rows_last": int(dm.last_rows_uploaded) if dm else -1,
            "pad_full_uploads": int(dm.full_uploads) if dm else -1,
            "n_processed": int(mapper.n_processed if async_mapping else mapper.kf_counter),
            "n_ba_aborted": int(mapper.n_ba_aborted), "n_ba_stale": int(mapper.n_ba_stale),
            "n_kf_deferred": int(mapper.n_kf_deferred),
            "frames_kf_waiting": int(n_waiting),
            "gba_completed": int(slam.gba_runner.n_completed),
            "gba_aborted": int(slam.gba_runner.n_aborted),
            "stage_ms": stages,
            "wall_s": round(wall, 3), "drain_s": round(drain, 3),
            "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        },
    }


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=265)
    ap.add_argument("--laps", type=float, default=1.0)
    ap.add_argument("--overlap", type=int, default=31)
    ap.add_argument("--async", dest="async_mapping", action="store_true",
                    help="the asynchronous pipeline (System(async_mapping=True))")
    ap.add_argument("--progress", type=int, default=50, help="print every N frames; 0: never")
    ap.add_argument("--json", default="", help="also write the result to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_e2e: no CUDA card", file=sys.stderr)
        return 2
    scene = render_loop(args.frames, args.laps, args.overlap, workers=os.cpu_count() or 1)
    res = run_e2e(async_mapping=args.async_mapping, progress_every=args.progress, scene=scene)
    print(json.dumps(res))
    if args.json:
        Path(args.json).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
