#!/usr/bin/env python
"""Host-orchestration budget of the tracking pipeline (record/replay).

The port's twin of the JAX package's examples/bench_host.py. The per-frame
host work (Python control flow and numpy in the tracker, the map store and
the local mapper, all C++ in the reference) must stay small next to the
device work, or it becomes the frame budget.

Method: the same 20-frame 640x480 stereo System as the JAX tool (a
CylinderWorld of radius 25 m, the camera on a 12.5 m circle, loop closing
off), driven over identical frames. A warm-up pass (on a card) builds the
kernels and the library handles. The record pass runs every frame with the
port's device boundaries wrapped, each call's output kept as it was
returned (device tensors cloned on the device, numpy arrays copied), and
times each frame to its torch.cuda.synchronize(). The replay pass runs a
new System over the same frames with each boundary replaced by an in-order
stub that returns the recorded outputs: the device tensors themselves,
still on the device, so the host code downstream takes the same path (its
.cpu() pulls and uploads stay). The pipeline is deterministic, so the
replay follows the record's control path: the call counts per boundary
are asserted equal, and the replayed System's keyframes, map points and
trajectory are compared with the recorded run's. The replay's wall time a
frame is the host orchestration and the data marshalling around the
boundaries; a second replay under torch.profiler counts the CUDA kernels
and the host<->device copies that remain in it (on a card).

The boundaries, patched in the namespace that calls them:
  frontend/tracking.py    extract_mono, extract_stereo, extract_rgbd,
                          track_extracted (models/slam_step.py),
                          pose_optimization, initialize_two_view
  ops/matching.py         match_descriptors, search_for_initialization,
                          project_and_cull, search_by_projection,
                          search_for_triangulation (every caller goes
                          through the module)
  backend/local_mapping.py  local_bundle_adjustment, and the global BA's
                          global_bundle_adjustment and solve_grouped
  frontend/device_map.py  DeviceLocalMap._upload (the local map's delta)
A boundary called inside another (a matcher inside a matcher) runs as is
in the record pass and is not recorded: the outer replay stands for it.

Usage:
  python -m orb_slam2_detailed_comments_tpu_torch.examples.bench_host \\
      [--frames 20] [--width 640] [--height 480] [--features 1000] [--device cuda]

Prints one JSON line; `value` is the host ms a frame.
"""
from __future__ import annotations

import argparse
import importlib
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

PKG = "orb_slam2_detailed_comments_tpu_torch"
BOUNDARIES = [
    # (module path, attribute)
    (f"{PKG}.frontend.tracking", "extract_mono"),
    (f"{PKG}.frontend.tracking", "extract_stereo"),
    (f"{PKG}.frontend.tracking", "extract_rgbd"),
    (f"{PKG}.frontend.tracking", "track_extracted"),
    (f"{PKG}.frontend.tracking", "pose_optimization"),
    (f"{PKG}.frontend.tracking", "initialize_two_view"),
    (f"{PKG}.ops.matching", "match_descriptors"),
    (f"{PKG}.ops.matching", "search_for_initialization"),
    (f"{PKG}.ops.matching", "project_and_cull"),
    (f"{PKG}.ops.matching", "search_by_projection"),
    (f"{PKG}.ops.matching", "search_for_triangulation"),
    (f"{PKG}.backend.local_mapping", "local_bundle_adjustment"),
    (f"{PKG}.backend.local_mapping", "global_bundle_adjustment"),
    (f"{PKG}.backend.local_mapping", "solve_grouped"),
    (f"{PKG}.frontend.device_map", "DeviceLocalMap._upload"),
]


def snapshot(x):
    """x as it is now: tensors cloned (on their device), numpy arrays
    copied, tuples, NamedTuples, lists and dicts rebuilt around the
    snapshots of their items."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, np.ndarray):
        return x.copy()
    if hasattr(x, "_fields"):
        return type(x)(*[snapshot(v) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(snapshot(v) for v in x)
    if isinstance(x, dict):
        return {k: snapshot(v) for k, v in x.items()}
    return x


class Recorder:
    """The record/replay switch of every boundary: `mode` is "off"
    (boundaries run as is), "record" or "replay"; `depth` keeps calls made
    inside a boundary out of the log."""

    def __init__(self):
        self.mode = "off"
        self.depth = 0


class Memo:
    """Record/replay wrapper of one device-boundary function."""

    def __init__(self, fn, rec: Recorder, name: str):
        self.fn = fn
        self.rec = rec
        self.name = name
        self.log = []
        self.cursor = 0

    def __call__(self, *a, **kw):
        rec = self.rec
        if rec.mode == "off" or rec.depth:
            return self.fn(*a, **kw)
        if rec.mode == "record":
            rec.depth += 1
            try:
                out = self.fn(*a, **kw)
            finally:
                rec.depth -= 1
            self.log.append(snapshot(out))
            return out
        if self.cursor >= len(self.log):
            raise AssertionError(f"replay diverged: {self.name} called more than the "
                                 f"{len(self.log)} times recorded")
        out = self.log[self.cursor]
        self.cursor += 1
        return out


def _resolve(mod_name: str, attr: str):
    """(owner, attribute name) of a dotted attribute of a module."""
    owner = importlib.import_module(mod_name)
    *path, name = attr.split(".")
    for p in path:
        owner = getattr(owner, p)
    return owner, name


class patched_boundaries:
    """Context manager: every BOUNDARIES function wrapped in a Memo for
    the block (methods wrapped so they bind as methods), restored after."""

    def __init__(self):
        self.rec = Recorder()
        self.memos = []

    def __enter__(self):
        for mod_name, attr in BOUNDARIES:
            owner, name = _resolve(mod_name, attr)
            fn = owner.__dict__[name]
            memo = Memo(fn, self.rec, attr)
            if isinstance(owner, type):
                def method(self_, *a, _memo=memo, **kw):
                    return _memo(self_, *a, **kw)
                setattr(owner, name, method)
            else:
                setattr(owner, name, memo)
            self.memos.append((owner, name, fn, memo))
        return self

    def __exit__(self, *exc):
        for owner, name, fn, _ in self.memos:
            setattr(owner, name, fn)
        return False

    def start(self, mode: str):
        self.rec.mode = mode
        for *_, memo in self.memos:
            memo.cursor = 0

    def counts(self):
        return {memo.name: len(memo.log) for *_, memo in self.memos}

    def cursors(self):
        return {memo.name: memo.cursor for *_, memo in self.memos}


def map_state(slam):
    """A System's keyframes (valid, poses), map points (valid, positions of
    the valid ones) and exported trajectory (frame ids, poses), as host
    arrays (the replay's map against the record's; chip_smoke.py [19](a)'s
    async run against [10]'s)."""
    from orb_slam2_detailed_comments_tpu_torch.io.trajectory import recover_frame_trajectory
    m = slam.map
    rec = recover_frame_trajectory(slam.tracker.trajectory, m)
    return {"keyframes": (m.kf_valid[:m.n_kf].copy(), m.kf_Tcw[:m.n_kf].copy()),
            "points": (m.mp_valid.copy(), m.mp_pos[m.mp_valid].copy()),
            "trajectory": (np.asarray([f for f, _, _ in rec]),
                           np.asarray([T for _, _, T in rec], np.float32))}


def same_state(a, b):
    """Per part of map_state: whether the two are bit-identical."""
    return {k: all(x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a[k], b[k]))
            for k in a}


def device_activity(fn):
    """fn() under torch.profiler: (CUDA kernels, device-to-host copies,
    host-to-device copies) it made."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    return (sum(1 for n in names if not n.startswith(("Memcpy", "Memset"))),
            sum(1 for n in names if n.startswith("Memcpy DtoH")),
            sum(1 for n in names if n.startswith("Memcpy HtoD")))


def scene(n_frames=20, width=640, height=480, features=1000, device="cuda"):
    """The JAX tool's world, frames and System factory: (make_system,
    [(left, right)] float32 frames)."""
    from orb_slam2_detailed_comments_tpu_torch.frontend.tracking import Sensor
    from orb_slam2_detailed_comments_tpu_torch.geometry.camera import PinholeCamera
    from orb_slam2_detailed_comments_tpu_torch.system import System
    from orb_slam2_detailed_comments_tpu_torch.utils.config import OrbConfig, SlamConfig

    sw = load_synthetic_world()
    fx = 180.0 * (width / 320.0)
    radius, baseline = 25.0, 0.3
    world = sw.CylinderWorld(fx=fx, fy=fx, cx=width / 2, cy=height / 2, width=width,
                             height=height, radius=radius)
    poses = sw.loop_trajectory(300, path_radius=0.5 * radius, laps=2.0, overlap=18)[:n_frames]
    kp_cap = 1 << int(np.ceil(np.log2(features + 1)))

    def make_system():
        cfg = SlamConfig(
            camera=PinholeCamera(fx=fx, fy=fx, cx=width / 2, cy=height / 2, width=width,
                                 height=height, bf=fx * baseline),
            orb=OrbConfig(n_features=features, max_keypoints=kp_cap),
            fps=10.0, th_depth=40.0, max_keyframes=256, max_map_points=120000)
        return System(cfg, Sensor.STEREO, enable_loop_closing=False, device=device)

    Tb = np.eye(4, dtype=np.float32)
    Tb[0, 3] = -baseline
    frames = [(world.render(p), world.render((Tb @ p).astype(np.float32))) for p in poses]
    return make_system, frames


def run(n_frames=20, width=640, height=480, features=1000, device="cuda", warmup=True,
        profile=True):
    """The JSON result (see the module docstring); `extra` also holds the
    recorded ms a frame, the host share, the call counts per boundary,
    whether the replayed map is the recorded one, and what device work
    the replay still made."""
    import torch
    make_system, frames = scene(n_frames, width, height, features, device)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def drive(slam, frame_ms=None):
        for i, (L, R) in enumerate(frames):
            t0 = time.perf_counter()
            slam.track_stereo(L, R, i * 0.1)
            sync()
            if frame_ms is not None:
                frame_ms.append(1e3 * (time.perf_counter() - t0))
        return slam

    if warmup:
        drive(make_system())
    with patched_boundaries() as pb:
        # pass 1: record (the device work runs)
        pb.start("record")
        rec_ms = []
        slam = drive(make_system(), rec_ms)
        n_calls = pb.counts()
        # pass 2: replay (host only), timed
        pb.start("replay")
        slam2 = make_system()
        t0 = time.perf_counter()
        drive(slam2)
        host_s = time.perf_counter() - t0
        diverged = {k: (v, n_calls[k]) for k, v in pb.cursors().items() if v != n_calls[k]}
        if diverged:
            raise AssertionError(f"replay diverged (replayed, recorded calls): {diverged}")
        same = same_state(map_state(slam2), map_state(slam))
        activity = None
        if profile:
            # pass 3: the replay again, under the profiler
            pb.start("replay")
            activity = device_activity(lambda: drive(make_system()))
    host_ms = 1e3 * host_s / n_frames
    rec_total = float(sum(rec_ms))
    extra = {
        "frames": n_frames, "keyframes_processed": int(slam2.map.n_keyframes()),
        "resolution": f"{width}x{height}", "features": features,
        "method": "record/replay, device boundaries stubbed with the recorded device outputs",
        "device": str(device),
        "recorded_ms_per_frame": {"mean": round(rec_total / n_frames, 3),
                                  "median": round(statistics.median(rec_ms), 3)},
        "host_share_of_recorded": round(1e3 * host_s / rec_total, 4),
        "boundary_calls": n_calls,
        "replay_identical": same,
    }
    if activity is not None:
        extra["replay_cuda_kernels"], extra["replay_d2h_copies"], \
            extra["replay_h2d_copies"] = activity
    return {"metric": "tracking_host_orchestration", "value": round(host_ms, 3),
            "unit": "ms/frame", "extra": extra}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--features", type=int, default=1000)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.frames, args.width, args.height, args.features,
                         check_device(args.device))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
