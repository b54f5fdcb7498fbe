"""Shared runner for the per-dataset example drivers.

Mirrors the structure of the reference's example mains (reference:
Examples/Monocular/mono_tum.cc:37-121): construct System from vocabulary +
settings, feed frames at their timestamps, print per-frame latency stats
(median/mean) at exit, save trajectories.

The vocabulary argument accepts a .npz file saved by
``BinaryVocabulary.save`` or ``TreeVocabulary.save``, the reference's
DBoW2 ``ORBvoc.txt`` text format, or ``-`` (the shipped vocabulary).

Every driver takes ``--device`` (default ``cuda``) and hands it to System.
Without a CUDA device the drivers fail unless given ``--device cpu``; they
never fall back to the CPU on their own.

A copy of examples/_driver.py of the JAX package.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from orb_slam2_detailed_comments_tpu_torch.frontend.tracking import Sensor
from orb_slam2_detailed_comments_tpu_torch.system import System


def add_device_argument(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device of the System (default cuda; cpu runs on the host)")


def check_device(device: str) -> str:
    """The device, if it can run here: a CUDA device without one is an error."""
    import torch
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"device {device!r}: no CUDA device is available; "
                         "pass --device cpu to run on the CPU")
    return device


def load_vocabulary(vocab_path: str, device: str = "cuda"):
    """The vocabulary at `vocab_path` (.npz flat or tree, or DBoW2 text), or
    None for "-" or a missing file (System then loads the shipped one)."""
    if not vocab_path or vocab_path == "-" or not os.path.exists(vocab_path):
        return None
    from orb_slam2_detailed_comments_tpu_torch.place.vocabulary_tree import TreeVocabulary
    if vocab_path.endswith(".txt"):
        # the reference's DBoW2 ORBvoc.txt format
        return TreeVocabulary.load_dbow2_text(vocab_path)
    with np.load(vocab_path) as data:
        is_tree = "tree" in data
    if is_tree:
        return TreeVocabulary.load(vocab_path)
    from orb_slam2_detailed_comments_tpu_torch.place.vocabulary import BinaryVocabulary
    return BinaryVocabulary.load(vocab_path, device=device)


def make_system(vocab_path: str, settings_path: str, sensor: Sensor,
                device: str = "cuda") -> System:
    check_device(device)
    return System.from_settings_yaml(settings_path, sensor,
                                     vocabulary=load_vocabulary(vocab_path, device),
                                     device=device)


def track(slam: System, sensor: Sensor, item):
    """Feed one dataset item (ts, image, right image or depth) to System.
    Returns the host seconds of the call: System returns the pose on the
    host, so the call has ended on the device too."""
    t0 = time.perf_counter()
    if sensor == Sensor.RGBD:
        slam.track_rgbd(item[1], item[2], item[0])
    elif sensor == Sensor.STEREO:
        slam.track_stereo(item[1], item[2], item[0])
    else:
        slam.track_monocular(item[1], item[0])
    return time.perf_counter() - t0


def print_times(times) -> None:
    times = sorted(times)
    print("-------")
    print(f"median tracking time: {times[len(times) // 2]:.4f}s")
    print(f"mean tracking time:   {float(np.mean(times)):.4f}s")


def run_sequence(slam: System, dataset, sensor: Sensor, out_prefix: str = "trajectory",
                 pace_to_timestamps: bool = False, viewer=None) -> list:
    """Track every frame of `dataset`; print latency stats; save trajectories.
    Returns the host seconds of each frame's call (`track`).

    ``pace_to_timestamps`` sleeps to replay at sensor rate like the
    reference mains do (mono_tum.cc:100-108); off by default for batch eval.
    ``viewer`` (a viz.stream.StreamingViewer) gets every frame and, forced,
    the last one.
    """
    from orb_slam2_detailed_comments_tpu_torch.utils import counters
    times = []
    n = len(dataset)
    prev_ts = img = None
    for i in range(n):
        item = dataset[i]
        ts = item[0]
        dt = track(slam, sensor, item)
        times.append(dt)
        img = item[1]
        if viewer is not None:
            viewer.update(img, slam.tracker.last_frame)
        if pace_to_timestamps and prev_ts is not None:
            gap = ts - prev_ts
            if dt < gap:
                time.sleep(gap - dt)
        prev_ts = ts
        if i % 50 == 0:
            print(f"frame {i}/{n} state={slam.tracking_state.name} "
                  f"kfs={slam.map.n_keyframes()} mps={slam.map.n_map_points()}")

    if viewer is not None and img is not None:
        viewer.update(img, slam.tracker.last_frame, force=True)
    slam.shutdown()
    if counters.snapshot():
        print("capacity truncations:", counters.snapshot())
    print_times(times)
    slam.save_trajectory_tum(out_prefix + "_tum.txt")
    slam.save_trajectory_kitti(out_prefix + "_kitti.txt")
    slam.save_keyframe_trajectory_tum(out_prefix + "_kf_tum.txt")
    print(f"trajectories written to {out_prefix}_*.txt")
    return times


def sequence_parser(doc: str, *positional: str) -> argparse.ArgumentParser:
    """An argument parser for a per-dataset main: its positional arguments
    and --device."""
    ap = argparse.ArgumentParser(description=doc,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    for name in positional:
        ap.add_argument(name)
    add_device_argument(ap)
    return ap


def load_synthetic_world():
    """tests/synthetic_world.py of this checkout, loaded by path (tests is
    not a package on every machine): the rendered worlds and trajectories
    of the benchmark drivers."""
    import importlib.util
    import sys
    from pathlib import Path
    if "synthetic_world" in sys.modules:
        return sys.modules["synthetic_world"]
    path = Path(__file__).resolve().parents[2] / "tests" / "synthetic_world.py"
    spec = importlib.util.spec_from_file_location("synthetic_world", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.modules["synthetic_world"] = mod
    return mod


def timed_ms(fn, device, reps: int = 5) -> float:
    """Median ms of fn() over `reps` calls after one warm-up call: on a
    CUDA device each call between two CUDA events on the current stream,
    read after a synchronize; on the CPU the host clock."""
    import statistics
    import torch
    fn()
    if torch.device(device).type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)
