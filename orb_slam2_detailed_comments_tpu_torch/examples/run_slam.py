#!/usr/bin/env python
"""Unified dataset driver (replaces the reference's per-dataset example
binaries mono_tum / rgbd_tum / stereo_kitti / mono_kitti / mono_euroc /
stereo_euroc, reference: Examples/*/*.cc and CMakeLists.txt:100-129).

Usage (as a module, or as a script path):
  python -m orb_slam2_detailed_comments_tpu_torch.examples.run_slam MODE SETTINGS SEQUENCE [OUT_PREFIX]

  tum-mono | tum-rgbd  SEQUENCE holds rgb.txt, depth.txt, rgb/, depth/ and
                       optionally groundtruth.txt (TUM RGB-D layout)
  kitti-mono | kitti-stereo
                       SEQUENCE holds times.txt, image_0/, image_1/ and
                       optionally poses.txt, or <root>/poses/<nn>.txt beside
                       <root>/sequences/<nn> (KITTI odometry layout)
  euroc-mono | euroc-stereo
                       SEQUENCE is a MAV directory: mav0/cam0/data,
                       mav0/cam1/data, optionally
                       state_groundtruth_estimate0/data.csv (EuRoC layout)

Prints per-frame latency stats at exit like the reference mains
(mono_tum.cc:96-121), writes TUM + KITTI trajectory files, and, when the
sequence ships ground truth, prints the ATE/RPE against it.

euroc-stereo rectifies the raw pairs whenever the settings carry the
LEFT.*/RIGHT.* calibration, as the reference's stereo_euroc does
(stereo_euroc.cc:60-82, :165-166); the JAX package's driver feeds them
unrectified.

Options:
  --device DEV                the System's torch device (default cuda; no
      fallback: without a CUDA device, pass --device cpu).
  --viz DIR [--viz-period S]  stream annotated frame + map PNGs and a
      status.json to DIR during the run — the headless equivalent of the
      reference's live Pangolin viewer (Viewer.cc:76-236). Both images
      are drawn in numpy (no plotting library).
  --localization              run in localization-only mode (frozen map).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):   # run as a script path: the repository root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from orb_slam2_detailed_comments_tpu_torch.examples._driver import (  # noqa: E402
    add_device_argument, check_device, run_sequence)
from orb_slam2_detailed_comments_tpu_torch.frontend.tracking import Sensor  # noqa: E402

MODES = ("tum-mono", "tum-rgbd", "kitti-mono", "kitti-stereo", "euroc-mono", "euroc-stereo")


def open_dataset(mode: str, settings: str, seq: str):
    """(dataset, sensor) of a mode; euroc-stereo's pairs rectified when the
    settings carry the calibration."""
    from orb_slam2_detailed_comments_tpu_torch.io.datasets import (
        EurocDataset, KittiOdometryDataset, RectifiedStereoDataset, TumRgbdDataset)
    if mode.startswith("tum"):
        return TumRgbdDataset(seq), Sensor.RGBD if mode == "tum-rgbd" else Sensor.MONOCULAR
    if mode.startswith("kitti"):
        stereo = mode == "kitti-stereo"
        return (KittiOdometryDataset(seq, stereo=stereo),
                Sensor.STEREO if stereo else Sensor.MONOCULAR)
    stereo = mode == "euroc-stereo"
    ds = EurocDataset(seq, stereo=stereo)
    if stereo:
        from orb_slam2_detailed_comments_tpu_torch.ops.rectify import (
            StereoRectifier, has_rectification)
        from orb_slam2_detailed_comments_tpu_torch.utils.config import load_settings_raw
        raw = load_settings_raw(settings)
        if has_rectification(raw):
            print("rectifying the stereo pairs with the settings' LEFT./RIGHT. calibration")
            ds = RectifiedStereoDataset(ds, StereoRectifier.from_settings(raw))
    return ds, Sensor.STEREO if stereo else Sensor.MONOCULAR


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", choices=MODES)
    ap.add_argument("settings")
    ap.add_argument("sequence")
    ap.add_argument("out", nargs="?", default="trajectory")
    ap.add_argument("--viz", metavar="DIR")
    ap.add_argument("--viz-period", type=float, default=2.0)
    ap.add_argument("--localization", action="store_true")
    add_device_argument(ap)
    return ap.parse_args(argv)


def run(argv=None) -> dict:
    """main's work: returns the run's summary (frames, frames tracked, live
    keyframes and map points, exported frames, host seconds per frame, the
    ground-truth evaluation or None) besides printing it."""
    from orb_slam2_detailed_comments_tpu_torch.evaluation.gt_eval import evaluate_against_gt
    from orb_slam2_detailed_comments_tpu_torch.io.trajectory import recover_frame_trajectory
    from orb_slam2_detailed_comments_tpu_torch.system import System

    args = parse_args(argv)
    device = check_device(args.device)
    ds, sensor = open_dataset(args.mode, args.settings, args.sequence)
    slam = System.from_settings_yaml(args.settings, sensor, device=device)
    if args.localization:
        slam.activate_localization_mode()
    viewer = None
    if args.viz:
        from orb_slam2_detailed_comments_tpu_torch.viz.stream import StreamingViewer
        viewer = StreamingViewer(slam, args.viz, period_s=args.viz_period)
    times = run_sequence(slam, ds, sensor, out_prefix=args.out, viewer=viewer)
    frames = recover_frame_trajectory(slam.tracker.trajectory, slam.map)
    summary = dict(frames=len(ds), tracked=sum(1 for e in slam.tracker.trajectory if not e[4]),
                   keyframes=int(slam.map.n_keyframes()), map_points=int(slam.map.n_map_points()),
                   exported=len(frames), times_s=times, slam=slam)
    print(f"frames tracked {summary['tracked']}/{summary['frames']}, keyframes "
          f"{summary['keyframes']}, map points {summary['map_points']}")

    # auto-ATE/RPE when the dataset ships ground truth (the reference
    # defers this to the external TUM scripts, README.md:192-196)
    summary["gt"] = evaluate_against_gt(args.mode, args.sequence, frames,
                                        mono=sensor == Sensor.MONOCULAR)
    if summary["gt"] is not None:
        print("ground-truth evaluation:", json.dumps(summary["gt"]))
    return summary


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
