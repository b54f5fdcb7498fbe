#!/usr/bin/env python
"""ROS monocular AR node (reference: Examples/ROS/ORB_SLAM2/src/AR/ros_mono_ar.cc).

Usage: python -m orb_slam2_detailed_comments_tpu_torch.examples.ros_mono_ar \
           path_to_vocabulary path_to_settings [out_dir] [--device DEV]
Headless equivalent of ViewerAR: tracks the camera, fits a scene plane to
the tracked map points once tracking is stable, anchors a virtual cube and
writes cube-overlaid frames to ``out_dir`` (default ./ar_frames) as PNGs
(io/png.py).
"""
import os
import sys
from pathlib import Path

if __package__ in (None, ""):   # run as a script path: the repository root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from orb_slam2_detailed_comments_tpu_torch.examples._driver import (  # noqa: E402
    make_system, sequence_parser)
from orb_slam2_detailed_comments_tpu_torch.frontend.tracking import Sensor  # noqa: E402
from orb_slam2_detailed_comments_tpu_torch.integrations.ros import MonoARNode  # noqa: E402
from orb_slam2_detailed_comments_tpu_torch.io.png import write_png  # noqa: E402


def main(argv=None):
    ap = sequence_parser(__doc__, "vocabulary", "settings")
    ap.add_argument("out_dir", nargs="?", default="ar_frames")
    a = ap.parse_args(argv)
    os.makedirs(a.out_dir, exist_ok=True)
    slam = make_system(a.vocabulary, a.settings, Sensor.MONOCULAR, a.device)

    counter = {"i": 0}

    def on_frame(frame_rgb, ts):
        if node.cube is None and counter["i"] > 30:
            node.insert_cube()
        write_png(os.path.join(a.out_dir, f"{counter['i']:06d}.png"), frame_rgb)
        counter["i"] += 1

    node = MonoARNode(slam, on_frame=on_frame)
    node.run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
