#!/usr/bin/env python
"""ROS monocular node (reference: Examples/ROS/ORB_SLAM2/src/ros_mono.cc).

Usage: python -m orb_slam2_detailed_comments_tpu_torch.examples.ros_mono \
           path_to_vocabulary path_to_settings [--device DEV]
Requires a ROS1 environment (rospy); the node logic itself is testable
without one (tests/test_torch_viz_ros.py).
"""
import sys
from pathlib import Path

if __package__ in (None, ""):   # run as a script path: the repository root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from orb_slam2_detailed_comments_tpu_torch.examples._driver import (  # noqa: E402
    make_system, sequence_parser)
from orb_slam2_detailed_comments_tpu_torch.frontend.tracking import Sensor  # noqa: E402
from orb_slam2_detailed_comments_tpu_torch.integrations.ros import MonoNode  # noqa: E402


def main(argv=None):
    a = sequence_parser(__doc__, "vocabulary", "settings").parse_args(argv)
    slam = make_system(a.vocabulary, a.settings, Sensor.MONOCULAR, a.device)
    MonoNode(slam).run()
    slam.save_keyframe_trajectory_tum("KeyFrameTrajectory.txt")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
