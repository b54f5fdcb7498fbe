#!/usr/bin/env python
"""ROS stereo node (reference: Examples/ROS/ORB_SLAM2/src/ros_stereo.cc).

Usage: python -m orb_slam2_detailed_comments_tpu_torch.examples.ros_stereo \
           path_to_vocabulary path_to_settings do_rectify [--device DEV]
``do_rectify`` in {true,false}: true builds rectification maps from the
LEFT.*/RIGHT.* calibration in the settings file (ros_stereo.cc:71-110).
"""
import sys
from pathlib import Path

if __package__ in (None, ""):   # run as a script path: the repository root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from orb_slam2_detailed_comments_tpu_torch.examples._driver import (  # noqa: E402
    make_system, sequence_parser)
from orb_slam2_detailed_comments_tpu_torch.frontend.tracking import Sensor  # noqa: E402
from orb_slam2_detailed_comments_tpu_torch.integrations.ros import StereoNode  # noqa: E402


def main(argv=None):
    a = sequence_parser(__doc__, "vocabulary", "settings", "do_rectify").parse_args(argv)
    slam = make_system(a.vocabulary, a.settings, Sensor.STEREO, a.device)
    node = StereoNode.from_settings_yaml(slam, a.settings,
                                         do_rectify=a.do_rectify.lower() == "true")
    node.run()
    slam.save_trajectory_tum("CameraTrajectory.txt")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
