#!/usr/bin/env python
"""TUM RGB-D driver (reference: Examples/RGB-D/rgbd_tum.cc).

Usage: python -m orb_slam2_detailed_comments_tpu_torch.examples.rgbd_tum \
           path_to_vocabulary path_to_settings path_to_sequence_folder \
           path_to_association [--device DEV]

The association file holds `ts_rgb rgb_path ts_depth depth_path` lines as
produced by the TUM benchmark's associate.py (the reference ships examples
under Examples/RGB-D/associations/). If `-` is given, rgb<->depth pairs are
associated by nearest timestamp internally.
"""
import sys
from pathlib import Path

if __package__ in (None, ""):   # run as a script path: the repository root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from orb_slam2_detailed_comments_tpu_torch.examples._driver import (  # noqa: E402
    make_system, run_sequence, sequence_parser)
from orb_slam2_detailed_comments_tpu_torch.frontend.tracking import Sensor  # noqa: E402
from orb_slam2_detailed_comments_tpu_torch.io.datasets import TumRgbdDataset  # noqa: E402


def main(argv=None):
    a = sequence_parser(__doc__, "vocabulary", "settings", "sequence",
                        "association").parse_args(argv)
    slam = make_system(a.vocabulary, a.settings, Sensor.RGBD, a.device)
    assoc = None if a.association == "-" else a.association
    ds = TumRgbdDataset(a.sequence, associations=assoc,
                        depth_factor=slam.config.depth_map_factor)
    run_sequence(slam, ds, Sensor.RGBD, out_prefix="CameraTrajectory")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
