#!/usr/bin/env python
"""EuRoC monocular driver (reference: Examples/Monocular/mono_euroc.cc).

Usage: python -m orb_slam2_detailed_comments_tpu_torch.examples.mono_euroc \
           path_to_vocabulary path_to_settings path_to_image_folder \
           path_to_times_file [--device DEV]
"""
import sys
from pathlib import Path

if __package__ in (None, ""):   # run as a script path: the repository root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from orb_slam2_detailed_comments_tpu_torch.examples._driver import (  # noqa: E402
    make_system, run_sequence, sequence_parser)
from orb_slam2_detailed_comments_tpu_torch.frontend.tracking import Sensor  # noqa: E402
from orb_slam2_detailed_comments_tpu_torch.io.datasets import EurocDataset  # noqa: E402


def main(argv=None):
    a = sequence_parser(__doc__, "vocabulary", "settings", "images", "times").parse_args(argv)
    slam = make_system(a.vocabulary, a.settings, Sensor.MONOCULAR, a.device)
    ds = EurocDataset(cam0_dir=a.images, timestamps_file=a.times, stereo=False)
    run_sequence(slam, ds, Sensor.MONOCULAR, out_prefix="KeyFrameTrajectory")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
