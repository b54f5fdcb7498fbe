#!/usr/bin/env python
"""EuRoC stereo driver (reference: Examples/Stereo/stereo_euroc.cc).

Usage: python -m orb_slam2_detailed_comments_tpu_torch.examples.stereo_euroc \
           path_to_vocabulary path_to_settings path_to_cam0_folder \
           path_to_cam1_folder path_to_times_file [--device DEV]

Raw (unrectified) cam0/cam1 pairs are rectified on the fly when the settings
file carries the LEFT.*/RIGHT.* calibration blocks, mirroring the
reference's map construction + per-frame cv::remap
(stereo_euroc.cc:60-82, :165-166).
"""
import sys
from pathlib import Path

if __package__ in (None, ""):   # run as a script path: the repository root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from orb_slam2_detailed_comments_tpu_torch.examples._driver import (  # noqa: E402
    make_system, run_sequence, sequence_parser)
from orb_slam2_detailed_comments_tpu_torch.frontend.tracking import Sensor  # noqa: E402
from orb_slam2_detailed_comments_tpu_torch.io.datasets import (  # noqa: E402
    EurocDataset, RectifiedStereoDataset)
from orb_slam2_detailed_comments_tpu_torch.ops.rectify import (  # noqa: E402
    StereoRectifier, has_rectification)
from orb_slam2_detailed_comments_tpu_torch.utils.config import load_settings_raw  # noqa: E402


def main(argv=None):
    a = sequence_parser(__doc__, "vocabulary", "settings", "cam0", "cam1",
                        "times").parse_args(argv)
    slam = make_system(a.vocabulary, a.settings, Sensor.STEREO, a.device)
    ds = EurocDataset(cam0_dir=a.cam0, cam1_dir=a.cam1, timestamps_file=a.times, stereo=True)
    raw = load_settings_raw(a.settings)
    if has_rectification(raw):
        ds = RectifiedStereoDataset(ds, StereoRectifier.from_settings(raw))
    run_sequence(slam, ds, Sensor.STEREO, out_prefix="CameraTrajectory")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
