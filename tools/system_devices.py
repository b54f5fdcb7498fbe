#!/usr/bin/env python3
"""The port's System phase of chip_smoke.py on several devices: how far the
same code lands from itself when only the float order changes.

    python3 tools/system_devices.py SENSOR [DEVICE ...] [staged|noise<seed> ...]

For SENSOR ("stereo", "rgbd" or "mono") and each DEVICE (default: cuda
cpu) it builds System(..., enable_loop_closing=False) on that device and
runs chip_smoke.drive_system on chip_smoke.render_sequence(SENSOR), then
prints the live map points after each of the first three keyframes'
local mapping, the counts and ATE the phase is held to, and, per pair of
devices, the largest distance between their positions of one frame.
Each perturbation given (chip_smoke.perturbed_run: the staged path, or
+-1e-3 grey levels of seeded noise on the images) adds a run per device
with the phase so changed; `python tests/torch_parity.py system SENSOR
PERTURBATION ...` reads the JAX package under the same ones. At full
width the CPU device takes a few minutes (the card's host is fine; keep
it off small machines). Prints the card's name and power limit first.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(sensor, devices, perturbs):
    import torch
    from orb_slam2_detailed_comments_tpu_torch.frontend.tracking import Sensor
    from orb_slam2_detailed_comments_tpu_torch.geometry.camera import PinholeCamera
    from orb_slam2_detailed_comments_tpu_torch.system import System
    from orb_slam2_detailed_comments_tpu_torch.utils.config import OrbConfig, SlamConfig

    C = _chip_smoke()
    print(C._smi(), flush=True)
    kw = C.slam_config_kwargs(sensor)
    cfg = SlamConfig(camera=PinholeCamera(**kw["camera"]), orb=OrbConfig(**kw["orb"]),
                     fps=kw["fps"], th_depth=kw["th_depth"])
    positions = {}
    for dev, perturb in ((d, p) for p in [None] + perturbs for d in devices):
        poses, frames, use_fused = C.perturbed_run(sensor, perturb)
        slam = System(cfg, {"stereo": Sensor.STEREO, "rgbd": Sensor.RGBD,
                            "mono": Sensor.MONOCULAR}[sensor], enable_loop_closing=False,
                      device=dev)
        slam.tracker.use_fused = use_fused
        after = []
        mapper = slam.local_mapper.on_new_keyframe

        def counted(kf, run_ba=True, mapper=mapper, slam=slam, after=after):
            mapper(kf, run_ba)
            after.append(slam.map.n_map_points())

        slam.local_mapper.on_new_keyframe = counted
        sync = torch.cuda.synchronize if dev.startswith("cuda") else (lambda: None)
        res = C.drive_system(slam, sensor, poses, frames, sync=sync)
        if perturb is None:
            positions[dev] = res["positions"]
        tag = f"{dev} ({perturb})" if perturb else dev
        print(f"{sensor} on {tag}: map points after the first keyframes' mapping {after[:3]}; "
              f"tracked {res['tracked']}, LOST {res['lost']}, relocalized {res['relocalized']}, "
              f"keyframes {res['keyframes']}, map points {res['map_points']}, "
              f"ATE {1e3 * res['ate_m']:.3f} mm", flush=True)
    for i, a in enumerate(devices):
        for b in devices[i + 1:]:
            pa, pb = positions[a], positions[b]
            if pa.shape == pb.shape:
                print(f"{a} against {b}: positions of one frame at most "
                      f"{np.linalg.norm(pa - pb, axis=1).max():.6f} apart (map units)")


if __name__ == "__main__":
    rest = sys.argv[2:]
    perturbs = [a for a in rest if a == "staged" or a.startswith("noise")]
    main(sys.argv[1], [a for a in rest if a not in perturbs] or ["cuda", "cpu"], perturbs)
