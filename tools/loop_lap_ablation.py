#!/usr/bin/env python3
"""chip_smoke.py's [17] loop lap with the loop correction broken on purpose:
does [17]'s check (chip_smoke.loop_lap_misses) fail a lap whose loop
closing is wrong?

    python3 tools/loop_lap_ablation.py [VARIANT ...]

Each VARIANT drives System(cfg, Sensor.RGBD) with loop closing on around
the lap (chip_smoke.drive_loop_lap, on the card), with its LoopCloser so
changed:

    as_is          nothing changed (the control: [17] itself)
    no_correction  _correct_loop skipped: loops are detected and their
                   Sim3 solved, and the drift is left as it is
    no_graph_gba   the essential graph and the global BA skipped: only the
                   current keyframe's covisible group is corrected and fused
    scl_yaw<deg>   S_cl turned by <deg> degrees about the camera's y axis
    scl_shift<m>   S_cl's translation moved <m> metres along the camera's x

Default: all of them, with scl_yaw1, scl_yaw3 and scl_shift0.1. Prints the
card's name and power limit, then per variant the loops closed, live
keyframes and map points, the exported trajectory's ATE and which of [17]'s
anchors it misses, and last the same as one JSON line (ATE unrounded).
About 80 s a variant on an H100.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

DEFAULT = ["as_is", "no_correction", "no_graph_gba", "scl_yaw1", "scl_yaw3", "scl_shift0.1"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _perturbed_sim3(lc, S_delta):
    """Wrap lc._compute_sim3 so that every accepted S_cl is S_delta @ S_cl."""
    compute = lc._compute_sim3

    def perturbed(kf, candidates):
        out = compute(kf, candidates)
        if out is None:
            return None
        loop_kf, S_cl, loop_points = out
        return loop_kf, (S_delta @ np.asarray(S_cl, np.float32)).astype(np.float32), loop_points

    lc._compute_sim3 = perturbed


def break_loop_closer(lc, variant):
    if variant == "as_is":
        return
    if variant == "no_correction":
        lc._correct_loop = lambda *a, **k: None
    elif variant == "no_graph_gba":
        lc._optimize_essential_graph = lambda *a, **k: None
        lc.run_global_ba = False
    elif variant.startswith("scl_yaw"):
        a = np.radians(float(variant[len("scl_yaw"):]))
        S = np.eye(4, dtype=np.float32)
        S[[0, 0, 2, 2], [0, 2, 0, 2]] = [np.cos(a), np.sin(a), -np.sin(a), np.cos(a)]
        _perturbed_sim3(lc, S)
    elif variant.startswith("scl_shift"):
        S = np.eye(4, dtype=np.float32)
        S[0, 3] = float(variant[len("scl_shift"):])
        _perturbed_sim3(lc, S)
    else:
        raise ValueError(f"unknown variant {variant!r}")


def main(variants):
    import torch
    from orb_slam2_detailed_comments_tpu_torch.frontend.tracking import Sensor
    from orb_slam2_detailed_comments_tpu_torch.geometry.camera import PinholeCamera
    from orb_slam2_detailed_comments_tpu_torch.system import System
    from orb_slam2_detailed_comments_tpu_torch.utils.config import OrbConfig, SlamConfig

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    C = _chip_smoke()
    print(C._smi(), flush=True)
    kw = C.loop_lap_config_kwargs()
    cfg = SlamConfig(**{**kw, "camera": PinholeCamera(**kw["camera"]),
                        "orb": OrbConfig(**kw["orb"])})
    poses, frames = C.render_loop_lap()
    ref = C.JAX_CPU_LOOP
    print(f"[17]'s anchor: loops {ref['loops']}, keyframes {ref['keyframes']}, map points "
          f"{ref['map_points']}, ATE {1e3 * ref['ate_m']:.3f} mm, band "
          f"+-{1e3 * max(C.ATE_RTOL * ref['ate_m'], C.LOOP_ATE_ATOL_M):.1f} mm", flush=True)
    out = []
    for variant in variants:
        slam = System(cfg, Sensor.RGBD, enable_loop_closing=True, enable_global_ba_on_loop=True,
                      device="cuda")
        break_loop_closer(slam.loop_closer, variant)
        t0 = time.perf_counter()
        res = C.drive_loop_lap(slam, poses, frames, sync=torch.cuda.synchronize)
        misses = C.loop_lap_misses(res)
        row = {k: res[k] for k in ("tracked", "loops", "keyframes", "allocated", "map_points",
                                   "ate_m", "exported")}
        row.update(variant=variant, misses=misses, s=time.perf_counter() - t0)
        out.append(row)
        print(f"{variant}: tracked {res['tracked']}, loops (frame, keyframe) {res['loops']}, "
              f"keyframes {res['keyframes']} of {res['allocated']}, map points "
              f"{res['map_points']}, exported ATE {1e3 * res['ate_m']:.3f} mm over "
              f"{res['exported']} frames; [17] "
              + ("passes" if not misses else "fails: " + "; ".join(misses))
              + f" ({row['s']:.1f} s)", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or DEFAULT))
