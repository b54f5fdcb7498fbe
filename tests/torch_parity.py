"""Shared inputs for the parity tests of the PyTorch port against the JAX
package (tests/test_torch_*.py).

Everything is made with numpy from a seed and handed to both packages.
Images are noise-textured: on the flat backgrounds of bench.py's images,
float32 matmuls that sum in a different order (XLA's vs torch's) move
pyramid pixels by an ulp and flip FAST plateau ties and BRIEF comparisons
of equal samples, which is a property of the inputs, not of the port; the
flat-image case is tested with the JAX package's own pyramid levels
(test_torch_ops.py).
"""
from __future__ import annotations

import contextlib
import os

import numpy as np

# the JAX package's exact modes: gather-form descriptors (its
# specification), the XLA FAST maps and the XLA patch gather
JAX_EXACT_MODES = {"ORB_DESC_ONEHOT": "0", "ORB_FAST_PALLAS": "0", "ORB_PATCH_PALLAS": "0"}


@contextlib.contextmanager
def jax_exact_modes():
    """Set JAX_EXACT_MODES for the block; the jit caches are cleared when
    the environment changes, on the way in and out (the modes are read at
    trace time)."""
    import jax
    old = {k: os.environ.get(k) for k in JAX_EXACT_MODES}
    changed = old != JAX_EXACT_MODES
    os.environ.update(JAX_EXACT_MODES)
    if changed:
        jax.clear_caches()
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if changed:
            jax.clear_caches()


def noise_image(h, w, seed):
    return np.random.default_rng(seed).uniform(0, 255, (h, w)).astype(np.float32)


def squares_image(h, w, seed, n=600):
    """bench.py's kind of image: squares on a flat 40.0 background."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 40.0, np.float32)
    for y, x in zip(rng.integers(10, h - 12, n), rng.integers(10, w - 12, n)):
        s = rng.integers(3, 10)
        img[y:y + s, x:x + s] = rng.uniform(60, 250)
    return img


H, W = 120, 160
DISP = 8            # integer stereo disparity of the small world, px
PAD_SLOTS = 512
N_POINTS = 256


def small_world(seed=0):
    """A 160x120 noise-textured stereo pair (right = left shifted by DISP
    px), its depth map, configs and a 256-point local map built from the
    JAX package's keypoints, packed into a 512-slot pad.

    Returns a dict of numpy arrays and the JAX package's OrbConfig and
    PinholeCamera."""
    import jax.numpy as jnp
    from orb_slam2_detailed_comments_tpu.geometry.camera import PinholeCamera
    from orb_slam2_detailed_comments_tpu.ops.orb import extract_orb
    from orb_slam2_detailed_comments_tpu.utils.config import OrbConfig

    rng = np.random.default_rng(seed)
    cam = PinholeCamera(fx=200.0, fy=200.0, cx=80.0, cy=60.0, bf=40.0, width=W, height=H)
    z = cam.bf / DISP
    wide = noise_image(H, W + DISP, seed + 1)
    img_l, img_r = wide[:, DISP:].copy(), wide[:, :W].copy()
    orb = OrbConfig(n_features=150, max_keypoints=256, n_levels=3)
    with jax_exact_modes():
        kp = extract_orb(jnp.asarray(img_l), orb)
    kp_xy, kp_oct = np.asarray(kp.xy), np.asarray(kp.octave)
    valid_idx = np.nonzero(np.asarray(kp.valid))[0]
    idx = rng.choice(valid_idx, N_POINTS)
    pos = np.stack([(kp_xy[idx, 0] - cam.cx) / cam.fx * z,
                    (kp_xy[idx, 1] - cam.cy) / cam.fy * z,
                    np.full(N_POINTS, z)], -1).astype(np.float32)
    dists = np.linalg.norm(pos, axis=-1)
    max_d = dists * (1.2 ** kp_oct[idx])
    packed = np.zeros((PAD_SLOTS, 8), np.float32)
    packed[:N_POINTS] = np.concatenate(
        [pos, pos / dists[:, None], (max_d / 1.2 ** 7)[:, None], max_d[:, None]], 1)
    desc = np.zeros((PAD_SLOTS, 8), np.uint32)
    desc[:N_POINTS] = np.asarray(kp.desc)[idx]
    valid = np.zeros(PAD_SLOTS, bool)
    valid[:N_POINTS] = True
    return dict(img_l=img_l, img_r=img_r, depth=np.full((H, W), z, np.float32),
                packed=packed, desc=desc, valid=valid), orb, cam


def perturbed_pose(delta=(0.01, -0.005, 0.02, 0.002, -0.001, 0.0015)):
    """A predicted pose a few pixels off identity, as float32 numpy (4, 4)."""
    import torch
    from orb_slam2_detailed_comments_tpu_torch.geometry.se3 import exp_se3
    return exp_se3(torch.tensor(delta, dtype=torch.float64)).float().numpy()


def jax_tracker_anchor(sensor):
    """The JAX package's Tracker on chip_smoke.py's rendered full-size
    sequence for `sensor` ("stereo", "rgbd" or "mono"), with the fused path
    on (ORB_FUSED_TRACK=1) in the exact modes: the source of chip_smoke.py's
    JAX_CPU_TRACKER anchors. About 1.5 min and 3 GB per sensor on the CPU."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from orb_slam2_detailed_comments_tpu.frontend.tracking import Sensor, Tracker
    from orb_slam2_detailed_comments_tpu.geometry.camera import PinholeCamera
    from orb_slam2_detailed_comments_tpu.state.map_store import MapStore
    from orb_slam2_detailed_comments_tpu.utils.config import OrbConfig, SlamConfig

    poses, frames = chip_smoke.render_sequence(sensor)
    kw = chip_smoke.slam_config_kwargs(sensor)
    cfg = SlamConfig(camera=PinholeCamera(**kw["camera"]), orb=OrbConfig(**kw["orb"]),
                     fps=kw["fps"], th_depth=kw["th_depth"])
    old = os.environ.get("ORB_FUSED_TRACK")
    os.environ["ORB_FUSED_TRACK"] = "1"
    try:
        with jax_exact_modes():
            tracker = Tracker(cfg, MapStore(cfg), {"stereo": Sensor.STEREO, "rgbd": Sensor.RGBD,
                                                   "mono": Sensor.MONOCULAR}[sensor])
            res = chip_smoke.drive_tracker(tracker, sensor, poses, frames)
    finally:
        if old is None:
            os.environ.pop("ORB_FUSED_TRACK")
        else:
            os.environ["ORB_FUSED_TRACK"] = old
    return {k: res[k] for k in ("tracked", "fused", "keyframes", "ate_m")}


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python tests/torch_parity.py [sensor ...]: print the
    # anchors of chip_smoke.py's tracker phases
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    for s in sys.argv[1:] or ["stereo", "rgbd", "mono"]:
        print(s, jax_tracker_anchor(s), f"jax {jax.__version__}", flush=True)
