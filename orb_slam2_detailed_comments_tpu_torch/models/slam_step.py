"""The per-frame tracking program: ORB extraction -> (stereo matching) ->
local-map projection matching -> IRLS pose Gauss-Newton.

Counterpart of orb_slam2_detailed_comments_tpu/models/slam_step.py (the
reference's Frame construction -> SearchByProjection -> PoseOptimization
call stack, Tracking.cc:428-790). Each entry point takes tensors on one
device and returns tensors on it; the CUDA kernels of ops/fast_pyramid.py
and ops/orb_desc.py run inside extraction, that of ops/patch_gather.py
inside stereo matching.

`match_to_kp` reproduces the JAX package's duplicate-index scatter as it
behaves under XLA on the CPU (the last write wins), deterministically: a
keypoint takes the highest-numbered point whose best match it is, and
loses its match when that point's match was rejected (ROADMAP fault C.5).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry.camera import PinholeCamera
from ..interop import desc_to_torch
from ..ops import matching as M
from ..ops.orb import Keypoints, extract_orb, extract_orb_batch
from ..ops.stereo import depth_to_stereo, stereo_match
from ..optim.pose_gn import pose_optimization
from ..utils.config import OrbConfig

LOCAL_MP_CAP = 4096


def pack_host_blob(bundle, tcw_stats, visible):
    """Concatenate the per-frame host outputs into ONE flat f32 tensor:
    bundle (N, 10), tcw_stats (21,), visible (P,)."""
    return torch.cat([bundle.reshape(-1), tcw_stats, visible.to(torch.float32)])


def unpack_host_blob(blob, n_kp: int):
    """Split of pack_host_blob: (bundle (N,10), tcw_stats (21,), visible (P,) bool)."""
    b = blob[: n_kp * 10].reshape(n_kp, 10)
    ts = blob[n_kp * 10: n_kp * 10 + 21]
    vis = blob[n_kp * 10 + 21:] > 0.5
    return b, ts, vis


def _level_constants(orb: OrbConfig, device):
    scale_factors = torch.tensor([orb.scale_factor ** i for i in range(orb.n_levels)],
                                 dtype=torch.float32, device=device)
    return scale_factors, 1.0 / (scale_factors ** 2), float(np.log(orb.scale_factor))


def match_to_kp(m: M.MatchResult, n_kp: int):
    """MatchResult over points -> per-keypoint point index (-1 none), with
    the last-write-wins semantics of `.at[idx].set` on the CPU."""
    P = m.idx.shape[0]
    pts = torch.arange(P, device=m.idx.device)
    last = torch.full((n_kp,), -1, dtype=torch.int64, device=m.idx.device)
    last = last.scatter_reduce(0, m.idx.long(), pts, reduce="amax")
    won = (last >= 0) & m.ok[last.clamp(min=0)]
    return torch.where(won, last, -1).to(torch.int32)


def _single_stage(kp, xy_und, ur, Tcw_pred, mp_pos, mp_normal, mp_min_dist,
                  mp_max_dist, mp_desc, mp_valid, orb, cam, check_stereo):
    scale_factors, inv_sigma2, log_scale = _level_constants(orb, xy_und.device)
    proj = M.project_and_cull(
        mp_pos, mp_valid, mp_normal, mp_min_dist, mp_max_dist,
        Tcw_pred, cam, orb.n_levels, log_scale)
    m = M.search_by_projection(
        proj, mp_desc, xy_und, ur, kp.desc, kp.valid, kp.octave, scale_factors,
        th=1.0, max_dist=M.TH_HIGH, ratio=0.8, check_stereo=check_stereo)
    kp_mp = match_to_kp(m, kp.xy.shape[0])
    has = kp_mp >= 0
    pts = mp_pos[torch.where(has, kp_mp, 0).long()]
    obs = torch.cat([xy_und, ur[:, None]], dim=1)
    Tcw, _, n_in = pose_optimization(Tcw_pred, pts, obs, kp.octave, has, cam, inv_sigma2)
    return Tcw, m.idx, m.ok, n_in


def mono_tracking_step(img, Tcw_pred, mp_pos, mp_normal, mp_min_dist,
                       mp_max_dist, mp_desc, mp_valid, orb: OrbConfig,
                       cam: PinholeCamera):
    """Extract features, match the local map by projection, optimize the pose.

    Returns (Tcw, match_idx, match_ok, n_inliers, keypoints)."""
    kp = extract_orb(img, orb)
    xy_und = cam.undistort_pixels(kp.xy)
    ur = torch.full((kp.xy.shape[0],), -1.0, device=img.device)
    Tcw, idx, ok, n_in = _single_stage(
        kp, xy_und, ur, Tcw_pred, mp_pos, mp_normal, mp_min_dist, mp_max_dist,
        mp_desc, mp_valid, orb, cam, check_stereo=False)
    return Tcw, idx, ok, n_in, kp


def stereo_tracking_step(img_l, img_r, Tcw_pred, mp_pos, mp_normal,
                         mp_min_dist, mp_max_dist, mp_desc, mp_valid,
                         orb: OrbConfig, cam: PinholeCamera):
    """The stereo per-frame program (KITTI geometry): batched L/R ORB
    extraction, SAD stereo matching, projection matching with the
    right-coordinate check and (u, v, uR) pose GN.

    Returns (Tcw, match_idx, match_ok, n_inliers, ur, depth, keypoints)."""
    pair = extract_orb_batch(torch.stack([img_l, img_r]), orb)
    kp = Keypoints(*[a[0] for a in pair])
    kp_r = Keypoints(*[a[1] for a in pair])
    ur, depth = stereo_match(kp, kp_r, img_l, img_r, cam, orb)
    xy_und = cam.undistort_pixels(kp.xy)
    Tcw, idx, ok, n_in = _single_stage(
        kp, xy_und, ur, Tcw_pred, mp_pos, mp_normal, mp_min_dist, mp_max_dist,
        mp_desc, mp_valid, orb, cam, check_stereo=True)
    return Tcw, idx, ok, n_in, ur, depth, kp


# ---------------------------------------------------------------------------
# The production frame program: TWO-stage tracking against the local-map
# pad (packed [pos(3), normal(3), min_d, max_d] rows):
#   stage 1: wide projection search at the predicted pose (the reference's
#            last-frame radius th=7 stereo / 15 mono, ratio 0.9) + pose GN,
#   stage 2: tight local-map search at the refined pose + pose GN.
# ---------------------------------------------------------------------------

def _unpack_pad(packed):
    return packed[:, 0:3], packed[:, 3:6], packed[:, 6], packed[:, 7]


def _two_stage_track(kp, xy_und, ur, depth, Tcw_pred, packed, mp_desc,
                     mp_valid, orb, cam, th_depth, th2, check_stereo):
    mp_pos, mp_normal, mp_min, mp_max = _unpack_pad(packed)
    scale_factors, inv_sigma2, log_scale = _level_constants(orb, xy_und.device)
    n_kp = kp.xy.shape[0]
    obs = torch.cat([xy_und, ur[:, None]], dim=1)

    def gn(Tcw0, kp_slot):
        has = kp_slot >= 0
        pts = mp_pos[torch.where(has, kp_slot, 0).long()]
        return pose_optimization(Tcw0, pts, obs, kp.octave, has, cam, inv_sigma2)

    def search(Tcw, th, ratio):
        proj = M.project_and_cull(mp_pos, mp_valid, mp_normal, mp_min, mp_max,
                                  Tcw, cam, orb.n_levels, log_scale)
        m = M.search_by_projection(
            proj, mp_desc, xy_und, ur, kp.desc, kp.valid, kp.octave,
            scale_factors, th=th, max_dist=M.TH_HIGH, ratio=ratio,
            check_stereo=check_stereo)
        return proj, m

    # stage 1: the reference radius th=7 stereo / 15 mono maps to
    # search_by_projection th=radius/4
    th1 = (7.0 if check_stereo else 15.0) / 4.0
    proj1, m1 = search(Tcw_pred, th1, 0.9)
    Tcw1, _, n_in1 = gn(Tcw_pred, match_to_kp(m1, n_kp))

    # stage 2: tight local-map search at the refined pose
    proj2, m2 = search(Tcw1, th2, 0.8)
    kp_slot = match_to_kp(m2, n_kp)
    Tcw2, inliers, n_in2 = gn(Tcw1, kp_slot)

    matched = (kp_slot >= 0) & inliers
    close = kp.valid & (depth > 0) & (depth < th_depth)
    stats = torch.stack([
        n_in2.to(torch.float32),
        torch.sum(matched & close).to(torch.float32),
        torch.sum(close & ~matched).to(torch.float32),
        torch.sum(kp.valid).to(torch.float32),
        n_in1.to(torch.float32),
    ])
    visible = proj1.visible | proj2.visible
    # per-keypoint columns [x, y, ur, depth, response, angle, octave, valid,
    # slot, inlier] + [Tcw(16), stats(5)]; descriptors stay on the device
    bundle = torch.stack([
        xy_und[:, 0], xy_und[:, 1], ur, depth, kp.response, kp.angle,
        kp.octave.to(torch.float32), kp.valid.to(torch.float32),
        kp_slot.to(torch.float32), inliers.to(torch.float32),
    ], dim=-1)
    tcw_stats = torch.cat([Tcw2.reshape(16), stats])
    return bundle, tcw_stats, visible


class Extracted(NamedTuple):
    """A frame's features on the device: the left (or only) image's
    keypoints, their undistorted pixels, and the right coordinate and depth
    of each (-1 where none)."""
    kp: Keypoints
    xy_und: torch.Tensor
    ur: torch.Tensor
    depth: torch.Tensor


def extract_stereo(img_pair, orb: OrbConfig, cam: PinholeCamera, n_features: int = 0) -> Extracted:
    """L/R extraction + SAD stereo matching. img_pair: (2, H, W) stacked L/R
    (uint8 or float). It reads no map, so the asynchronous pipeline's
    tracking thread runs it outside the map lock."""
    img_pair = img_pair.to(torch.float32)
    pair = extract_orb_batch(img_pair, orb, n_features)
    kp = Keypoints(*[a[0] for a in pair])
    kp_r = Keypoints(*[a[1] for a in pair])
    ur, depth = stereo_match(kp, kp_r, img_pair[0], img_pair[1], cam, orb)
    return Extracted(kp, cam.undistort_pixels(kp.xy), ur, depth)


def extract_mono(img, orb: OrbConfig, cam: PinholeCamera, n_features: int = 0) -> Extracted:
    """Monocular extraction (no stereo channel)."""
    kp = extract_orb(img.to(torch.float32), orb, n_features)
    n = kp.xy.shape[0]
    none = torch.full((n,), -1.0, device=img.device)
    return Extracted(kp, cam.undistort_pixels(kp.xy), none, none.clone())


def extract_rgbd(img, depth_map, orb: OrbConfig, cam: PinholeCamera) -> Extracted:
    """Extraction + the virtual right coordinate from the depth map
    (Frame::ComputeStereoFromRGBD, Frame.cc:1179)."""
    kp = extract_orb(img.to(torch.float32), orb)
    xy_und = cam.undistort_pixels(kp.xy)
    ur, depth = depth_to_stereo(kp, xy_und, depth_map, cam)
    return Extracted(kp, xy_und, ur, depth)


def track_extracted(f: Extracted, Tcw_pred, packed, mp_desc, mp_valid, orb: OrbConfig,
                    cam: PinholeCamera, th_depth: float, th2: float, check_stereo: bool):
    """Two-stage local-map tracking of extracted features. Returns
    (host_blob (see pack_host_blob), desc (N, 8) int32)."""
    bundle, tcw_stats, visible = _two_stage_track(
        f.kp, f.xy_und, f.ur, f.depth, Tcw_pred, packed, mp_desc, mp_valid, orb, cam,
        th_depth, th2, check_stereo)
    return pack_host_blob(bundle, tcw_stats, visible), f.kp.desc


def fused_stereo_frame(img_pair, Tcw_pred, packed, mp_desc, mp_valid,
                       orb: OrbConfig, cam: PinholeCamera, th_depth: float,
                       th2: float = 1.0):
    """Stereo frame: extract_stereo + two-stage local-map tracking."""
    return track_extracted(extract_stereo(img_pair, orb, cam), Tcw_pred, packed, mp_desc,
                           mp_valid, orb, cam, th_depth, th2, check_stereo=True)


def fused_mono_frame(img, Tcw_pred, packed, mp_desc, mp_valid,
                     orb: OrbConfig, cam: PinholeCamera):
    """Monocular frame (close-point stats are zero). Returns the same
    (host_blob, desc) as fused_stereo_frame."""
    return track_extracted(extract_mono(img, orb, cam), Tcw_pred, packed, mp_desc, mp_valid,
                           orb, cam, th_depth=float("inf"), th2=1.0, check_stereo=False)


def fused_rgbd_frame(img, depth_map, Tcw_pred, packed, mp_desc, mp_valid,
                     orb: OrbConfig, cam: PinholeCamera, th_depth: float,
                     th2: float = 3.0):
    """RGB-D frame: extract_rgbd + two-stage tracking (th2=3 for RGB-D,
    Tracking.cc:1943-1944)."""
    return track_extracted(extract_rgbd(img, depth_map, orb, cam), Tcw_pred, packed, mp_desc,
                           mp_valid, orb, cam, th_depth, th2, check_stereo=True)


# ---------------------------------------------------------------------------
# Synthetic inputs of bench.py, made with numpy from a seed and the port's
# own extractor: a frame (or KITTI-geometry stereo pair) and a local map
# whose descriptors match the frame's keypoints.
# ---------------------------------------------------------------------------

def _squares_image(rng, h, w, n, margin_hi):
    img = np.full((h, w), 40.0, np.float32)
    ys = rng.integers(10, h - margin_hi, n)
    xs = rng.integers(10, w - margin_hi, n)
    for y, x in zip(ys, xs):
        s = rng.integers(3, 10)
        img[y:y + s, x:x + s] = rng.uniform(60, 250)
    return img


def _map_tensors(device, pos, dists, kp, idx):
    normal = pos / np.linalg.norm(pos, axis=-1, keepdims=True)
    kp_oct = kp.octave.cpu().numpy()[idx]
    # scale band consistent with the source keypoint's octave so the
    # predicted level matches (reference: MapPoint::UpdateNormalAndDepth)
    max_dist = dists * (1.2 ** kp_oct)
    min_dist = max_dist / (1.2 ** 7)
    t = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
         for a in (pos, normal, min_dist, max_dist)]
    return t + [kp.desc[torch.from_numpy(idx).to(kp.desc.device)].to(device),
                kp.valid[torch.from_numpy(idx).to(kp.valid.device)].to(device)]


def make_consistent_inputs(seed=0, device="cuda"):
    """bench.py::make_consistent_inputs: a 640x480 frame of squares on a
    flat background, 1000 features, and a LOCAL_MP_CAP-point map placed at
    random depths along the frame's keypoint rays. Returns ((img, Tcw, pos,
    normal, min_dist, max_dist, desc, valid), orb, cam)."""
    rng = np.random.default_rng(seed)
    h, w = 480, 640
    img = _squares_image(rng, h, w, 2500, 12)
    orb = OrbConfig(n_features=1000, max_keypoints=2048)
    cam = PinholeCamera(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=w, height=h)
    img_t = torch.from_numpy(img).to(device)
    kp = extract_orb(img_t, orb)
    kp_xy = kp.xy.cpu().numpy()

    P = LOCAL_MP_CAP
    depth = rng.uniform(4.0, 8.0, P).astype(np.float32)
    idx = rng.integers(0, kp_xy.shape[0], P)
    x3 = (kp_xy[idx, 0] - cam.cx) / cam.fx * depth
    y3 = (kp_xy[idx, 1] - cam.cy) / cam.fy * depth
    pos = np.stack([x3, y3, depth], -1).astype(np.float32)
    dists = np.linalg.norm(pos, axis=-1)
    mp = _map_tensors(device, pos, dists, kp, idx)
    Tcw = torch.eye(4, dtype=torch.float32, device=device)
    return (img_t, Tcw, *mp), orb, cam


def make_stereo_inputs(seed=0, device="cuda"):
    """bench.py::make_stereo_inputs: a KITTI-geometry (1241x376) stereo pair
    whose right image is the left shifted by the disparity of a constant
    19.3 m depth, 2000 features, and a LOCAL_MP_CAP-point map at that depth.
    Returns ((img_l, img_r, Tcw, pos, normal, min_dist, max_dist, desc,
    valid), orb, cam)."""
    rng = np.random.default_rng(seed)
    h, w = 376, 1241                    # KITTI00-02.yaml image geometry
    cam = PinholeCamera(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                        bf=386.1448, width=w, height=h)
    z = 19.3                            # -> ~20 px disparity
    disp = cam.bf / z
    img = _squares_image(rng, h, w, 6000, 14)
    sh = int(round(disp))
    img_r = np.full_like(img, 40.0)
    img_r[:, :w - sh] = img[:, sh:]

    orb = OrbConfig(n_features=2000, max_keypoints=2048)  # KITTI00-02.yaml:37
    img_t = torch.from_numpy(img).to(device)
    kp = extract_orb(img_t, orb)
    kp_xy = kp.xy.cpu().numpy()
    P = LOCAL_MP_CAP
    idx = rng.integers(0, kp_xy.shape[0], P)
    x3 = (kp_xy[idx, 0] - cam.cx) / cam.fx * z
    y3 = (kp_xy[idx, 1] - cam.cy) / cam.fy * z
    pos = np.stack([x3, y3, np.full(P, z)], -1).astype(np.float32)
    dists = np.linalg.norm(pos, axis=-1)
    mp = _map_tensors(device, pos, dists, kp, idx)
    Tcw = torch.eye(4, dtype=torch.float32, device=device)
    return (img_t, torch.from_numpy(img_r).to(device), Tcw, *mp), orb, cam


def example_tracking_args(orb: OrbConfig = None, cam: PinholeCamera = None,
                          height=480, width=640, seed=0, device="cuda"):
    """The JAX package's example_tracking_args, the same numpy draws from
    the seed: a uniform-noise image, the identity pose and a LOCAL_MP_CAP-
    point local map (positions, unit normals, the 0.3x / 3x distance band,
    random descriptors as their int32 bit-view, all valid). Returns (img,
    Tcw, pos, normal, min_dist, max_dist, desc, valid, orb, cam)."""
    orb = orb or OrbConfig()
    cam = cam or PinholeCamera(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                               width=width, height=height)
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    img = t(rng.uniform(0, 255, (height, width)))
    Tcw = torch.eye(4, dtype=torch.float32, device=device)
    P = LOCAL_MP_CAP
    pos = t(rng.uniform([-3, -3, 2], [3, 3, 9], (P, 3)))
    dists = torch.linalg.norm(pos, dim=-1)
    normal = pos / dists[:, None]
    desc = desc_to_torch(rng.integers(0, 2 ** 32, (P, 8), dtype=np.uint32), device)
    return (img, Tcw, pos, normal, 0.3 * dists, 3.0 * dists, desc,
            torch.ones(P, dtype=torch.bool, device=device), orb, cam)
