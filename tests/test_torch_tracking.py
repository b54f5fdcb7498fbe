"""Parity of the port's tracking front end with the JAX package's, on the
CPU: the same numpy inputs through both.

  * DeviceLocalMap.refresh: the same slots, uploaded rows, full re-uploads
    and pad contents over a sequence of refreshes (exact);
  * rotation_consistency, match_descriptors, search_for_initialization:
    the same matches (exact: integer distances, lower index wins ties);
  * initialize_two_view: the same model choice and triangulated set, R
    within 1e-3 rad and the t direction within 1e-3;
  * the whole Tracker per sensor on a 320x240 PlanesWorld sequence with the
    fused path on: per frame the same state, fused/staged path and keyframe
    count, and the pose within 1 mm and 0.01 degrees; after the first
    initialization both map stores hold the same arrays: ids, counts and
    covisibility exact, floats within 1e-3 (as extraction: float32 ulps of
    the pyramid move sub-pixel positions, angles and depths), descriptors
    within extraction's gate (<= 2% of rows differ, by <= 8 bits).

The rendered frames carry seeded sensor noise of +-2 grey levels. On the
texture's exactly flat background, XLA's and torch's pyramid matmuls,
which sum in different orders, give pixels an ulp apart; that flips BRIEF
comparisons of equal samples and, over a sequence, a few matches (without
the noise the two trackers stay within 1 mm on most frames but part by up
to 77 mm on one). With the noise no two samples are equal, and the
trackers agree to a micrometre.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orb_slam2_detailed_comments_tpu.frontend import device_map as JDM, tracking as JT
from orb_slam2_detailed_comments_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_detailed_comments_tpu.ops import matching as JM, orb as JO
from orb_slam2_detailed_comments_tpu.solvers import initializer as JI
from orb_slam2_detailed_comments_tpu.state.map_store import MapStore as JMapStore
from orb_slam2_detailed_comments_tpu.utils.config import OrbConfig as JOrb, SlamConfig as JSlam

from orb_slam2_detailed_comments_tpu_torch.frontend import device_map as TDM, tracking as TT
from orb_slam2_detailed_comments_tpu_torch.interop import (
    config_from_jax, desc_to_numpy, desc_to_torch, map_store_from_jax, slam_config_from_jax)
from orb_slam2_detailed_comments_tpu_torch.ops import matching as TM, orb as TO
from orb_slam2_detailed_comments_tpu_torch.solvers import initializer as TI
from orb_slam2_detailed_comments_tpu_torch.state.map_store import MapStore as TMapStore

from synthetic_world import PlanesWorld, smooth_trajectory
from torch_parity import jax_exact_modes, noise_image

POSE_TOL_M, POSE_TOL_DEG = 1e-3, 0.01
ROT_TOL_RAD, T_DIR_TOL = 1e-3, 1e-3
N_FRAMES = 12
NOISE = 2.0       # grey levels of seeded sensor noise on every rendered frame
BASELINE = 0.12


@pytest.fixture(scope="module", autouse=True)
def _jax_exact_modes():
    with jax_exact_modes():
        yield


def t(a):
    return torch.from_numpy(np.array(a))


# ---- the repairs of the port's entry points -----------------------------------

def test_entry_points_default_to_the_card():
    import inspect
    from orb_slam2_detailed_comments_tpu_torch import interop
    from orb_slam2_detailed_comments_tpu_torch.models import slam_step
    for f in (slam_step.make_consistent_inputs, slam_step.make_stereo_inputs,
              interop.desc_to_torch, interop.state_from_jax, TT.Tracker.__init__,
              TDM.DeviceLocalMap.__init__, TI.initialize_two_view):
        assert inspect.signature(f).parameters["device"].default == "cuda", f.__qualname__
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            desc_to_torch(np.zeros((2, 8), np.uint32))


def test_extract_orb_n_features_matches_jax():
    img = noise_image(120, 160, 11)
    orb = JOrb(n_features=150, max_keypoints=512)
    torb, _ = config_from_jax(orb, JCam(fx=1.0, fy=1.0, cx=0.0, cy=0.0))
    for n_feat in (0, 300):
        kj = JO.extract_orb(jnp.asarray(img), orb, n_feat)
        kt = TO.extract_orb(t(img), torb, n_feat)
        np.testing.assert_array_equal(kt.valid.numpy(), np.asarray(kj.valid))
        np.testing.assert_array_equal(kt.octave.numpy(), np.asarray(kj.octave))
        # descriptors within the gate of test_torch_ops.py::test_extract_orb_matches_jax
        v = np.asarray(kj.valid)
        ham = np.bitwise_count(desc_to_numpy(kt.desc)[v] ^ np.asarray(kj.desc)[v]).sum(-1)
        assert (ham == 0).mean() >= 0.98 and ham.max() <= 8
    assert int(kt.valid.sum()) > 150     # the larger budget was used


# ---- DeviceLocalMap -----------------------------------------------------------

def _fake_map(rng, n):
    return types.SimpleNamespace(
        mp_pos=rng.normal(size=(n, 3)).astype(np.float32),
        mp_normal=rng.normal(size=(n, 3)).astype(np.float32),
        mp_min_dist=rng.uniform(0.1, 1, n).astype(np.float32),
        mp_max_dist=rng.uniform(1, 10, n).astype(np.float32),
        mp_desc=rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32),
        mp_valid=rng.random(n) < 0.95)


def test_device_map_refresh_matches_jax():
    rng = np.random.default_rng(0)
    P, n = 6000, 20000
    ms = _fake_map(rng, n)
    dj, dt = JDM.DeviceLocalMap(P), TDM.DeviceLocalMap(P, device="cpu")
    ids = np.sort(rng.choice(n, 3000, replace=False))
    # per step: (fraction of ids dropped, ids added, points moved); None is
    # a big rewrite (more rows than the last bucket), "reset" the map reset
    churn = [(0.0, 0, 0), (0.0, 10, 5), (0.02, 200, 30), (0.05, 900, 30), None,
             (0.05, 300, 30), "reset"]
    steps = []
    for c in churn:
        if c is None:
            ids = np.sort(rng.choice(n, 5500, replace=False))
        elif c == "reset":
            dj.invalidate()
            dt.invalidate()
        else:
            drop, add, move = c
            ids = np.union1d(ids[rng.random(ids.size) >= drop],
                             rng.choice(n, add, replace=False))[:P]
            ms.mp_pos[rng.choice(ids, move)] += 0.01
            ms.mp_valid[rng.choice(ids, 5)] ^= True
        dj.refresh(ms, ids)
        dt.refresh(ms, ids)
        steps.append(dt.last_rows_uploaded)
        np.testing.assert_array_equal(dt.slot_mp, dj.slot_mp)
        assert (dt.last_rows_uploaded, dt.full_uploads) == (dj.last_rows_uploaded, dj.full_uploads)
        np.testing.assert_array_equal(dt.d_packed.numpy(), np.asarray(dj.d_packed))
        np.testing.assert_array_equal(desc_to_numpy(dt.d_desc), np.asarray(dj.d_desc))
        np.testing.assert_array_equal(dt.d_valid.numpy(), np.asarray(dj.d_valid))
    # every delta bucket, and two full uploads (the rewrite and the reset)
    assert steps[1] < 64 < steps[2] <= 512 < steps[3] <= 4096 < steps[4], steps
    assert dt.full_uploads == 2
    with pytest.raises(ValueError):
        dt.refresh(ms, np.arange(P + 1))


# ---- matchers -------------------------------------------------------------------

def _match_inputs(seed, n_a=300, n_b=350):
    rng = np.random.default_rng(seed)
    desc_b = rng.integers(0, 2 ** 32, (n_b, 8), dtype=np.uint32)
    src = rng.permutation(n_b)[:n_a]
    desc_a = desc_b[src].copy()
    flips = rng.integers(0, 32, (n_a, 3))      # a few bit flips per descriptor
    for j in range(3):
        desc_a[np.arange(n_a), rng.integers(0, 8, n_a)] ^= (np.uint32(1) << flips[:, j].astype(np.uint32))
    desc_a[: n_a // 5] = rng.integers(0, 2 ** 32, (n_a // 5, 8), dtype=np.uint32)
    xy_b = rng.uniform(0, 640, (n_b, 2)).astype(np.float32)
    xy_a = (xy_b[src] + rng.normal(0, 30, (n_a, 2))).astype(np.float32)
    ang_b = rng.uniform(0, 2 * np.pi, n_b).astype(np.float32)
    ang_a = (ang_b[src] + 0.3 + rng.normal(0, 0.05, n_a)).astype(np.float32)
    ang_a[: n_a // 4] = rng.uniform(0, 2 * np.pi, n_a // 4)
    return dict(desc_a=desc_a, desc_b=desc_b, xy_a=xy_a, xy_b=xy_b, ang_a=ang_a, ang_b=ang_b,
                valid_a=rng.random(n_a) < 0.9, valid_b=rng.random(n_b) < 0.9,
                oct_a=rng.integers(0, 2, n_a).astype(np.int32),
                oct_b=rng.integers(0, 2, n_b).astype(np.int32))


def _same_matches(mt, mj):
    ok = np.asarray(mj.ok)
    np.testing.assert_array_equal(mt.ok.numpy(), ok)
    np.testing.assert_array_equal(mt.idx.numpy()[ok], np.asarray(mj.idx)[ok])
    np.testing.assert_array_equal(mt.dist.numpy(), np.asarray(mj.dist))
    return int(ok.sum())


@pytest.mark.parametrize("seed", [0, 1])
def test_rotation_consistency_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-7, 7, 500).astype(np.float32)
    b = rng.uniform(-7, 7, 500).astype(np.float32)
    b[:200] = a[:200] - 0.5       # one dominant bin
    b[200:260] = a[200:260] - 2.0  # a second one; ties among the small bins
    ok = rng.random(500) < 0.8
    got = TM.rotation_consistency(t(a), t(b), t(ok)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JM.rotation_consistency(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(ok))))
    assert 0 < got.sum() < ok.sum()


@pytest.mark.parametrize("seed", [0, 1])
def test_match_descriptors_matches_jax(seed):
    m = _match_inputs(seed)
    mj = JM.match_descriptors(jnp.asarray(m["desc_a"]), jnp.asarray(m["valid_a"]),
                              jnp.asarray(m["desc_b"]), jnp.asarray(m["valid_b"]),
                              angle_a=jnp.asarray(m["ang_a"]), angle_b=jnp.asarray(m["ang_b"]),
                              max_dist=JM.TH_LOW, ratio=0.7)
    mt = TM.match_descriptors(desc_to_torch(m["desc_a"], "cpu"), t(m["valid_a"]),
                              desc_to_torch(m["desc_b"], "cpu"), t(m["valid_b"]),
                              angle_a=t(m["ang_a"]), angle_b=t(m["ang_b"]),
                              max_dist=TM.TH_LOW, ratio=0.7)
    assert _same_matches(mt, mj) > 100


@pytest.mark.parametrize("seed", [0, 1])
def test_search_for_initialization_matches_jax(seed):
    m = _match_inputs(seed)
    args = ("xy_a", "desc_a", "valid_a", "oct_a", "ang_a", "xy_b", "desc_b", "valid_b",
            "oct_b", "ang_b")
    mj = JM.search_for_initialization(*(jnp.asarray(m[k]) for k in args))
    mt = TM.search_for_initialization(*(desc_to_torch(m[k], "cpu") if k.startswith("desc")
                                        else t(m[k]) for k in args))
    assert _same_matches(mt, mj) > 30


# ---- two-view initialization --------------------------------------------------

def _two_view(planar, seed):
    rng = np.random.default_rng(seed)
    K = np.array([[250.0, 0, 160.0], [0, 250.0, 120.0], [0, 0, 1]], np.float32)
    n = 400
    uv1 = rng.uniform([10, 10], [310, 230], (n, 2))
    z = np.full(n, 5.0) if planar else rng.uniform(3.0, 9.0, n)
    X = np.concatenate([(uv1 - K[:2, 2]) / K[0, 0] * z[:, None], z[:, None]], 1)
    w = np.array([0.01, -0.04, 0.02])
    th = np.linalg.norm(w)
    Wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    R = np.eye(3) + np.sin(th) * Wx + (1 - np.cos(th)) * Wx @ Wx
    tvec = np.array([-0.5, 0.05, 0.1])
    Xc = X @ R.T + tvec
    uv2 = Xc[:, :2] / Xc[:, 2:] * K[0, 0] + K[:2, 2]
    uv1 = (uv1 + rng.normal(0, 0.3, uv1.shape)).astype(np.float32)
    uv2 = (uv2 + rng.normal(0, 0.3, uv2.shape)).astype(np.float32)
    uv2[:20] = rng.uniform([10, 10], [310, 230], (20, 2))   # outliers
    valid = rng.random(n) < 0.95
    return uv1, uv2, valid, K


@pytest.mark.parametrize("planar", [True, False], ids=["homography", "fundamental"])
def test_initialize_two_view_matches_jax(planar):
    uv1, uv2, valid, K = _two_view(planar, seed=3)
    rj = JI.initialize_two_view(uv1, uv2, valid, K, seed=7)
    rt = TI.initialize_two_view(uv1, uv2, valid, K, seed=7, device="cpu")
    assert rj is not None and rt is not None
    assert rt.used_homography == rj.used_homography == planar
    dR = rj.R.astype(np.float64).T @ rt.R.astype(np.float64)
    assert np.linalg.norm([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]) / 2 < ROT_TOL_RAD
    assert np.abs(rt.t / np.linalg.norm(rt.t) - rj.t / np.linalg.norm(rj.t)).max() < T_DIR_TOL
    np.testing.assert_array_equal(rt.is_triangulated, rj.is_triangulated)
    tri = rj.is_triangulated
    assert tri.sum() > 300
    np.testing.assert_allclose(rt.points3d[tri], rj.points3d[tri], rtol=1e-3, atol=1e-3)


# ---- the whole tracker ----------------------------------------------------------

SENSORS = {"stereo": "STEREO", "rgbd": "RGBD", "mono": "MONOCULAR"}


def _config(sensor):
    return JSlam(
        camera=JCam(fx=250.0, fy=250.0, cx=160.0, cy=120.0,
                    bf=250.0 * BASELINE if sensor != "mono" else 0.0, width=320, height=240),
        orb=JOrb(n_features=600, max_keypoints=1024), fps=10.0,
        th_depth=100.0 if sensor == "stereo" else 40.0, max_keyframes=100, max_map_points=30000)


def _frames(sensor):
    world = PlanesWorld(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240,
                        texture_seed=3)
    poses = smooth_trajectory(N_FRAMES, step=0.05)
    rng = np.random.default_rng(0)

    def noisy(img):
        return np.clip(img + rng.uniform(-NOISE, NOISE, img.shape), 0, 255).astype(np.float32)

    for i, Tcw in enumerate(poses):
        args = [noisy(world.render(Tcw))]
        if sensor == "stereo":
            T_rl = np.eye(4, dtype=np.float32)
            T_rl[0, 3] = -BASELINE
            args.append(noisy(world.render(T_rl @ Tcw)))
        elif sensor == "rgbd":
            args.append(world.render_depth(Tcw))
        yield args + [0.1 * i]


def _rot_deg(A, B):
    dR = A[:3, :3].astype(np.float64).T @ B[:3, :3].astype(np.float64)
    s = np.linalg.norm([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]) / 2
    return np.degrees(np.arcsin(min(s, 1.0)))


@pytest.fixture(scope="module", params=sorted(SENSORS))
def tracked(request):
    sensor = request.param
    cfg = _config(sensor)
    tcfg = slam_config_from_jax(cfg)
    jt = JT.Tracker(cfg, JMapStore(cfg), JT.Sensor[SENSORS[sensor]])
    jt.use_fused = True           # ORB_FUSED_TRACK=1: the path the port takes by default
    tt = TT.Tracker(tcfg, TMapStore(tcfg), TT.Sensor[SENSORS[sensor]], device="cpu")
    assert tt.use_fused
    entry = {"stereo": "track_stereo", "rgbd": "track_rgbd", "mono": "track_monocular"}[sensor]
    rows, first_maps = [], None
    for args in _frames(sensor):
        Tj = getattr(jt, entry)(*args)
        Tt = getattr(tt, entry)(*args)
        rows.append(dict(
            state=(jt.state.name, tt.state.name), Tcw=(Tj, Tt),
            fused=(jt.fused_frames, tt.fused_frames), staged=(jt.staged_frames, tt.staged_frames),
            kfs=(jt.map.n_keyframes(), tt.map.n_keyframes()),
            mps=(jt.map.n_map_points(), tt.map.n_map_points())))
        if first_maps is None and jt.map.n_keyframes():
            first_maps = (map_store_from_jax(jt.map), map_store_from_jax(tt.map))
    return sensor, rows, first_maps, tt


def test_tracker_matches_jax_per_frame(tracked):
    sensor, rows, _, _ = tracked
    for i, r in enumerate(rows):
        for key in ("state", "fused", "staged", "kfs", "mps"):
            assert r[key][0] == r[key][1], (sensor, i, key, r[key])
        Tj, Tt = r["Tcw"]
        assert (Tj is None) == (Tt is None), (sensor, i)
        if Tj is not None:
            assert np.abs(Tj[:3, 3] - Tt[:3, 3]).max() < POSE_TOL_M, (sensor, i)
            assert _rot_deg(Tj, Tt) < POSE_TOL_DEG, (sensor, i)


def test_tracker_runs_fused_path_and_makes_keyframes(tracked):
    sensor, rows, _, tt = tracked
    last = rows[-1]
    assert last["state"][1] == "OK"
    assert last["fused"][1] >= (3 if sensor == "mono" else 8), sensor
    assert last["kfs"][1] >= 3, sensor
    assert tt.fused_frames + tt.staged_frames <= N_FRAMES
    if sensor != "mono":
        assert tt._dev_map is not None and tt._dev_map.d_packed.device.type == "cpu"


def test_map_stores_match_after_initialization(tracked):
    """interop.map_store_from_jax copies the JAX map; after the first
    initialization both packages' map stores hold the same arrays."""
    sensor, _, (mj, mt), _ = tracked
    assert isinstance(mj, TMapStore) and mj.n_kf == mt.n_kf and mj.n_mp == mt.n_mp
    assert mj.n_kf == (2 if sensor == "mono" else 1)
    names = [k for k, v in vars(mj).items() if isinstance(v, np.ndarray)]
    assert {"kf_desc", "mp_desc", "mp_pos", "covis", "mp_obs_kf"} <= set(names)
    for k in names:
        a, b = getattr(mj, k), getattr(mt, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype == np.uint32:     # descriptors: the extraction gate
            ham = np.bitwise_count(a ^ b).reshape(-1, 8).sum(-1)
            assert (ham > 0).mean() <= 0.02 and ham.max() <= 8, k
        elif a.dtype.kind == "f":    # float32 ulps of the pyramid, as in extraction
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3, err_msg=k)
        else:                        # ids, counts, covisibility: exact
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert mj._mp_free == mt._mp_free and mj.loop_edges == mt.loop_edges
    assert dataclasses.asdict(mj.config) == dataclasses.asdict(mt.config)
