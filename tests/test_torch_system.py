"""Parity of the port's System (local mapping and relocalization, loop
closing off) with the JAX package's, on the CPU, on a 320x240 PlanesWorld
sequence per sensor with seeded sensor noise (as test_torch_tracking.py):
MAPPED frames, BLANK black frames and up to REVISITS revisits of frame
REVISIT_FRAME's view.

  * both packages' System(..., enable_loop_closing=False) with the shipped
    vocabulary, fed the same frames: per frame the same tracking state,
    the pose within POSE_TOL_M and POSE_TOL_DEG where both track, live
    keyframes within KF_TOL; LOST after the blank frames and relocalized
    on the same revisit;
  * one LocalMapper.on_new_keyframe (a keyframe that runs local BA) and
    one Relocalizer call (the first on a revisit frame), each started from
    the JAX package's state at that call, carried across by interop: the
    same map points created, fused and culled (ids, observations and
    keyframe associations exact), keyframe poses within POSE_TOL_M and
    POSE_TOL_DEG, the points within PT_TOL m in the median and all within
    PT_RTOL of their distance from the first camera (points ~11 m away
    seen over 5 cm baselines are ill-conditioned along their rays: after
    local BA the two float32 solves part by up to 1.8 cm there); the same
    relocalization outcome and associations, and the pose within the same
    tolerances;
  * culled keyframes stay active in the keyframe database, in both
    packages (ROADMAP.md C.7, reproduced for parity);
  * System at its defaults builds loop closing (LoopCloser and the inline
    GlobalBARunner) and feeds it every keyframe; async mapping and an
    interruptible global BA (a stop_check, the asynchronous GBA runner's)
    build and stop (tests/test_torch_async.py drives them).
"""
import numpy as np
import pytest

from orb_slam2_detailed_comments_tpu import system as JS
from orb_slam2_detailed_comments_tpu.frontend import tracking as JT
from orb_slam2_detailed_comments_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_detailed_comments_tpu.utils.config import OrbConfig as JOrb, SlamConfig as JSlam

from orb_slam2_detailed_comments_tpu_torch import system as TS
from orb_slam2_detailed_comments_tpu_torch.backend import local_mapping as TLM
from orb_slam2_detailed_comments_tpu_torch.backend.relocalization import Relocalizer
from orb_slam2_detailed_comments_tpu_torch.frontend import tracking as TT
from orb_slam2_detailed_comments_tpu_torch.interop import (
    kf_database_from_jax, map_store_from_jax, slam_config_from_jax)
from orb_slam2_detailed_comments_tpu_torch.state.frame import FrameData

from synthetic_world import PlanesWorld, smooth_trajectory
from torch_parity import jax_exact_modes

POSE_TOL_M, POSE_TOL_DEG, PT_TOL, PT_RTOL = 1e-3, 0.01, 1e-4, 5e-3
KF_TOL = 1
MAPPED, BLANK, REVISITS, REVISIT_FRAME = 12, 2, 2, 6
NOISE = 2.0
BASELINE = 0.12
SENSORS = {"stereo": "STEREO", "rgbd": "RGBD", "mono": "MONOCULAR"}
ENTRY = {"stereo": "track_stereo", "rgbd": "track_rgbd", "mono": "track_monocular"}


@pytest.fixture(scope="module", autouse=True)
def _jax_exact_modes():
    with jax_exact_modes():
        yield


def _config(sensor):
    """One camera for the three sensors (a mono run ignores bf, as
    chip_smoke.py's TUM1 mono phase does): the JAX package compiles its
    camera-static programs once for the file."""
    return JSlam(
        camera=JCam(fx=250.0, fy=250.0, cx=160.0, cy=120.0, bf=250.0 * BASELINE,
                    width=320, height=240),
        orb=JOrb(n_features=600, max_keypoints=1024), fps=10.0,
        th_depth=100.0 if sensor == "stereo" else 40.0, max_keyframes=100, max_map_points=30000)


def _frames(sensor, first=None):
    """The MAPPED frames, then BLANK blank ones, then REVISITS copies of
    frame REVISIT_FRAME; with `first`, only the first `first` frames."""
    world = PlanesWorld(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240,
                        texture_seed=3)
    rng = np.random.default_rng(0)
    frames = []
    for Tcw in smooth_trajectory(MAPPED, step=0.05)[:first]:
        args = [np.clip(world.render(Tcw) + rng.uniform(-NOISE, NOISE, (240, 320)), 0, 255)]
        if sensor == "stereo":
            T_rl = np.eye(4, dtype=np.float32)
            T_rl[0, 3] = -BASELINE
            args.append(np.clip(world.render(T_rl @ Tcw)
                                + rng.uniform(-NOISE, NOISE, (240, 320)), 0, 255))
        elif sensor == "rgbd":
            args.append(world.render_depth(Tcw))
        frames.append([a.astype(np.float32) for a in args])
    if first is not None:
        return frames
    blank = [np.zeros_like(a) for a in frames[0]]
    return frames + [blank] * BLANK + [frames[REVISIT_FRAME]] * REVISITS


def _rot_deg(A, B):
    dR = A[:3, :3].astype(np.float64).T @ B[:3, :3].astype(np.float64)
    s = np.linalg.norm([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]) / 2
    return np.degrees(np.arcsin(min(s, 1.0)))


def _close_poses(A, B):
    return np.abs(A[:3, 3] - B[:3, 3]).max() < POSE_TOL_M and _rot_deg(A, B) < POSE_TOL_DEG


def _frame_to_port(f):
    return FrameData(**{k: (v.copy() if isinstance(v, np.ndarray) else v)
                        for k, v in vars(f).items()})


@pytest.fixture(scope="module", params=sorted(SENSORS))
def run(request):
    """Both Systems over the sequence, with the JAX mapper's first
    keyframe that runs local BA and the JAX relocalizer's first call on a
    revisit frame captured (state before, result after)."""
    sensor = request.param
    cfg = _config(sensor)
    js = JS.System(cfg, JT.Sensor[SENSORS[sensor]], enable_loop_closing=False)
    js.tracker.use_fused = True        # the path the port takes by default
    ts = TS.System(slam_config_from_jax(cfg), TT.Sensor[SENSORS[sensor]],
                   enable_loop_closing=False, device="cpu")
    cap = {}
    j_mapper, j_reloc = js.local_mapper.on_new_keyframe, js.tracker.relocalizer

    def mapper_hook(kf, run_ba=True):
        if "map" not in cap and run_ba and js.map.n_keyframes() > 2:
            before = (map_store_from_jax(js.map), list(js.local_mapper.recent_points), kf)
            j_mapper(kf, run_ba)
            cap["map"] = before + (map_store_from_jax(js.map),)
        else:
            j_mapper(kf, run_ba)

    def reloc_hook(frame):
        if "reloc" in cap or frame.n_valid < 100:
            return j_reloc(frame)
        before = (map_store_from_jax(js.map), kf_database_from_jax(js.kfdb, ts.voc),
                  _frame_to_port(frame))
        ok = j_reloc(frame)
        cap["reloc"] = before + (ok, _frame_to_port(frame))
        return ok

    js.local_mapper.on_new_keyframe = mapper_hook
    js.tracker.relocalizer = reloc_hook
    rows = []
    for i, args in enumerate(_frames(sensor)):
        Tj = getattr(js, ENTRY[sensor])(*args, 0.1 * i)
        Tt = getattr(ts, ENTRY[sensor])(*args, 0.1 * i)
        rows.append(dict(state=(js.tracking_state.name, ts.tracking_state.name), Tcw=(Tj, Tt),
                         kfs=(js.map.n_keyframes(), ts.map.n_keyframes())))
    return sensor, rows, cap, ts, js


def test_system_matches_jax_per_frame(run):
    sensor, rows, _, ts, _ = run
    for i, r in enumerate(rows):
        assert r["state"][0] == r["state"][1], (sensor, i, r["state"])
        Tj, Tt = r["Tcw"]
        assert (Tj is None) == (Tt is None), (sensor, i)
        if Tj is not None and r["state"][0] == "OK":
            assert _close_poses(Tj, Tt), (sensor, i)
        assert abs(r["kfs"][0] - r["kfs"][1]) <= KF_TOL, (sensor, i, r["kfs"])
    states = [r["state"][1] for r in rows]
    assert states[MAPPED - 1] == "OK" and states[MAPPED + BLANK - 1] == "LOST", (sensor, states)
    assert ts.local_mapper.timer.counts["fusion"] >= 2
    assert type(ts.voc).__module__.startswith("orb_slam2_detailed_comments_tpu_torch")


def test_system_relocalizes_on_the_same_revisit(run):
    sensor, rows, _, _, _ = run
    after = [r["state"] for r in rows[MAPPED + BLANK:]]
    first = [next((i for i, s in enumerate(after) if s[k] == "OK"), None) for k in (0, 1)]
    assert first[0] == first[1], (sensor, after)
    if sensor != "mono":
        assert first[1] is not None, (sensor, after)


def test_local_mapper_matches_jax_from_one_map(run):
    sensor, _, cap, ts, _ = run
    before, recent, kf, after_j = cap["map"]
    mapper = TLM.LocalMapper(ts.config, before, monocular=sensor == "mono", device="cpu")
    mapper.recent_points = recent
    n_mp_before = int(before.mp_valid.sum())
    mapper.on_new_keyframe(kf)
    after_t = mapper.map
    np.testing.assert_array_equal(after_t.mp_valid, after_j.mp_valid)
    np.testing.assert_array_equal(after_t.kf_valid, after_j.kf_valid)
    np.testing.assert_array_equal(after_t.kf_mp, after_j.kf_mp)
    np.testing.assert_array_equal(after_t.mp_obs_kf, after_j.mp_obs_kf)
    assert after_t._mp_free == after_j._mp_free
    live = after_j.mp_valid
    dx = np.linalg.norm(after_t.mp_pos[live] - after_j.mp_pos[live], axis=1)
    assert np.median(dx) < PT_TOL
    assert (dx < PT_RTOL * np.linalg.norm(after_j.mp_pos[live], axis=1)).all()
    for k in np.nonzero(after_j.kf_valid)[0]:
        assert _close_poses(after_t.kf_Tcw[k], after_j.kf_Tcw[k]), (sensor, k)
    assert int(after_j.mp_valid.sum()) != n_mp_before or sensor == "mono"
    assert "local_ba_solve_16cams" in mapper.timer.counts


def test_relocalizer_matches_jax_from_one_map(run):
    sensor, _, cap, ts, _ = run
    if "reloc" not in cap:
        pytest.fail(f"{sensor}: the JAX relocalizer never ran on a revisit frame")
    ms, kfdb, frame, ok_j, frame_j = cap["reloc"]
    reloc = Relocalizer(ts.config, ms, ts.voc, kfdb, device="cpu")
    assert reloc(frame) == ok_j
    if ok_j:
        assert _close_poses(frame.Tcw, frame_j.Tcw), sensor
        np.testing.assert_array_equal(frame.mp, frame_j.mp)


def test_culled_keyframes_stay_in_the_database_as_in_jax(run):
    """ROADMAP.md C.7, reproduced on purpose for parity: keyframe culling
    does not erase a keyframe from the KeyFrameDatabase (the reference's
    KeyFrame::SetBadFlag does), so the relocalization cascade can return
    culled keyframes, which the Relocalizer then skips."""
    sensor, _, _, ts, js = run
    n = ts.map.n_kf
    assert n == js.map.n_kf > 2
    np.testing.assert_array_equal(ts.kfdb.active[:n], js.kfdb.active[:n])
    k = int(ts.map.keyframe_ids()[-1])
    for slam in (ts, js):                 # what LocalMapper._keyframe_culling does
        slam.map.erase_keyframe(k)
        assert not slam.map.kf_valid[k] and slam.kfdb.active[k], sensor


def test_system_without_loop_closing_only():
    """The name predates loop closing in the port. System(cfg, sensor) at its
    defaults, and with enable_loop_closing=True, builds a LoopCloser wired to
    the mapper and to the inline GlobalBARunner, for all three sensors (a
    fixed scale but for mono). The asynchronous pipeline and an
    interruptible global BA (a stop_check, the threaded runner's), which
    raised here, now build and run: async_mapping=True wraps the mapper in
    the worker and makes the runner threaded, and a stop_check that fires
    at its first poll stops a 4096-edge solve."""
    from orb_slam2_detailed_comments_tpu_torch.backend.async_pipeline import AsyncLocalMapper
    from orb_slam2_detailed_comments_tpu_torch.backend.gba_runner import GlobalBARunner
    from orb_slam2_detailed_comments_tpu_torch.backend.loop_closing import LoopCloser
    cfg = slam_config_from_jax(_config("rgbd"))
    for sensor in SENSORS.values():
        for kw in (dict(), dict(enable_loop_closing=True)):
            slam = TS.System(cfg, TT.Sensor[sensor], device="cpu", **kw)
            lc = slam.loop_closer
            assert isinstance(lc, LoopCloser) and slam.local_mapper.loop_closer is lc
            assert isinstance(slam.gba_runner, GlobalBARunner) and lc.gba_runner is slam.gba_runner
            assert lc.local_mapper is slam.local_mapper and lc.run_global_ba
            assert lc.fix_scale == (sensor != "MONOCULAR") and lc.kfdb is slam.kfdb
    slam = TS.System(cfg, TT.Sensor.RGBD, device="cpu", async_mapping=True)
    slam.shutdown()
    assert isinstance(slam.local_mapper, AsyncLocalMapper) and slam.gba_runner.async_mode
    assert slam.loop_closer is slam.local_mapper.loop_closer
    prob = TLM._problem("cpu", np.eye(4, dtype=np.float32)[None].repeat(2, 0), np.ones(2, bool),
                        np.ones(2, bool), np.zeros((1, 3), np.float32), np.ones(1, bool),
                        *(np.zeros(n, t) for n, t in ((4096, np.int32), (4096, np.int32))),
                        np.zeros((4096, 3), np.float32), np.zeros(4096, np.int32),
                        np.ones(4096, bool))
    assert TLM.solve_global_ba(prob, cfg.camera, np.ones(8, np.float32),
                               stop_check=lambda: True) is None


def test_system_defaults_feed_the_loop_closer_every_keyframe():
    """System(cfg, sensor) at its defaults on the first frames of the RGB-D
    sequence: every keyframe the mapper takes goes on to the LoopCloser,
    which indexes it and keeps its bag (too early for a loop: keyframes
    under 10 never close one)."""
    cfg = slam_config_from_jax(_config("rgbd"))
    slam = TS.System(cfg, TT.Sensor.RGBD, device="cpu")
    mapped, fed = [], []
    on_map, on_loop = slam.local_mapper.on_new_keyframe, slam.loop_closer.on_new_keyframe
    slam.local_mapper.on_new_keyframe = lambda kf, run_ba=True: (mapped.append(kf),
                                                                 on_map(kf, run_ba))
    slam.loop_closer.on_new_keyframe = lambda kf: (fed.append(kf), on_loop(kf))[1]
    for i, args in enumerate(_frames("rgbd", first=3)):
        slam.track_rgbd(*args, 0.1 * i)
    assert len(fed) >= 2 and fed == mapped == list(range(slam.map.n_kf))
    assert set(slam.loop_closer.kf_bow) == set(fed) and slam.kfdb.active[fed].all()
    assert slam.loop_closer.n_loops_closed == 0
    assert slam.loop_closer.timer.counts["detect"] == len(fed)
