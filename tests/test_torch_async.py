"""The port's asynchronous pipeline on the CPU: the interruptible global
BA, the local-BA abort and staleness guards, the threaded GlobalBARunner,
backend/async_pipeline.AsyncLocalMapper and System(async_mapping=True).

  * solve_global_ba with a stop_check that never fires equals the unpolled
    solve bit for bit, on a flat problem (chip_smoke.synthetic_ba_problem,
    2000 edges) and on a grouped one (test_torch_global_ba_grouped.py's
    4,225-edge problem), and equals the JAX package's unchunked solve
    within test_torch_local_ba.py's tolerance (flat) and
    test_torch_global_ba_grouped.py's (grouped); a stop_check that fires
    at the second poll returns None;
  * LocalMapper._solve_local_ba with abort_ba_check true and false, each
    against the JAX LocalMapper's with the same check, within
    test_torch_local_ba.py's tolerance; the check is polled once. The
    split schedule (5 robust iterations, a poll, 10 plain ones) is not the
    one-call schedule bit for bit (it renormalizes the poses and re-gates
    the edges between its calls), but within the same tolerance of it;
  * the behaviours of the JAX package's tests/test_gba_runner.py:123-310,
    against the port on test_loop_closing.py's drifted loop: a new launch
    or stop kills a running global BA, the map lock stays free while one
    solves, a stale thread cannot merge after a relaunch, an uninterrupted
    threaded global BA merges what the inline one merges (bit for bit),
    the local-BA solve runs outside the map lock, and a stale local-BA
    solve is discarded once pose_epoch moves;
  * an exception on the mapping worker or on a global-BA thread is raised
    on the caller's thread, and a wait that runs out raises;
  * the tracker's reset under the map lock voids the worker's queue
    without waiting for it; the worker accepts keyframes only when idle,
    and the tracker then inserts one only after max_frames frames, while
    fewer than three wait, and never in mono; the wrapper passes the
    mapper's surface through;
  * tools/bench_e2e.py's ATE snapshots are copies;
  * System(async_mapping=True, device="cpu"), drained after each of the
    first DRAINED_FRAMES frames of test_torch_system.py's stereo sequence
    (keyframe-making frames, each mapped by the worker), keeps the sync System's
    keyframes, map points and tracking states, and its poses within
    test_torch_system.py's POSE_TOL_M and POSE_TOL_DEG.

Every join and wait has a timeout.
"""
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orb_slam2_detailed_comments_tpu.backend.local_mapping import LocalMapper as JMapper
from orb_slam2_detailed_comments_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_detailed_comments_tpu.optim import global_ba as JGF, global_ba_grouped as JG
from orb_slam2_detailed_comments_tpu.state.map_store import MapStore as JMapStore
from orb_slam2_detailed_comments_tpu.utils.config import OrbConfig as JOrb, SlamConfig as JSlam

from orb_slam2_detailed_comments_tpu_torch import system as TS
from orb_slam2_detailed_comments_tpu_torch.backend import gba_runner as TR
from orb_slam2_detailed_comments_tpu_torch.backend import local_mapping as TLM
from orb_slam2_detailed_comments_tpu_torch.backend.async_pipeline import AsyncLocalMapper
from orb_slam2_detailed_comments_tpu_torch.frontend import tracking as TT
from orb_slam2_detailed_comments_tpu_torch.geometry.camera import PinholeCamera as TCam
from orb_slam2_detailed_comments_tpu_torch.interop import (
    ba_problem_from_jax, map_store_from_jax, slam_config_from_jax)
from orb_slam2_detailed_comments_tpu_torch.optim import local_ba as TL
from orb_slam2_detailed_comments_tpu_torch.state.map_store import MapStore

import chip_smoke
import test_torch_global_ba_grouped as GG
import test_torch_local_ba as LBA
import test_torch_system as SYS
from test_global_ba_grouped import build_problem
from test_loop_closing import build_drifted_loop

WAIT_S = 60.0          # every join and wait in this file
DRAINED_FRAMES = 5     # of test_torch_system.py's stereo sequence
GBA_ITERS = 2          # the port's global BA on the drifted loop: ~1 s an iteration here
INV_S2 = LBA.INV_S2


def _port_loop(seed, jitter_m=0.0):
    """test_loop_closing.py's drifted loop, its keyframe centres but the
    first moved by `jitter_m` (seeded) so that a global BA moves them back."""
    cfg, ms, _, _ = build_drifted_loop(seed=seed)
    kfs = ms.keyframe_ids()
    ms.kf_Tcw[kfs[1:], :3, 3] += np.random.default_rng(seed).normal(
        0.0, jitter_m, (len(kfs) - 1, 3)).astype(np.float32)
    return slam_config_from_jax(cfg), map_store_from_jax(ms)


def _async_runner(cfg, ms, lock=None):
    return TR.GlobalBARunner(cfg, ms, async_mode=True, device="cpu",
                             map_lock=lock if lock is not None else threading.RLock())


# ---- the interruptible global BA ----------------------------------------------

def _same(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def _near_jax(d, jax_out, port_out):
    """test_torch_local_ba.py's tolerance for two solves of one problem:
    the valid cameras within CAM_TOL, 99% of the valid points within PT_TOL m."""
    v, pv = d["cam_valid"], d["point_valid"]
    assert np.abs(port_out[0][v] - np.asarray(jax_out[0])[v]).max() < LBA.CAM_TOL
    dx = np.linalg.norm(port_out[1][pv] - np.asarray(jax_out[1])[pv], axis=1)
    assert np.percentile(dx, 99) < LBA.PT_TOL


def test_chunked_flat_global_ba_is_the_unchunked_solve():
    d = chip_smoke.synthetic_ba_problem((16, 512, 2000), seed=1)
    pj, pt = LBA._both(d)
    assert int(pt.edge_cam.shape[0]) < TLM.FLAT_GBA_MAX_EDGES
    cam = TCam(**chip_smoke.BA_CAM)
    whole = TLM.solve_global_ba(pt, cam, INV_S2, n_iters=6)
    polls = []

    def never():
        polls.append(1)
        return False

    chunked = TLM.solve_global_ba(pt, cam, INV_S2, n_iters=6, stop_check=never)
    assert _same(whole, chunked) and len(polls) == 4      # 3 + 3 iterations, a poll every 2
    _near_jax(d, JGF.global_bundle_adjustment(pj, JCam(**chip_smoke.BA_CAM),
                                              jnp.asarray(INV_S2), n_iters=6), chunked)


def test_chunked_grouped_global_ba_is_the_unchunked_solve():
    pj = build_problem(seed=13, C=24, P=1000, n_invalid=40)
    pt = ba_problem_from_jax(pj, "cpu")
    assert int(pt.edge_cam.shape[0]) >= TLM.FLAT_GBA_MAX_EDGES
    inv = GG.INV_S2.numpy()
    whole = TLM.solve_global_ba(pt, GG.CAM, inv, n_iters=6)
    chunked = TLM.solve_global_ba(pt, GG.CAM, inv, n_iters=6, stop_check=lambda: False)
    assert _same(whole, chunked)
    cams, pts, _, _ = JG._solve_grouped(JG.group_global_problem(pj, GG.J_INV_S2), GG.JCAM, 6,
                                        50, 1e-5, "gather")
    GG._close(chunked, (np.asarray(cams), np.asarray(pts)))


@pytest.mark.parametrize("layout", ["flat", "grouped"])
def test_stop_check_firing_after_the_first_chunk_returns_none(layout):
    if layout == "flat":
        d = chip_smoke.synthetic_ba_problem((16, 512, 2000), seed=1)
        pt, cam = LBA._both(d)[1], TCam(**chip_smoke.BA_CAM)
    else:
        pt, cam = ba_problem_from_jax(build_problem(seed=13, C=24, P=1000, n_invalid=40),
                                      "cpu"), GG.CAM
    answers = iter([False, True])
    assert TLM.solve_global_ba(pt, cam, INV_S2, n_iters=6,
                               stop_check=lambda: next(answers)) is None


# ---- the local-BA abort ------------------------------------------------------

@pytest.fixture(scope="module")
def mappers():
    """A JAX and a port LocalMapper at chip_smoke.BA_CAM (levels of 1.2, as
    test_torch_local_ba.INV_S2), and one local-BA problem at the 16-camera bucket."""
    jcfg = JSlam(camera=JCam(**chip_smoke.BA_CAM), orb=JOrb(n_features=300, max_keypoints=512),
                 max_keyframes=16, max_map_points=1000)
    jm = JMapper(jcfg, JMapStore(jcfg), monocular=False)
    tcfg = slam_config_from_jax(jcfg)
    tm = TLM.LocalMapper(tcfg, MapStore(tcfg), monocular=False, device="cpu")
    np.testing.assert_allclose(tm.inv_sigma2, INV_S2, rtol=1e-6)
    d = chip_smoke.synthetic_ba_problem(TLM.BA_BUCKETS[0], seed=0)
    return jm, tm, d


@pytest.mark.parametrize("abort", [True, False])
def test_solve_local_ba_with_abort_check_matches_jax(mappers, abort):
    jm, tm, d = mappers
    pj, pt = LBA._both(d)
    polls = []

    def check():
        polls.append(1)
        return abort

    jm.abort_ba_check = tm.abort_ba_check = check
    jm.n_ba_aborted = tm.n_ba_aborted = 0
    try:
        out_j = jm._solve_local_ba({"prob": pj})
        out_t = tm._solve_local_ba({"prob": pt})
    finally:
        jm.abort_ba_check = tm.abort_ba_check = None
    assert len(polls) == 2 and jm.n_ba_aborted == tm.n_ba_aborted == int(abort)
    LBA._check_ba(d, out_j, [torch.from_numpy(a) for a in out_t])
    if not abort:
        # what the split computes against the one-call schedule
        whole = TL.local_bundle_adjustment(pt, TCam(**chip_smoke.BA_CAM), tm._inv_sigma2_t)
        assert not _same([a.numpy() for a in whole], out_t)
        LBA._check_ba(d, [a.numpy() for a in whole], [torch.from_numpy(a) for a in out_t])


def test_stale_local_ba_solve_is_discarded():
    """An off-lock solve whose linearization predates a whole-map correction
    (a loop or a global-BA merge moves pose_epoch) does not merge."""
    cfg, ms = _port_loop(14)
    mapper = TLM.LocalMapper(cfg, ms, monocular=True, device="cpu")
    built = mapper._build_local_ba(int(ms.keyframe_ids()[-2]))
    assert built is not None
    result = mapper._solve_local_ba(built)
    poses, pts = ms.kf_Tcw.copy(), ms.mp_pos.copy()
    ms.pose_epoch += 1
    mapper._merge_local_ba(built, result)
    assert mapper.n_ba_stale == 1
    np.testing.assert_array_equal(ms.kf_Tcw, poses)
    np.testing.assert_array_equal(ms.mp_pos, pts)


# ---- the threaded global-BA runner -----------------------------------------

def test_new_launch_kills_a_running_global_ba():
    cfg, ms = _port_loop(7)
    runner = _async_runner(cfg, ms)
    release = threading.Event()
    runner._chunk_hook = lambda: release.wait(WAIT_S)
    poses = ms.kf_Tcw.copy()
    runner.launch(n_iters=GBA_ITERS)
    assert runner.running()
    runner.request_stop(join=False)    # the next loop arrives (reference :699-712)
    release.set()
    runner.wait(WAIT_S)
    assert not runner.running()
    assert runner.n_aborted == 1 and runner.n_completed == 0
    np.testing.assert_array_equal(ms.kf_Tcw, poses)


def test_map_lock_is_free_while_a_global_ba_solves():
    cfg, ms = _port_loop(8)
    lock = threading.RLock()
    runner = _async_runner(cfg, ms, lock)
    slow = threading.Event()
    runner._chunk_hook = lambda: slow.wait(0.25) and None
    runner.launch(n_iters=GBA_ITERS)
    try:
        waits = []
        deadline = time.monotonic() + WAIT_S
        while runner.running() and len(waits) < 20 and time.monotonic() < deadline:
            t0 = time.monotonic()
            with lock:
                pass
            waits.append(time.monotonic() - t0)
            time.sleep(0.01)
        assert waits, "the global BA ended before any lock probe"
        assert np.percentile(waits, 95) < 0.1, waits
    finally:
        runner.request_stop(join=False)
        slow.set()
        runner.wait(WAIT_S)
    assert runner.n_completed + runner.n_aborted == 1


def test_stale_thread_cannot_merge_after_a_relaunch(monkeypatch):
    """A thread that finished its solve and waits at the merge's lock while a
    loop correction holds it must not merge once a new launch supersedes it."""
    cfg, ms = _port_loop(12)
    lock = threading.RLock()
    runner = _async_runner(cfg, ms, lock)
    solve = TR.solve_global_ba
    solved = threading.Event()

    def slow_solve(*a, **k):
        out = solve(*a, **k)
        solved.set()
        time.sleep(1.0)         # the main thread takes the map lock first
        return out

    monkeypatch.setattr(TR, "solve_global_ba", slow_solve)
    runner.launch(n_iters=GBA_ITERS)
    th1 = runner._thread
    assert solved.wait(WAIT_S)
    with lock:                  # a loop correction
        runner.request_stop(join=True, timeout=0.5)
        assert th1.is_alive()   # blocked at the merge's lock
        solved.clear()
        runner.launch(n_iters=GBA_ITERS)
        th2 = runner._thread
        assert th2 is not th1
    th1.join(WAIT_S)
    th2.join(WAIT_S)
    assert not th1.is_alive() and not th2.is_alive()
    assert runner.n_completed == 1 and runner.n_aborted == 1


def test_threaded_global_ba_merges_what_the_inline_one_merges():
    cfg, ms_a = _port_loop(9, jitter_m=0.02)
    _, ms_b = _port_loop(9, jitter_m=0.02)
    poses = ms_a.kf_Tcw.copy()
    inline = TR.GlobalBARunner(cfg, ms_a, device="cpu")
    inline.launch(n_iters=GBA_ITERS)
    threaded = _async_runner(cfg, ms_b)
    threaded.launch(n_iters=GBA_ITERS)
    threaded.wait(WAIT_S)
    assert inline.n_completed == threaded.n_completed == 1 and threaded.n_aborted == 0
    v = ms_a.kf_valid
    assert np.abs(ms_a.kf_Tcw[v] - poses[v])[:, :3, 3].max() > 1e-3
    for f in ("kf_Tcw", "mp_pos", "mp_valid", "mp_normal"):
        np.testing.assert_array_equal(getattr(ms_a, f), getattr(ms_b, f))
    assert ms_a.pose_epoch == ms_b.pose_epoch


def test_threaded_runner_needs_the_map_lock():
    cfg, ms = _port_loop(0)
    with pytest.raises(ValueError, match="map lock"):
        TR.GlobalBARunner(cfg, ms, async_mode=True, device="cpu")


# ---- the asynchronous local mapper -----------------------------------------

def test_local_ba_solve_runs_off_the_map_lock():
    cfg, ms = _port_loop(13)
    lock = threading.RLock()
    mapper = TLM.LocalMapper(cfg, ms, monocular=True, device="cpu")
    amapper = AsyncLocalMapper(mapper, lock)
    assert amapper._fuse.__func__ is TLM.LocalMapper._fuse      # the mapper's surface
    assert amapper.map is ms and amapper.device == mapper.device
    solve = mapper._solve_local_ba
    in_solve, release = threading.Event(), threading.Event()

    def gated_solve(built):
        in_solve.set()
        release.wait(WAIT_S)
        return solve(built)

    mapper._solve_local_ba = gated_solve
    try:
        amapper.on_new_keyframe(int(ms.keyframe_ids()[-2]))
        assert in_solve.wait(WAIT_S), "the local-BA solve never started"
        waits = []
        for _ in range(20):
            t0 = time.monotonic()
            with lock:
                pass
            waits.append(time.monotonic() - t0)
            time.sleep(0.005)
        with pytest.raises(TimeoutError):
            amapper.wait_idle(0.05)
        assert not amapper.accept_keyframes()     # busy: the reference's AcceptKeyFrames
        release.set()
        amapper.wait_idle(WAIT_S)
        assert amapper.accept_keyframes()
        assert np.percentile(waits, 95) < 0.05, waits
        assert amapper.n_processed == 1 and mapper.kf_counter == 1
    finally:
        release.set()
        amapper.shutdown(WAIT_S)
    assert not amapper._thread.is_alive()


def test_worker_failure_reaches_the_caller():
    cfg, ms = _port_loop(15)
    mapper = TLM.LocalMapper(cfg, ms, monocular=True, device="cpu")
    amapper = AsyncLocalMapper(mapper, threading.RLock())

    def broken(kf, run_ba=True):
        raise ValueError("broken mapper")

    mapper.prepare_keyframe = broken
    amapper.on_new_keyframe(int(ms.keyframe_ids()[-1]))
    with pytest.raises(RuntimeError, match="worker failed") as err:
        amapper.wait_idle(WAIT_S)
    assert isinstance(err.value.__cause__, ValueError)
    with pytest.raises(RuntimeError, match="worker failed"):
        amapper.on_new_keyframe(0)
    with pytest.raises(RuntimeError, match="worker failed"):
        amapper.shutdown(WAIT_S)
    assert not amapper._thread.is_alive()


def test_global_ba_thread_failure_reaches_the_caller(monkeypatch):
    cfg, ms = _port_loop(16)
    runner = _async_runner(cfg, ms)

    def broken(*a, **k):
        raise ValueError("broken solve")

    monkeypatch.setattr(TR, "solve_global_ba", broken)
    runner.launch(n_iters=GBA_ITERS)
    with pytest.raises(RuntimeError, match="global BA thread failed") as err:
        runner.wait(WAIT_S)
    assert isinstance(err.value.__cause__, ValueError) and not runner.running()
    with pytest.raises(RuntimeError, match="global BA thread failed"):
        runner.launch(n_iters=GBA_ITERS)


def test_system_raises_a_worker_failure_on_the_next_frame():
    cfg = slam_config_from_jax(SYS._config("rgbd"))
    slam = TS.System(cfg, TT.Sensor.RGBD, async_mapping=True, device="cpu")
    frames = SYS._frames("rgbd", first=2)

    def broken(kf, run_ba=True):
        raise ValueError("broken mapper")

    slam.local_mapper.mapper.prepare_keyframe = broken
    slam.track_rgbd(*frames[0], 0.0)         # the initial keyframe goes to the worker
    with pytest.raises(RuntimeError, match="worker failed"):
        slam.local_mapper.wait_idle(WAIT_S)
    with pytest.raises(RuntimeError, match="worker failed"):
        slam.track_rgbd(*frames[1], 0.1)
    with pytest.raises(RuntimeError, match="worker failed"):
        slam.shutdown()


# ---- System(async_mapping=True) against the sync System -------------------

def test_drained_async_system_keeps_the_sync_systems_map():
    cfg = slam_config_from_jax(SYS._config("stereo"))
    frames = SYS._frames("stereo", first=DRAINED_FRAMES)
    sync = TS.System(cfg, TT.Sensor.STEREO, device="cpu")
    asy = TS.System(cfg, TT.Sensor.STEREO, async_mapping=True, device="cpu")
    assert isinstance(asy.local_mapper, AsyncLocalMapper) and asy.gba_runner.async_mode
    assert asy.tracker.map_lock is asy.gba_runner.lock is asy.local_mapper.lock
    assert asy.loop_closer.local_mapper is asy.local_mapper
    try:
        for i, args in enumerate(frames):
            Ts = sync.track_stereo(*args, 0.1 * i)
            Ta = asy.track_stereo(*args, 0.1 * i)
            asy.local_mapper.wait_idle(WAIT_S)
            assert sync.tracking_state == asy.tracking_state, i
            assert (Ts is None) == (Ta is None), i
            if Ts is not None and sync.tracking_state.name == "OK":
                assert SYS._close_poses(Ts, Ta), i
            assert sync.map.n_kf == asy.map.n_kf, i
    finally:
        asy.shutdown()
    n_kf = asy.map.n_kf
    assert n_kf > 2 and asy.local_mapper.n_processed == n_kf
    assert asy.local_mapper.n_ba_aborted == asy.local_mapper.n_ba_stale == 0
    np.testing.assert_array_equal(asy.map.kf_valid, sync.map.kf_valid)
    np.testing.assert_array_equal(asy.map.mp_valid, sync.map.mp_valid)
    for k in asy.map.keyframe_ids():
        assert SYS._close_poses(asy.map.kf_Tcw[k], sync.map.kf_Tcw[k]), k


def test_worker_queue_under_thread_switch_pressure():
    """Eight producers against the worker, with the interpreter switching
    threads every microsecond: every keyframe is processed once, under the
    lock for its two locked halves, and the pending count returns to 0."""
    import sys

    class Stub:
        device = torch.device("cpu")
        abort_ba_check = None

        def __init__(self, lock):
            self.lock, self.seen, self.locked, self.pending = lock, [], True, set()

        def prepare_keyframe(self, kf, run_ba=True):
            self.locked &= self.lock._is_owned()
            return kf

        def _solve_local_ba(self, built):
            self.locked &= not self.lock._is_owned()
            return built

        def _merge_local_ba(self, built, result):
            self.locked &= self.lock._is_owned()

        def finish_keyframe(self, kf):
            self.locked &= self.lock._is_owned()
            self.seen.append(kf)

    lock = threading.RLock()
    stub = Stub(lock)
    amapper = AsyncLocalMapper(stub, lock)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        producers = [threading.Thread(target=lambda b=b: [amapper.on_new_keyframe(b + i)
                                                           for i in range(200)])
                     for b in range(0, 8000, 1000)]
        for t in producers:
            t.start()
        for t in producers:
            t.join(WAIT_S)
        assert not any(t.is_alive() for t in producers)
        amapper.wait_idle(WAIT_S)
    finally:
        sys.setswitchinterval(old)
        amapper.shutdown(WAIT_S)
    assert sorted(stub.seen) == sorted(b + i for b in range(0, 8000, 1000) for i in range(200))
    assert amapper.n_processed == 1600 and amapper._pending == 0 and stub.locked
    assert not stub.pending


def test_last_frame_points_pull_a_fused_frames_descriptors():
    """A fused frame keeps its descriptors on the device (int32 bit-view).
    When the next frame falls back to the staged cascade, the motion model's
    last-frame point set must take them as the map's uint32 words: on the
    card np.where cannot read a CUDA tensor at all (found by the async lap
    on the H100), and on the CPU it promoted the words to int64."""
    from orb_slam2_detailed_comments_tpu_torch.interop import desc_to_numpy, desc_to_torch
    from orb_slam2_detailed_comments_tpu_torch.state.frame import FrameData
    cfg = slam_config_from_jax(SYS._config("stereo"))
    trk = TT.Tracker(cfg, MapStore(cfg), TT.Sensor.STEREO, device="cpu")
    n = cfg.orb.max_keypoints
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    lf = FrameData(frame_id=0, timestamp=0.0, xy=rng.uniform(0, 300, (n, 2)).astype(np.float32),
                   response=np.ones(n, np.float32), octave=np.zeros(n, np.int32),
                   angle=np.zeros(n, np.float32), desc=desc_to_torch(words, "cpu"),
                   valid=np.ones(n, bool), ur=np.full(n, 100.0, np.float32),
                   depth=np.full(n, 2.0, np.float32), Tcw=np.eye(4, dtype=np.float32),
                   mp=np.full(n, -1, np.int32))
    lf.is_outlier = np.zeros(n, bool)
    _, _, _, _, desc, has, _ = trk._last_frame_point_set(lf)
    assert has.all() and desc.dtype == np.uint32
    np.testing.assert_array_equal(desc, words)
    np.testing.assert_array_equal(desc_to_numpy(desc_to_torch(words, "cpu")), words)


def _blank_frame(cfg, frame_id, Tcw):
    from orb_slam2_detailed_comments_tpu_torch.state.frame import FrameData
    n = cfg.orb.max_keypoints
    f = FrameData(frame_id=frame_id, timestamp=0.1 * frame_id, xy=np.zeros((n, 2), np.float32),
                  response=np.ones(n, np.float32), octave=np.zeros(n, np.int32),
                  angle=np.zeros(n, np.float32), desc=np.zeros((n, 8), np.uint32),
                  valid=np.zeros(n, bool), ur=np.full(n, -1.0, np.float32),
                  depth=np.full(n, -1.0, np.float32), Tcw=Tcw.astype(np.float32),
                  mp=np.full(n, -1, np.int32))
    f.is_outlier = np.zeros(n, bool)
    return f


def test_last_frame_rides_a_map_move_between_frames():
    """A whole-map move (pose_epoch: a loop correction, a global-BA merge)
    after the last frame was logged re-poses it on its reference keyframe,
    as the reference's UpdateLastFrame does; a move inside the frame's own
    call (the synchronous pipeline, before the frame is logged) and a local
    BA between frames leave it as the JAX package's tracker does."""
    cfg = slam_config_from_jax(SYS._config("stereo"))
    ms = MapStore(cfg)
    trk = TT.Tracker(cfg, ms, TT.Sensor.STEREO, device="cpu")
    kf = ms.add_keyframe(_blank_frame(cfg, 0, np.eye(4)))
    T_last = np.eye(4, dtype=np.float32)
    T_last[:3, 3] = [0.1, 0.0, -0.5]
    lf = _blank_frame(cfg, 1, T_last)
    lf.ref_kf = kf
    ms.kf_Tcw[kf, 0, 3] = 0.3           # a move inside the frame's own call
    ms.pose_epoch += 1
    trk._log_trajectory(lf, lost=False)
    trk.last_frame = lf
    trk._update_last_frame()
    np.testing.assert_array_equal(lf.Tcw, T_last)
    T_ref = ms.kf_Tcw[kf].copy()
    ms.kf_Tcw[kf, 1, 3] = 0.01          # a local BA between frames
    trk._update_last_frame()
    np.testing.assert_array_equal(lf.Tcw, T_last)
    move = np.eye(4, dtype=np.float32)
    move[:3, 3] = [2.0, 0.0, 1.0]       # a loop correction
    ms.kf_Tcw[kf] = move @ ms.kf_Tcw[kf]
    ms.pose_epoch += 1
    trk._update_last_frame()
    np.testing.assert_allclose(lf.Tcw, T_last @ np.linalg.inv(T_ref) @ ms.kf_Tcw[kf], atol=1e-6)
    again = lf.Tcw.copy()
    trk._update_last_frame()            # once per move
    np.testing.assert_array_equal(lf.Tcw, again)


@pytest.mark.parametrize("waiting", [True, False])
def test_mapper_defers_fusion_ba_and_culling_while_keyframes_wait(waiting):
    """While another keyframe waits in the queue, the reference's
    LocalMapping::Run leaves the neighbour fusion, the local BA and the
    keyframe culling to a later keyframe; culling, triangulation and loop
    closing still run."""
    cfg, ms = _port_loop(17)
    mapper = TLM.LocalMapper(cfg, ms, monocular=True, device="cpu")
    mapper.abort_ba_check = lambda: waiting
    kf = int(ms.keyframe_ids()[-2])
    built = mapper.prepare_keyframe(kf)
    mapper.finish_keyframe(kf)
    counts = mapper.timer.counts
    assert counts["point_culling"] == counts["triangulation"] == 1
    assert (built is None) == waiting and mapper.n_kf_deferred == int(waiting)
    for stage in ("fusion", "local_ba_build", "keyframe_culling"):
        assert counts[stage] == int(not waiting), stage


@pytest.mark.parametrize("busy", [True, False])
def test_tracker_reset_under_the_map_lock_voids_the_queue_without_waiting(busy):
    """The tracker resets inside a frame's call, under the map lock (LOST
    with a tiny map, a rejected monocular initialization). With one
    keyframe in its off-lock solve and two queued, the reset must neither
    wait for the worker, which needs that lock to go on, nor let it map
    the old map's keyframes into the new one; with the worker idle, the
    new map's first keyframe is mapped as any other."""

    class Stub:
        device = torch.device("cpu")
        abort_ba_check = None

        def __init__(self):
            self.pending, self.prepared, self.finished, self.resets = set(), [], [], 0

        def prepare_keyframe(self, kf, run_ba=True):
            self.prepared.append(kf)
            return kf

        def _solve_local_ba(self, built):
            in_solve.set()
            release.wait(WAIT_S)
            return built

        def _merge_local_ba(self, built, result):
            pass

        def finish_keyframe(self, kf):
            self.finished.append(kf)

        def reset(self):
            self.resets += 1

    in_solve, release = threading.Event(), threading.Event()
    if not busy:
        release.set()
    lock = threading.RLock()
    stub = Stub()
    amapper = AsyncLocalMapper(stub, lock)
    cfg = slam_config_from_jax(SYS._config("stereo"))
    trk = TT.Tracker(cfg, MapStore(cfg), TT.Sensor.STEREO, local_mapper=amapper, device="cpu")
    trk.map_lock = lock
    try:
        if busy:
            with lock:
                amapper.on_new_keyframe(0)
            assert in_solve.wait(WAIT_S)
        with lock:                      # the tracker's frame: more keyframes, then a reset
            if busy:
                amapper.on_new_keyframe(1)
                amapper.on_new_keyframe(2)
            t0 = time.monotonic()
            trk.reset()
            assert time.monotonic() - t0 < 5.0
            assert not stub.pending and stub.resets == 1
            amapper.on_new_keyframe(0)  # the new map's first keyframe
        release.set()
        amapper.wait_idle(WAIT_S)
    finally:
        release.set()
        amapper.shutdown(WAIT_S)
    assert stub.prepared == ([0, 0] if busy else [0]) and stub.finished == [0]
    assert amapper.n_processed == 1 and amapper._pending == 0


def _fire_auto_reset(trk, cfg):
    """The tracker's LOST auto-reset (reference: Tracking.cc:744-753): LOST
    for a second with at most five live keyframes, then one more frame that
    does not relocalize. Call under the map lock, as a frame does."""
    ms = trk.map
    ms.kf_valid[ms.keyframe_ids()[5:]] = False
    trk.state = TT.TrackingState.LOST
    trk._lost_streak = int(cfg.fps)
    assert trk._track(_blank_frame(cfg, 1000, np.eye(4))) is None
    assert trk.state == TT.TrackingState.NOT_INITIALIZED and ms.n_keyframes() == 0


def test_auto_reset_stops_a_running_global_ba():
    """ROADMAP.md C.19: the tracker's auto-reset, under the map lock, must
    stop a global BA still solving on the runner's thread without waiting
    for it, so that nothing of the old map's solve merges into the new map."""
    cfg, ms = _port_loop(21, jitter_m=0.02)
    lock = threading.RLock()
    runner = _async_runner(cfg, ms, lock)
    trk = TT.Tracker(cfg, ms, TT.Sensor.STEREO, device="cpu")
    trk.map_lock, trk.gba_runner = lock, runner
    in_solve, release = threading.Event(), threading.Event()
    runner._chunk_hook = lambda: (in_solve.set(), release.wait(WAIT_S))
    runner.launch(n_iters=GBA_ITERS)
    try:
        assert in_solve.wait(WAIT_S)
        with lock:                      # the tracker's frame
            t0 = time.monotonic()
            _fire_auto_reset(trk, cfg)
            assert time.monotonic() - t0 < 5.0
            # the new map's first keyframes reuse the old ids 0 and 1
            for i in range(2):
                ms.add_keyframe(_blank_frame(cfg, 1001 + i, np.eye(4)))
            poses = ms.kf_Tcw.copy()
        release.set()
        runner.wait(WAIT_S)
    finally:
        release.set()
        runner.wait(WAIT_S)
    assert not runner.running()
    assert runner.n_aborted == 1 and runner.n_completed == 0
    np.testing.assert_array_equal(ms.kf_Tcw, poses)


def test_auto_reset_keeps_the_keyframe_database_and_the_loop_closer():
    """ROADMAP.md known fault 9, copied from the JAX package for parity (its
    Tracker.reset, frontend/tracking.py:458-473, is the port's): the
    reference's Tracking::Reset also clears the keyframe database and
    resets loop closing; the tracker's auto-reset leaves both, so the old
    map's keyframe ids stay in the database's inverted index and in the
    loop closer's bags and consistency groups until a new keyframe of the
    same id replaces them. System.reset clears them."""
    cfg = slam_config_from_jax(SYS._config("stereo"))
    slam = TS.System(cfg, TT.Sensor.STEREO, device="cpu")
    bow = np.zeros(slam.voc.n_words, np.float32)
    bow[[3, 7, 11]] = 1.0
    lc = slam.loop_closer
    for k in range(2):
        slam.kfdb.add(k, bow)
        lc.kf_bow[k] = (np.nonzero(bow)[0], bow[bow > 0])
    lc.consistent_groups.append(({0, 1}, 1))
    _fire_auto_reset(slam.tracker, cfg)
    assert slam.kfdb.active[:2].all() and len(slam.kfdb.inv[3]) == 2
    assert set(lc.kf_bow) == {0, 1} and lc.consistent_groups
    slam.reset()
    assert not slam.kfdb.active.any() and not lc.kf_bow and not lc.consistent_groups


def test_keyframe_points_follow_numpys_sort_over_tied_depths():
    """ROADMAP.md C.23 and known fault 10, copied from the JAX package for
    parity (frontend/tracking.py:981-985 there): a stereo or RGB-D
    keyframe spawns points at its unmatched keypoints nearest first, at
    least 100, in the order of numpy's default argsort over their depths.
    RGB-D depths are quantized (16-bit PNG), so they tie, and that sort is
    not stable: which tied keypoints make the 100 depends on the numpy
    build (its SIMD sort), so one sequence maps differently on two
    machines. The kept set is numpy's, and only ties decide it."""
    cfg = slam_config_from_jax(SYS._config("rgbd"))
    trk = TT.Tracker(cfg, MapStore(cfg), TT.Sensor.RGBD, device="cpu")
    rng = np.random.default_rng(5)
    f = _blank_frame(cfg, 0, np.eye(4))
    n = 300
    f.valid[:n] = True
    f.xy[:n] = rng.uniform([10, 10], [310, 230], (n, 2)).astype(np.float32)
    f.depth[:n] = (8.0 + 0.0002 * rng.integers(0, 4, n)).astype(np.float32)  # beyond th_depth
    trk._create_new_keyframe(f)
    made = np.nonzero(f.mp >= 0)[0]
    cand = np.arange(n)
    assert sorted(made.tolist()) == sorted(cand[np.argsort(f.depth[cand])][:100].tolist())
    d100 = np.sort(f.depth[:n])[99]
    assert (f.depth[made] <= d100).all() and (f.depth[np.setdiff1d(cand, made)] >= d100).all()


def test_bench_e2e_ate_snapshot_is_a_copy():
    """tools/bench_e2e.py reads the exported ATE around a loop correction
    from copies taken inside the timed call and evaluated after the run: a
    later move of the map must not reach a snapshot already taken."""
    import importlib.util
    import types
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "bench_e2e", Path(__file__).resolve().parents[1] / "tools" / "bench_e2e.py")
    e2e = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(e2e)
    cfg = slam_config_from_jax(SYS._config("stereo"))
    ms = MapStore(cfg)
    poses = []
    for i in range(6):                  # two keyframes, three frames on each
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.3 * i, 0.05 * i * i, 1.0 * i]
        poses.append(T)
    kfs = [ms.add_keyframe(_blank_frame(cfg, 3 * j, poses[3 * j])) for j in range(2)]
    trajectory = [(i, 0.1 * i, poses[i] @ np.linalg.inv(poses[3 * (i // 3)]), kfs[i // 3], False)
                  for i in range(6)]
    slam = types.SimpleNamespace(map=ms, tracker=types.SimpleNamespace(trajectory=trajectory))
    before = e2e.trajectory_snapshot(slam)
    ms.kf_Tcw[kfs[1], 0, 3] += 0.5      # a correction moves the second keyframe
    ate0, n0, _ = e2e.exported_errors(before, poses)
    ate1, n1, _ = e2e.exported_errors(e2e.trajectory_snapshot(slam), poses)
    assert n0 == n1 == 6 and ate0 < 1e-5 < 0.1 < ate1


@pytest.mark.parametrize("sensor, idle, since_kf, queued, expected", [
    ("stereo", True, 1, 0, True),       # idle worker: the ratio test alone decides (c1b)
    ("stereo", False, 1, 0, False),     # busy: no c1b; the JAX rule ("< 3 queued") said yes
    ("stereo", False, "max", 2, True),  # busy, max_frames since the last keyframe (c1a)
    ("stereo", False, "max", 3, False),  # ... but three already wait (Tracking.cc:1744-1760)
    ("mono", False, "max", 0, False),   # a busy mapper never takes a mono keyframe
])
def test_tracker_inserts_at_the_workers_pace(sensor, idle, since_kf, queued, expected):
    """The tracker's side of the back-pressure (reference:
    Tracking::NeedNewKeyFrame, Tracking.cc:1600-1760, with
    AcceptKeyFrames false while the mapper works): a frame that tracks
    half of its reference keyframe's points asks for a keyframe, which a
    busy worker takes only after max_frames frames and while fewer than
    three keyframes wait, and never in mono."""

    class Mapper:
        def accept_keyframes(self):
            return idle

        def queue_len(self):
            return queued

    cfg = slam_config_from_jax(SYS._config(sensor))
    ms = MapStore(cfg)
    sens = TT.Sensor.STEREO if sensor == "stereo" else TT.Sensor.MONOCULAR
    trk = TT.Tracker(cfg, ms, sens, local_mapper=Mapper(), device="cpu")
    kf = ms.add_keyframe(_blank_frame(cfg, 0, np.eye(4)))
    ids = ms.add_map_points_batch(np.random.default_rng(0).normal(0, 1, (100, 3)).astype(np.float32),
                                  kf, np.arange(100))
    trk.last_kf_id, trk.last_kf_frame_id = kf, 0
    fid = cfg.max_frames if since_kf == "max" else since_kf
    frame = _blank_frame(cfg, fid, np.eye(4))
    frame.ref_kf = kf
    frame.mp[:50] = ids[:50]            # 50 of the reference's 100 points: the ratio test asks
    assert trk._need_new_keyframe(frame) is expected


def test_async_mapper_passes_the_mappers_surface_through():
    """System.load_map and the loop closer set and read the mapper's map and
    loop closer through the wrapper; the rest of the LocalMapper surface
    (counters, _fuse) reads through to the wrapped mapper."""
    cfg = slam_config_from_jax(SYS._config("stereo"))
    mapper = TLM.LocalMapper(cfg, MapStore(cfg), monocular=False, device="cpu")
    amapper = AsyncLocalMapper(mapper, threading.RLock())
    try:
        ms2, lc = MapStore(cfg), object()
        amapper.map, amapper.loop_closer = ms2, lc
        assert mapper.map is ms2 and amapper.map is ms2
        assert mapper.loop_closer is lc and amapper.loop_closer is lc
        mapper.n_ba_stale = 3
        assert amapper.n_ba_stale == 3 and amapper.kf_counter == 0
    finally:
        amapper.shutdown(WAIT_S)
    assert not amapper._thread.is_alive()
