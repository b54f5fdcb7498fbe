"""Parity of the port's loop closing (backend/loop_closing.py and the
inline backend/gba_runner.py) with the JAX package's, on the CPU.

The maps are the JAX package's own fixtures: test_loop_closing.py's
drifted loop (14 keyframes circling back to the first segment's points)
and its essential-graph world (40 keyframes, strong cross-loop links),
handed to the port by interop.map_store_from_jax, the vocabulary by
vocabulary_from_jax. Each step starts both packages from one state:

  * on_new_keyframe over all keyframes: the same results, candidates,
    consistency groups and bags;
  * _compute_sim3(last, [0]): the same loop keyframe and loop points,
    S_cl within SIM3_TOL;
  * _count_projection_matches: the three counts of TestLoopAcceptanceCount
    equal;
  * _correct_loop with one S_cl: poses within POSE_TOL, points within
    PT_TOL m, the same loop edges;
  * _optimize_essential_graph on TestLoopConnectionEdgeClass's world,
    seeds 5 and 9, with the fusion's loop connections: the mean and pair
    translation errors within GRAPH_TOL m;
  * GlobalBARunner.launch on one drifted loop, with a keyframe, a point
    and a recycled point slot made between the snapshot and the merge:
    the same snapshot problem, and from one solve's output (the JAX
    package's) poses within POSE_TOL and points within PT_TOL m.

Then the port alone: the inline GlobalBARunner against LocalMapper.global_ba,
its staged propagation and the recycled-slot guard (test_gba_runner.py's
three cases), a global BA on a loop without a runner, the threaded modes'
wiring (the threaded runner needs the map lock), and ROADMAP.md
C.11: with vocabulary="online" the JAX System stores dense bags that its
_detect_loop cannot unpack; the port stores them sparse.
"""
import contextlib
import copy

import numpy as np
import pytest
import torch

from orb_slam2_detailed_comments_tpu.backend import gba_runner as JR
from orb_slam2_detailed_comments_tpu.backend.local_mapping import LocalMapper as JMapper
from orb_slam2_detailed_comments_tpu.backend.loop_closing import LoopCloser as JCloser
from orb_slam2_detailed_comments_tpu.place.kf_database import KeyFrameDatabase as JDB
from orb_slam2_detailed_comments_tpu.place.vocabulary import BinaryVocabulary as JVoc
from orb_slam2_detailed_comments_tpu.system import System as JSystem
from orb_slam2_detailed_comments_tpu.frontend.tracking import Sensor as JSensor
from orb_slam2_detailed_comments_tpu.state.frame import FrameData as JFrameData

from orb_slam2_detailed_comments_tpu_torch.backend import gba_runner as TR
from orb_slam2_detailed_comments_tpu_torch.backend.local_mapping import (
    LocalMapper as TMapper, solve_global_ba)
from orb_slam2_detailed_comments_tpu_torch.backend.loop_closing import LoopCloser as TCloser
from orb_slam2_detailed_comments_tpu_torch.frontend.tracking import Sensor as TSensor
from orb_slam2_detailed_comments_tpu_torch.geometry.sim3 import sim3_to_se3
from orb_slam2_detailed_comments_tpu_torch.interop import (
    map_store_from_jax, slam_config_from_jax, vocabulary_from_jax)
from orb_slam2_detailed_comments_tpu_torch.place.kf_database import KeyFrameDatabase as TDB
from orb_slam2_detailed_comments_tpu_torch.state.frame import FrameData
from orb_slam2_detailed_comments_tpu_torch.system import System as TSystem

import test_loop_closing as JT
from test_loop_closing import build_drifted_loop

SIM3_TOL, POSE_TOL, PT_TOL, GRAPH_TOL = 1e-4, 1e-4, 1e-3, 1e-4
GBA_ITERS = 2   # the port's global BA on the CPU takes ~1 s an iteration here


@pytest.fixture(scope="module")
def drifted():
    """The drifted loop, its JAX vocabulary and the port's copy of it."""
    cfg, ms, gt, _ = build_drifted_loop()
    voc = JVoc.train(ms.kf_desc[ms.kf_kp_valid], n_words=512, n_iters=2)
    return cfg, ms, gt, voc, vocabulary_from_jax(voc, "cpu")


def _closers(drifted, ms=None):
    """A JAX and a port LoopCloser over copies of one map (monocular
    mappers for the fusion, no global BA), as TestLoopClosing builds it."""
    cfg, ms0, _, voc, tvoc = drifted
    jms = copy.deepcopy(ms if ms is not None else ms0)
    tms = map_store_from_jax(jms)
    tcfg = slam_config_from_jax(cfg)
    j = JCloser(cfg, jms, voc, JDB(voc, cfg.max_keyframes), fix_scale=False,
                local_mapper=JMapper(cfg, jms, monocular=True), run_global_ba=False)
    t = TCloser(tcfg, tms, tvoc, TDB(tvoc, cfg.max_keyframes), fix_scale=False,
                local_mapper=TMapper(tcfg, tms, monocular=True, device="cpu"),
                run_global_ba=False, device="cpu")
    return j, t


def _record_candidates(lc):
    seen = []
    detect = lc._detect_loop

    def hook(kf, bow):
        out = detect(kf, bow)
        seen.append((kf, list(out), [(sorted(g), c) for g, c in lc.consistent_groups]))
        return out

    lc._detect_loop = hook
    return seen


def test_on_new_keyframe_matches_jax(drifted):
    j, t = _closers(drifted)
    seen_j, seen_t = _record_candidates(j), _record_candidates(t)
    kfs = [int(k) for k in j.map.keyframe_ids()]
    res_j = [j.on_new_keyframe(k) for k in kfs]
    res_t = [t.on_new_keyframe(k) for k in kfs]
    assert res_t == res_j and not any(res_j[:-1])
    assert seen_t == seen_j
    assert any(groups for _, _, groups in seen_j)       # the chains were exercised
    for k in kfs:
        np.testing.assert_array_equal(t.kf_bow[k][0], j.kf_bow[k][0])
        np.testing.assert_allclose(t.kf_bow[k][1], j.kf_bow[k][1], rtol=1e-6)
    np.testing.assert_array_equal(t.kfdb.active, j.kfdb.active)
    assert set(t.timer.counts) == {"detect"} and t.timer.counts["detect"] == len(kfs)


@pytest.fixture(scope="module")
def sim3(drifted):
    """_compute_sim3(last, [0]) of both packages from one map."""
    j, t = _closers(drifted)
    kf = int(j.map.keyframe_ids()[-1])
    return kf, j, t, j._compute_sim3(kf, [0]), t._compute_sim3(kf, [0])


def test_compute_sim3_matches_jax(sim3):
    kf, _, _, out_j, out_t = sim3
    assert out_j is not None and out_t is not None
    assert out_t[0] == out_j[0] == 0
    np.testing.assert_array_equal(out_t[2], out_j[2])
    np.testing.assert_allclose(out_t[1], np.asarray(out_j[1]), atol=SIM3_TOL)


def test_projection_counts_match_jax(sim3):
    kf, j, t, out_j, _ = sim3
    loop_kf, S_cl, loop_points = out_j
    Scw = (np.asarray(S_cl) @ j.map.kf_Tcw[loop_kf]).astype(np.float32)
    all_kp = np.nonzero(j.map.kf_kp_valid[kf])[0]
    counts = []
    for lc in (j, t):
        counts.append([lc._count_projection_matches(kf, loop_points, Scw, pre)
                       for pre in (None, all_kp, all_kp[:10])])
    assert counts[1] == counts[0]
    assert counts[0][0] > 0 and counts[0][1] == len(all_kp)


def test_correct_loop_matches_jax(drifted, sim3):
    kf, _, _, out_j, _ = sim3
    loop_kf, S_cl, loop_points = out_j
    j, t = _closers(drifted)
    S_cl = np.asarray(S_cl, np.float32)
    j._correct_loop(kf, loop_kf, S_cl, loop_points)
    t._correct_loop(kf, loop_kf, S_cl, loop_points)
    jm, tm = j.map, t.map
    np.testing.assert_array_equal(tm.kf_valid, jm.kf_valid)
    kfs = jm.keyframe_ids()
    np.testing.assert_allclose(tm.kf_Tcw[kfs], jm.kf_Tcw[kfs], atol=POSE_TOL)
    np.testing.assert_array_equal(tm.mp_valid, jm.mp_valid)
    np.testing.assert_array_equal(tm.kf_mp, jm.kf_mp)
    live = jm.mp_valid
    assert np.abs(tm.mp_pos[live] - jm.mp_pos[live]).max() < PT_TOL
    assert tm.loop_edges == jm.loop_edges == {(0, kf)}
    assert t.n_loops_closed == j.n_loops_closed == 1
    assert t.last_graph[0] == "dense" and t.last_graph[1] == len(kfs)
    assert {"correct", "essential_graph"} <= set(t.timer.counts)


def _essential_graph(lc_cls, ms, gt, est, n_cross=4, **kw):
    """TestLoopConnectionEdgeClass._close(True) on a given LoopCloser class
    and map: the exact loop Sim3, the corrected group, strong cross-loop
    links, then _optimize_essential_graph with them. Returns (mean
    translation error, pair error) against the ground truth."""
    n = JT.TestLoopConnectionEdgeClass.N
    kf, loop_kf = n - 1, 0
    S_cl = (gt[kf] @ np.linalg.inv(gt[0])).astype(np.float32)
    Scw_corr = (S_cl @ ms.kf_Tcw[loop_kf]).astype(np.float32)
    group = [kf - i for i in range(1 + n_cross)]
    T_w_cur = np.linalg.inv(est[kf]).astype(np.float32)
    corrected, uncorrected = {}, {}
    for g in group:
        uncorrected[g] = est[g].copy()
        corrected[g] = ((est[g] @ T_w_cur) @ Scw_corr).astype(np.float32)
    for g in group:
        ms.kf_Tcw[g] = sim3_to_se3(torch.from_numpy(corrected[g])).numpy()
    loop_connections = {kf: {loop_kf}}
    for i in range(1, 1 + n_cross):
        ms.covis[kf - i, i] = ms.covis[i, kf - i] = 150
        loop_connections[kf - i] = {i}
    lc = lc_cls(ms.config, ms, None, None, fix_scale=True, run_global_ba=False, **kw)
    lc._optimize_essential_graph(kf, loop_kf, corrected, uncorrected, loop_connections)
    t_err = np.linalg.norm(np.stack([np.linalg.inv(ms.kf_Tcw[k])[:3, 3] for k in range(n)])
                           - np.stack([np.linalg.inv(gt[k])[:3, 3] for k in range(n)]), axis=1)
    pair = [np.linalg.norm((ms.kf_Tcw[i] @ np.linalg.inv(ms.kf_Tcw[kf - i]))[:3, 3]
                           - (gt[i] @ np.linalg.inv(gt[kf - i]))[:3, 3])
            for i in range(1, 1 + n_cross)]
    return float(t_err.mean()), float(np.mean(pair))


@pytest.mark.parametrize("seed", [5, 9])
def test_essential_graph_matches_jax(seed):
    _, ms, gt, est = JT.TestLoopConnectionEdgeClass()._world(seed=seed)
    err_t = _essential_graph(TCloser, map_store_from_jax(ms), gt, est, device="cpu")
    err_j = _essential_graph(JCloser, ms, gt, est)
    np.testing.assert_allclose(err_t, err_j, atol=GRAPH_TOL)


def _grow_after_snapshot(runner, frame_cls):
    """Make runner.launch's snapshot go stale as a running mapper would make
    it: right after the snapshot, a child keyframe of the last keyframe with
    a point of its own (the merge propagates both through the spanning
    tree), and a snapshot point erased and its slot recycled (the merge's
    first-keyframe guard keeps the solved position off it)."""
    take = runner._snapshot

    def snapshot():
        snap = take()
        ms = runner.map
        parent = int(ms.keyframe_ids()[-1])
        kp_cap = ms.config.orb.max_keypoints
        rel = np.eye(4, dtype=np.float32)
        rel[:3, 3] = [0.05, 0.0, 0.1]
        child_pose = (rel @ ms.kf_Tcw[parent]).astype(np.float32)
        frame = frame_cls(frame_id=999, timestamp=99.0, xy=np.zeros((kp_cap, 2), np.float32),
                          response=np.zeros(kp_cap, np.float32),
                          octave=np.zeros(kp_cap, np.int32), angle=np.zeros(kp_cap, np.float32),
                          desc=np.zeros((kp_cap, 8), np.uint32), valid=np.zeros(kp_cap, bool),
                          ur=np.full(kp_cap, -1.0, np.float32),
                          depth=np.full(kp_cap, -1.0, np.float32), Tcw=child_pose.copy())
        child = ms.add_keyframe(frame)
        ms.parent[child] = parent
        Twc = np.linalg.inv(child_pose)
        pw = (Twc[:3, :3] @ np.array([0.3, -0.2, 5.0], np.float32) + Twc[:3, 3]).astype(np.float32)
        ms.add_observation(ms.add_map_point(pw, child), child, 0)
        ms.erase_map_point(int(snap["pts"][10]))
        reborn = ms.add_map_point(np.array([9.0, 9.0, 9.0], np.float32), parent, first_kf=parent)
        assert reborn == int(snap["pts"][10])
        return snap

    runner._snapshot = snapshot


def test_runner_launch_matches_jax(monkeypatch):
    """Both runners' launch on copies of one drifted loop, its keyframe
    centres first moved 2 cm (seeded) so that the merge carries real
    corrections. The loop sees each point from one keyframe, monocularly,
    so its global BA has no unique answer and two float orders part by
    centimetres: the port's solve is handed the JAX solve's output after
    its problem is checked equal to the JAX one (the solvers are held
    against each other in test_torch_local_ba.py and
    test_torch_global_ba_grouped.py)."""
    cfg, jms, _, _ = build_drifted_loop(seed=3)
    kfs = jms.keyframe_ids()
    jms.kf_Tcw[kfs[1:], :3, 3] += np.random.default_rng(3).normal(
        0.0, 0.02, (len(kfs) - 1, 3)).astype(np.float32)
    before = jms.kf_Tcw[kfs].copy()
    tms = map_store_from_jax(jms)
    solved = []

    def jax_solve(prob, *a, **k):
        out = solve_j(prob, *a, **k)
        solved.append((prob, out))
        return out

    def port_solve(prob, camera, inv_sigma2, n_iters=10, stop_check=None):
        jprob, (cam, pts) = solved[0]
        for f in jprob._fields:
            np.testing.assert_array_equal(getattr(prob, f).numpy(), np.asarray(getattr(jprob, f)))
        assert n_iters == GBA_ITERS and stop_check is None
        return np.asarray(cam), np.asarray(pts)

    solve_j = JR.solve_global_ba
    monkeypatch.setattr(JR, "solve_global_ba", jax_solve)
    monkeypatch.setattr(TR, "solve_global_ba", port_solve)
    j = JR.GlobalBARunner(cfg, jms, contextlib.nullcontext())
    t = TR.GlobalBARunner(slam_config_from_jax(cfg), tms, device="cpu")
    _grow_after_snapshot(j, JFrameData)
    _grow_after_snapshot(t, FrameData)
    j.launch(n_iters=GBA_ITERS)
    t.launch(n_iters=GBA_ITERS)
    assert t.n_completed == j.n_completed == 1 and 0 < t.last_edges < 4096
    np.testing.assert_array_equal(tms.kf_valid, jms.kf_valid)
    moved = np.abs(tms.kf_Tcw[kfs] - before)[:, :3, 3].max(axis=1)
    assert (moved[1:] > 10 * POSE_TOL).all()                 # the solve moved every free pose
    kfs = jms.keyframe_ids()                                  # and the child keyframe
    np.testing.assert_allclose(tms.kf_Tcw[kfs], jms.kf_Tcw[kfs], atol=POSE_TOL)
    np.testing.assert_array_equal(tms.mp_valid, jms.mp_valid)
    live = jms.mp_valid
    assert np.abs(tms.mp_pos[live] - jms.mp_pos[live]).max() < PT_TOL


# ---- the port alone --------------------------------------------------------------

def _port_loop(seed):
    cfg, ms, gt, est = build_drifted_loop(seed=seed)
    return slam_config_from_jax(cfg), map_store_from_jax(ms)


def test_inline_runner_matches_direct_global_ba():
    cfg, ms_a = _port_loop(3)
    _, ms_b = _port_loop(3)
    TMapper(cfg, ms_a, monocular=True, device="cpu").global_ba(n_iters=GBA_ITERS)
    runner = TR.GlobalBARunner(cfg, ms_b, device="cpu")
    runner.launch(n_iters=GBA_ITERS)
    kfs = ms_a.keyframe_ids()
    np.testing.assert_allclose(ms_a.kf_Tcw[kfs], ms_b.kf_Tcw[kfs], atol=1e-4)
    valid = ms_a.mp_valid & ms_b.mp_valid
    np.testing.assert_allclose(ms_a.mp_pos[valid], ms_b.mp_pos[valid], atol=1e-4)
    assert runner.n_completed == 1 and runner.last_edges > 0


def test_staged_propagation_to_a_new_keyframe_and_point():
    """Keyframes and points made between snapshot and merge ride the
    correction (reference: LoopClosing.cc:1128-1223): the child's pose is
    its pose relative to its parent on the parent's new pose, a new point
    is carried rigidly by its reference keyframe."""
    cfg, ms = _port_loop(5)
    runner = TR.GlobalBARunner(cfg, ms, device="cpu")
    snap = runner._snapshot()
    parent = int(ms.keyframe_ids()[-1])
    kp_cap = cfg.orb.max_keypoints
    rel = np.eye(4, dtype=np.float32)
    rel[:3, 3] = [0.05, 0.0, 0.1]
    child_pose = (rel @ ms.kf_Tcw[parent]).astype(np.float32)
    frame = FrameData(frame_id=999, timestamp=99.0, xy=np.zeros((kp_cap, 2), np.float32),
                      response=np.zeros(kp_cap, np.float32), octave=np.zeros(kp_cap, np.int32),
                      angle=np.zeros(kp_cap, np.float32), desc=np.zeros((kp_cap, 8), np.uint32),
                      valid=np.zeros(kp_cap, bool), ur=np.full(kp_cap, -1.0, np.float32),
                      depth=np.full(kp_cap, -1.0, np.float32), Tcw=child_pose.copy())
    child = ms.add_keyframe(frame)
    ms.parent[child] = parent
    Twc = np.linalg.inv(child_pose)
    pw = (Twc[:3, :3] @ np.array([0.3, -0.2, 5.0], np.float32) + Twc[:3, 3]).astype(np.float32)
    new_pt = ms.add_map_point(pw, child)
    ms.add_observation(new_pt, child, 0)
    pc_before = child_pose[:3, :3] @ ms.mp_pos[new_pt] + child_pose[:3, 3]
    runner._merge(snap, *solve_global_ba(snap["prob"], cfg.camera, runner.inv_sigma2,
                                         n_iters=GBA_ITERS))
    np.testing.assert_allclose(ms.kf_Tcw[child], rel @ ms.kf_Tcw[parent], atol=1e-5)
    pc_after = ms.kf_Tcw[child][:3, :3] @ ms.mp_pos[new_pt] + ms.kf_Tcw[child][:3, 3]
    np.testing.assert_allclose(pc_after, pc_before, atol=1e-4)


def test_recycled_point_slot_is_not_clobbered():
    cfg, ms = _port_loop(6)
    runner = TR.GlobalBARunner(cfg, ms, device="cpu")
    snap = runner._snapshot()
    victim = int(snap["pts"][10])
    ms.erase_map_point(victim)
    last = int(ms.keyframe_ids()[-1])
    reborn = ms.add_map_point(np.array([9.0, 9.0, 9.0], np.float32), last, first_kf=last)
    assert reborn == victim  # the free list recycles the slot
    result = solve_global_ba(snap["prob"], cfg.camera, runner.inv_sigma2, n_iters=GBA_ITERS)
    pos_before = ms.mp_pos[reborn].copy()
    runner._merge(snap, *result)
    staged = result[1][10]
    assert not np.allclose(staged, pos_before, atol=1e-3)
    assert not np.allclose(ms.mp_pos[reborn], staged, atol=1e-3)


def test_global_ba_on_a_loop_needs_a_runner(drifted):
    cfg, ms, _, _, tvoc = drifted
    tcfg = slam_config_from_jax(cfg)
    with pytest.raises(ValueError, match="gba_runner"):
        TCloser(tcfg, map_store_from_jax(ms), tvoc, TDB(tvoc, cfg.max_keyframes),
                fix_scale=False, device="cpu")


def test_threaded_modes_raise():
    """The name predates the threaded modes, which raised here. The threaded
    runner needs the map lock; with it, and in System(async_mapping=True),
    the runner, the mapping worker, the tracker and the loop closer share
    one lock (tests/test_torch_async.py drives them)."""
    import threading
    from orb_slam2_detailed_comments_tpu_torch.backend.async_pipeline import AsyncLocalMapper
    cfg, ms = _port_loop(0)
    with pytest.raises(ValueError, match="map lock"):
        TR.GlobalBARunner(cfg, ms, async_mode=True, device="cpu")
    lock = threading.RLock()
    runner = TR.GlobalBARunner(cfg, ms, async_mode=True, device="cpu", map_lock=lock)
    assert runner.async_mode and runner.lock is lock and not runner.running()
    slam = TSystem(cfg, TSensor.RGBD, async_mapping=True, device="cpu")
    try:
        assert isinstance(slam.local_mapper, AsyncLocalMapper) and slam.gba_runner.async_mode
        assert slam.loop_closer.local_mapper is slam.local_mapper
        assert slam.loop_closer.gba_runner is slam.gba_runner
        assert slam.tracker.map_lock is slam.local_mapper.lock is slam.gba_runner.lock
    finally:
        slam.shutdown()
    assert not slam.local_mapper._thread.is_alive()


def test_online_vocabulary_keeps_sparse_bags(drifted):
    """ROADMAP.md C.11: with vocabulary="online" and loop closing on, the
    JAX System stores each indexed keyframe's bag dense, and _detect_loop
    of a keyframe >= 10 whose covisible set holds one cannot unpack it. The
    port stores the (ids, weights) pair on both paths."""
    cfg, ms0, _, _, _ = drifted
    kf = int(ms0.keyframe_ids()[-2])       # 12: covisible with 11, indexed at training
    assert kf >= 10 and len(ms0.get_covisible(kf))
    tcfg = slam_config_from_jax(cfg)
    js = JSystem(cfg, JSensor.MONOCULAR, vocabulary="online")
    ts = TSystem(tcfg, TSensor.MONOCULAR, vocabulary="online", device="cpu")
    for slam, ms in ((js, ms0), (ts, map_store_from_jax(ms0))):
        vars(slam.map).update({k: v for k, v in vars(ms).items() if k != "config"})
        slam._maybe_train_vocabulary()
    _, bow = js.voc.transform(js.map.kf_desc[kf], js.map.kf_kp_valid[kf])
    with pytest.raises(ValueError, match="unpack"):
        js.loop_closer._detect_loop(kf, bow)
    lc = ts.loop_closer
    assert lc is ts.local_mapper.loop_closer and set(lc.kf_bow) == set(range(ms0.n_kf))
    for k, (ids, vals) in lc.kf_bow.items():
        _, dense = ts.voc.transform(ts.map.kf_desc[k], ts.map.kf_kp_valid[k])
        np.testing.assert_array_equal(ids, np.nonzero(dense > 0)[0])
        np.testing.assert_array_equal(vals, dense[ids])
    _, bow = ts.voc.transform(ts.map.kf_desc[kf], ts.map.kf_kp_valid[kf])
    assert isinstance(lc._detect_loop(kf, bow), list)
