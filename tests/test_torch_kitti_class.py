"""Parity of the port's KITTI-class circuit driver
(orb_slam2_detailed_comments_tpu_torch/examples/kitti_class_benchmark.py)
with the JAX package's examples/kitti_class_benchmark.py, on the CPU.

  * bow_discrimination on one seeded stub map (keyframes on two laps of a
    circle, sparse bags of words): the JAX module's result, exactly;
  * the lost-streak and per-lap scale summaries against the JAX driver's
    own inline code (transcribed below, with the JAX package's
    align_umeyama), exactly;
  * frames rendered in spawned workers (render_workers, as chip_smoke.py
    renders [22]'s) equal the frames rendered as the run reaches them;
  * one short stereo run() of both packages (FRAMES frames at 320x240, 500
    features, radius 25, LAPS of a lap so that a frame turns 1.4 deg): the
    same tracked share, keyframes within KF_TOL, the exported ATE within
    ATE_RTOL or ATE_ATOL_M, and the same result keys but the port's
    ms_per_frame (median and p90 of the host ms a frame); and frame by
    frame, both traced by tools/circuit_trace.py: the same tracking states,
    paths, keyframe decisions, live keyframes and reference keyframes, the
    camera centres within CENTRE_ATOL_M.
The JAX run is tests/torch_parity.py's circuit_trace mode in a process of
its own (the JAX driver's run() with the fused path on, ORB_FUSED_TRACK=1,
the port's default, in the exact modes; its JSON line read back), started
before the port's run so that its compiles overlap it.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from orb_slam2_detailed_comments_tpu.evaluation.ate import align_umeyama as jax_align_umeyama
from orb_slam2_detailed_comments_tpu_torch.examples import kitti_class_benchmark as TK
from orb_slam2_detailed_comments_tpu_torch.frontend.tracking import TrackingState

from synthetic_world import loop_trajectory

REPO = Path(__file__).resolve().parents[1]
FRAMES, LAPS = 8, 0.004
RUN_ARGS = ["--frames", str(FRAMES), "--width", "320", "--height", "240", "--features", "500",
            "--radius", "25", "--laps", str(LAPS)]
KF_TOL, ATE_RTOL, ATE_ATOL_M = 1, 0.10, 0.002
# the live camera centres of the two runs, frame by frame: at most the ATE's
# absolute limit apart (the two part by at most 0.81 mm in 8 frames on the
# CPU: pyramid ulps flip a few matches from frame 1 on)
CENTRE_ATOL_M = ATE_ATOL_M
JAX_TIMEOUT_S = 600


def _jax_module():
    spec = importlib.util.spec_from_file_location(
        "jax_kitti_class_benchmark", REPO / "examples" / "kitti_class_benchmark.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JK = _jax_module()


def _trace_module():
    spec = importlib.util.spec_from_file_location("circuit_trace",
                                                  REPO / "tools" / "circuit_trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CT = _trace_module()


class _Voc:
    n_words = 400


class _LoopCloser:
    def __init__(self, kf_bow):
        self.kf_bow = kf_bow
        self.voc = _Voc()


class _Map:
    def __init__(self, frame_ids, valid):
        self.kf_frame_id = np.asarray(frame_ids)
        self.kf_valid = np.asarray(valid)


class _Slam:
    def __init__(self, loop_closer, map_store):
        self.loop_closer = loop_closer
        self.map = map_store


def _stub(seed=3, n_frames=200, n_kfs=100):
    """A stub System: a keyframe every n_frames / n_kfs frames on a two-lap
    loop, a few culled, each with a sparse bag whose words repeat on the
    same place of the other lap (and a share of random ones)."""
    rng = np.random.default_rng(seed)
    poses = loop_trajectory(n_frames, path_radius=10.0, laps=2.0, overlap=12)
    frame_ids = np.arange(n_kfs) * (n_frames // n_kfs)
    kf_bow = {}
    for k, f in enumerate(frame_ids):
        place = int(round(24 * (2 * f / (n_frames - 12)) % 24))
        ids = np.unique(np.concatenate([(place * 13 + np.arange(12)) % _Voc.n_words,
                                        rng.integers(0, _Voc.n_words, 18)]))
        vals = rng.uniform(0.01, 0.2, ids.size).astype(np.float32)
        kf_bow[k] = (ids, vals / vals.sum())
    valid = rng.uniform(size=n_kfs) > 0.1
    return _Slam(_LoopCloser(kf_bow), _Map(frame_ids, valid)), poses


def test_bow_discrimination_matches_jax():
    slam, poses = _stub()
    ours, theirs = TK.bow_discrimination(slam, poses), JK.bow_discrimination(slam, poses)
    assert ours is not None and ours["bow_pairs"] > 5
    assert ours == theirs


def _jax_summaries(states, est_rec, gt_rec, rec_f, n_frames, laps):
    """The JAX driver's inline streak and lap-scale code
    (examples/kitti_class_benchmark.py:147-154 and :194-206)."""
    not_ok = [i for i, s in enumerate(states) if s != TrackingState.OK]
    streaks = []
    for i in not_ok:
        if streaks and i == streaks[-1][1] + 1:
            streaks[-1][1] = i
        else:
            streaks.append([i, i])
    fpl = n_frames / max(laps, 1.0)
    lap_scales = []
    rec_f = np.asarray(rec_f)
    for lap in range(int(round(laps))):
        sel = np.nonzero((rec_f >= lap * fpl) & (rec_f < (lap + 1) * fpl))[0]
        if sel.size > 10:
            s, _, _ = jax_align_umeyama(est_rec[sel], gt_rec[sel], True)
            lap_scales.append(round(float(s), 4))
    out = {"lost_streaks": [(a, b) for a, b in streaks[:10]], "lap_scales": lap_scales}
    if len(lap_scales) >= 2:
        out["scale_drift_pct"] = round(100.0 * (lap_scales[-1] / lap_scales[0] - 1.0), 3)
    return out


@pytest.mark.parametrize("laps", [2.0, 3.0])
def test_streak_and_lap_scale_summaries_match_jax(laps):
    rng = np.random.default_rng(5)
    n = 120
    states = [TrackingState.LOST if u < 0.15 else TrackingState.OK
              for u in rng.uniform(size=n)]
    rec_f = np.sort(rng.choice(n, 100, replace=False))
    gt_rec = rng.normal(0, 5, (100, 3))
    scale = np.where(rec_f < n / laps, 0.5, 0.52)[:, None]
    est_rec = scale * gt_rec + rng.normal(0, 0.01, (100, 3))
    ours = {"lost_streaks": TK.lost_streaks(states, TrackingState.OK)[:10],
            **TK.lap_scale_drift(est_rec, gt_rec, rec_f, n, laps)}
    assert ours == _jax_summaries(states, est_rec, gt_rec, rec_f, n, laps)
    assert ours["lost_streaks"] and len(ours["lap_scales"]) == int(laps)


def test_render_workers_render_the_same_frames():
    sensor = "stereo"
    poses = loop_trajectory(5, path_radius=12.5, laps=0.05, overlap=0)
    jobs = [(T, i == 2) for i, T in enumerate(poses)]
    world, baseline = TK._world(160, 120, 25.0, 0)
    inline = [TK._frame_images(world, T, sensor, baseline, k) for T, k in jobs]
    pooled = TK.render_frames(jobs, 160, 120, 25.0, 0, sensor, workers=2)
    assert len(pooled) == len(inline) == 5 and not pooled[2][0].any()
    for a, b in zip(inline, pooled):
        assert len(a) == len(b) == 2
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def _start_jax_run(trace):
    """The JAX driver's short run, traced frame by frame into `trace`
    (tests/torch_parity.py circuit_trace: JAX on the CPU, the fused path,
    the exact modes), started in a process of its own so that its compiles
    overlap the port's run; its last line is the driver's result dict."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cmd = [sys.executable, str(REPO / "tests" / "torch_parity.py"), "circuit_trace",
           *RUN_ARGS, "--out", str(trace)]
    return subprocess.Popen(cmd, env=env, cwd=str(REPO), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def test_short_stereo_run_matches_jax(tmp_path):
    import torch
    from orb_slam2_detailed_comments_tpu_torch import system as TS
    jax_proc = _start_jax_run(tmp_path / "jax.jsonl")
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    tracer = CT.CircuitTracer(tmp_path / "port.jsonl")
    try:
        with tracer.patch(TS.System):
            ours = TK.run(FRAMES, 320, 240, 500, radius=25.0, laps=LAPS, progress=False,
                          device="cpu")
    finally:
        tracer.close()
        torch.set_num_threads(threads)
        out, err = jax_proc.communicate(timeout=JAX_TIMEOUT_S)
    assert jax_proc.returncode == 0, err[-2000:]
    ref = json.loads(out.strip().splitlines()[-1])
    ours = json.loads(json.dumps(ours))          # tuples as the JSON line holds them
    assert set(ours) - {"ms_per_frame"} == set(ref), (sorted(ours), sorted(ref))
    assert set(ours["ms_per_frame"]) == {"median", "p90"}
    assert ours["tracked_frac"] == ref["tracked_frac"] == 1.0
    assert abs(ours["keyframes"] - ref["keyframes"]) <= KF_TOL, (ours, ref)
    assert abs(ours["ate_rmse_m"] - ref["ate_rmse_m"]) <= max(ATE_RTOL * ref["ate_rmse_m"],
                                                              ATE_ATOL_M), (ours, ref)
    for k in ("frames", "resolution", "sensor", "trajectory", "features", "travel_m",
              "lost_streaks", "loops_closed", "kfs_live_at_loops"):
        assert ours[k] == ref[k], k
    # frame by frame: the same states, tracking paths and keyframe decisions,
    # the camera centres within CENTRE_ATOL_M
    _, jax_frames, _ = CT.read_trace(tmp_path / "jax.jsonl")
    _, port_frames, _ = CT.read_trace(tmp_path / "port.jsonl")
    assert len(jax_frames) == len(port_frames) == FRAMES
    for a, b in zip(jax_frames, port_frames):
        for k in ("state", "path", "kf_made", "kfs_live", "ref_kf"):
            assert a[k] == b[k], (a["frame"], k, a[k], b[k])
    parted = CT.compare_traces(jax_frames, port_frames)
    assert parted["state_or_path"] is parted["keyframe"] is None
    assert np.nanmax(parted["centre_mm"]) <= 1e3 * CENTRE_ATOL_M, parted["centre_mm"]
