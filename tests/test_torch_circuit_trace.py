"""tools/circuit_trace.py, the per-frame trace of the KITTI-class circuit:
its tracer on a stub System (a JSON line a frame, flushed as it goes, the
stop after frame N, seeded noise on the images) and the classification of
`--compare` on hand-made traces: a gap that grows from 1e-6 m over frames
(chaos) and one that jumps 5 mm on one frame (a decision taken apart)."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


def _load():
    spec = importlib.util.spec_from_file_location("circuit_trace",
                                                  REPO / "tools" / "circuit_trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CT = _load()


def _pose(x):
    """A 3x4 Tcw whose camera centre is (x, 0, 0)."""
    return [1.0, 0.0, 0.0, -x, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0]


def _trace(path, xs, kf_frames=(), lost=()):
    with open(path, "w") as f:
        f.write(json.dumps({"meta": {}}) + "\n")
        for i, x in enumerate(xs):
            f.write(json.dumps(dict(
                frame=i, state="LOST" if i in lost else "OK",
                path=["mm-", "refkf-"] if i in lost else ["fused"], trk=[],
                Tcw=None if i in lost else _pose(x), kf_made=i in kf_frames)) + "\n")
        f.write('{"frame": 99, "state": "O')        # a run cut mid-line


def test_compare_tells_growth_from_a_jump(tmp_path):
    n = 40
    base = np.linspace(0.0, 10.0, n)
    growth = 1e-6 * 1.4 ** np.arange(n)              # 1e-6 m, growing 40% a frame
    jump = np.where(np.arange(n) >= 17, 5e-3, 1e-7)  # 5 mm from frame 17 on
    paths = [tmp_path / f"{k}.jsonl" for k in ("ref", "growth", "jump")]
    _trace(paths[0], base, kf_frames=(0, 10, 20))
    _trace(paths[1], base + growth, kf_frames=(0, 10, 20))
    _trace(paths[2], base + jump, kf_frames=(0, 10, 21), lost=(30,))

    g = CT.compare(paths[0], paths[1])
    assert g["frames"] == n and g["gap"] == "growth"
    assert g["state_or_path"] is None and g["keyframe"] is None
    # leaves float level (1e-2 mm) at 1e-6 * 1.4^k > 1e-5 m, passes 1 mm later
    assert g["left_float_level"] == int(np.argmax(growth > 1e-5))
    assert g["centre_over_1mm"] == int(np.argmax(growth > 1e-3)) > g["left_float_level"]
    np.testing.assert_allclose(g["centre_mm"], 1e3 * growth, rtol=1e-6)

    j = CT.compare(paths[0], paths[2])
    assert j["gap"] == "jump"
    assert j["left_float_level"] == j["centre_over_1mm"] == 17
    assert j["keyframe"] == 20 and j["state_or_path"] == 30
    assert np.isnan(j["centre_mm"][30])


class _Tracker:
    def __init__(self):
        self.debug = False
        self.fused_frames = self.staged_frames = 0
        self.trajectory = []

    def _track_with_motion_model(self, frame):
        return frame % 2 == 0

    def _track_reference_keyframe(self, frame):
        return True

    def _track_local_map(self, frame):
        return True

    def _relocalize(self, frame):
        return False


class _Map:
    def __init__(self):
        self.n_kf = 0
        self.kf_Tcw = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
        self.mp_pos = np.zeros((4, 3), np.float32)

    def n_keyframes(self):
        return self.n_kf

    def n_map_points(self):
        return 10 * self.n_kf


class _Mapper:
    def __init__(self, map_store):
        self.map = map_store

    def _solve_local_ba(self, built):
        return 0.5

    def _merge_local_ba(self, built, result):
        self.map.mp_pos[built["pts"]] += result


class _System:
    """The surface the tracer reads: a tracker with the four staged
    methods, a map, a local mapper; a keyframe every third frame."""

    def __init__(self):
        self.tracker, self.map = _Tracker(), _Map()
        self.local_mapper = _Mapper(self.map)
        self.loop_closer = None
        self.images = []

    @property
    def tracking_state(self):
        class S:
            name = "OK"
        return S

    def track_stereo(self, left, right, ts):
        i = len(self.images)
        self.images.append((left, right))
        if self.tracker.debug:
            print(f"  [trk] frame {i}")
        if not self.tracker._track_with_motion_model(i):
            self.tracker._track_reference_keyframe(i)
        if i % 3 == 0:
            self.map.n_kf += 1
            built = {"cams": [0, 1], "pts": [1, 2]}
            self.local_mapper._merge_local_ba(built, self.local_mapper._solve_local_ba(built))
        self.tracker.trajectory.append((i, ts, None, self.map.n_kf - 1, False))
        return np.eye(4, dtype=np.float32)

    def track_rgbd(self, img, depth, ts):
        raise NotImplementedError

    def track_monocular(self, img, ts):
        raise NotImplementedError


def test_tracer_records_each_frame_and_stops(tmp_path):
    out = tmp_path / "t.jsonl"
    tracer = CT.CircuitTracer(out, stop_after=3, noise=7, grey=1e-3, meta={"k": 1})
    img = np.full((4, 5), 100.0, np.float32)
    with tracer.patch(_System):
        slam = _System()
        with pytest.raises(CT.StopTrace):
            for i in range(10):
                slam.track_stereo(img, img, 0.1 * i)
    tracer.close()
    # the class is restored
    assert _System.__init__.__qualname__ == "_System.__init__"
    assert _System.track_stereo.__qualname__ == "_System.track_stereo"
    meta, frames, result = CT.read_trace(out)
    assert meta == {"k": 1} and result is None and len(frames) == 4
    assert [f["path"] for f in frames] == [["mm+"], ["mm-", "refkf+"], ["mm+"],
                                           ["mm-", "refkf+"]]
    assert [f["kf_made"] for f in frames] == [True, False, False, True]
    assert [f["local_ba"] for f in frames] == [1, 1, 1, 2]
    assert frames[0]["events"] == [
        "local BA: 2 cams, 2 points; keyframe centres moved up to 0.0000 m, points median "
        "0.8660 m, largest 0.8660 m"] and frames[1]["events"] == []
    assert [f["trk"] for f in frames] == [[f"frame {i}"] for i in range(4)]
    rng = np.random.default_rng(7)
    for left, right in slam.images:
        for im in (left, right):
            np.testing.assert_array_equal(im, (img + rng.uniform(-1e-3, 1e-3, img.shape))
                                          .astype(np.float32))


def test_summary_of_a_trace_on_the_ground_truth(tmp_path):
    """A run whose live poses are the circuit's ground truth seen from its
    first camera: live ATE and live error 0; loops, LOST streaks, keyframe
    counts and the local BAs' keyframe moves before and after the loop as
    recorded; the exported ATE only when it ended."""
    meta = dict(frames=30, radius=10.0, laps=0.2, sensor="stereo")
    poses = CT.ground_truth_poses(meta)
    T0_inv = np.linalg.inv(poses[0])
    path = tmp_path / "gt.jsonl"
    with open(path, "w") as f:
        f.write(json.dumps({"meta": meta}) + "\n")
        for i, T in enumerate(poses):
            lost = i in (12, 13)
            f.write(json.dumps(dict(
                frame=i, state="LOST" if lost else "OK", path=[], trk=[],
                Tcw=None if lost else (T @ T0_inv)[:3, :4].ravel().tolist(),
                kf_made=i % 5 == 0, kfs_made=i // 5 + 1, kfs_live=min(i // 5 + 1, 4),
                loops=int(i >= 20), local_ba=i // 5,
                events=[f"local BA: 3 cams, 9 points; keyframe centres moved up to "
                        f"{2.0 if i == 25 else 0.1} m, points median 0 m, largest 0 m"]
                * (i % 5 == 0))) + "\n")
    s = CT.summarize(path)
    assert s["frames"] == 30 and s["loops"] == [20] and s["lost_streaks"] == [(12, 13)]
    assert (s["kfs_made"], s["kfs_live"], s["local_ba"]) == (6, 4, 5)
    assert s["ate_live_m"] == 0.0 and s["live_err_max_m"] < 1e-6
    assert s["live_err_m_every_100"] == [0.0]
    assert s["lba_kf_move_before_loop"] == dict(n=4, median_m=0.1, max_m=0.1, over_1m=0)
    assert s["lba_kf_move_after_loop"] == dict(n=2, median_m=1.05, max_m=2.0, over_1m=1)
    assert "ate_rmse_m" not in s
    with open(path, "a") as f:
        f.write(json.dumps({"result": {"ate_rmse_m": 0.25}}) + "\n")
    assert CT.summarize(path)["ate_rmse_m"] == 0.25
