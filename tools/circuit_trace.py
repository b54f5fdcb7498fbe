#!/usr/bin/env python3
"""A per-frame trace of the KITTI-class circuit, to find the first frame
where two runs part.

    python3 tools/circuit_trace.py --out FILE [--frames 1000] [--width 1241]
        [--height 376] [--features 2000] [--radius 50] [--laps 2]
        [--sensor stereo|rgbd|mono] [--stop-after N] [--noise SEED]
        [--dump-ba METRES DIR] [--threads N] [--device cuda]
    python3 tools/circuit_trace.py --compare A B
    python3 tools/circuit_trace.py --summary FILE ...

The first form runs the port's
orb_slam2_detailed_comments_tpu_torch/examples/kitti_class_benchmark.circuit
with the tracker's stage lines on (`Tracker.debug`) and writes FILE, one
JSON object a line, written and flushed as the run goes (a cut run leaves
its prefix): a "meta" line (the arguments), then one line per frame:

  state      the tracking state after the frame;
  path       the tracking stages the frame went through, in order, each
             with its outcome: "fused" (the fused frame program ran; a
             following staged stage means its inlier gate failed),
             "mm+"/"mm-" (motion model), "refkf+"/"refkf-" (reference
             keyframe), "lmap+"/"lmap-" (local map), "reloc+"/"reloc-";
             "staged" when the local map was too thin for the fused
             program, nothing while initializing;
  trk        the tracker's "[trk]" lines of the frame (counts against
             their thresholds, the keyframe decision's terms);
  Tcw        the returned pose (3x4, row-major) or null;
  ref_kf     the reference keyframe logged for the frame;
  kf_made    whether the frame made a keyframe;
  kfs_live, mps_live, kfs_made   live keyframes and points, keyframes
             made so far;
  loops, local_ba                loops closed and local-BA solves so far;
  events     anything a caller's hook noted during the frame;
  s          the frame's host seconds;

and a "result" line with the circuit's result dict when the run ends.
`python tests/torch_parity.py circuit_trace ...` writes the same file for
the JAX package's examples/kitti_class_benchmark.py on the CPU (the fused
path in its exact modes; every DeviceKeyframeStore._grow is an event).

--stop-after N stops after frame N without changing --frames, so the run
sees the frames of the full run (the circuit's poses depend on --frames).
--noise SEED adds +-chip_smoke.PERTURB_GREY grey levels of seeded uniform
noise to every image handed to track_*. --dump-ba METRES
DIR saves each local-BA problem that moved a keyframe centre more than
METRES (with its window and merged result) as DIR/ba_frame<N>.npz.

--compare A B prints, for two such files, the first frame where they part
by each measure: the tracking state or path, the [trk] counts, a keyframe
made in one run only, camera centres more than 1 mm apart; then the
per-frame centre distance and how the gap opened: "growth" when it leaves
float level (FLOAT_LEVEL_MM) and grows over frames, as chaos does, "jump"
when it goes from float level past 1 mm on one frame, as a discrete
decision taken apart does.

--summary FILE ... prints each run in numbers (summarize): loops, LOST
streaks, keyframes, the live ATE against the circuit's ground truth and
the live error's largest value, for a cut run too; the exported ATE of a
run that ended.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

STAGES = {"_track_with_motion_model": "mm", "_track_reference_keyframe": "refkf",
          "_track_local_map": "lmap", "_relocalize": "reloc"}
PART_MM = 1.0           # camera centres further apart than this have parted
FLOAT_LEVEL_MM = 1e-2   # at most this far apart, two runs agree to float level


class StopTrace(Exception):
    """Raised from track_* after the --stop-after frame."""


class CircuitTracer:
    """Records every track_* call of the System instances made while
    `patch(System)` is active, one JSON line a frame, into `path`."""

    def __init__(self, path, stop_after=None, noise=None, grey=1e-3, meta=None,
                 dump_ba=None):
        self.f = open(path, "w")
        self.dump_ba = dump_ba          # (metres, directory) or None
        self.stop_after = stop_after
        self.rng = None if noise is None else np.random.default_rng(noise)
        self.grey = grey
        self.frame = 0
        self.events, self.path = [], []
        self.local_ba = 0
        self.f.write(json.dumps({"meta": meta or {}}) + "\n")
        self.f.flush()

    def event(self, msg):
        self.events.append(msg)

    def close(self, result=None):
        if result is not None:
            self.f.write(json.dumps({"result": result}, default=str) + "\n")
        self.f.close()

    def _instrument(self, slam):
        tr = slam.tracker
        if hasattr(tr, "debug"):
            tr.debug = True
        for name, short in STAGES.items():
            fn = getattr(tr, name)

            def staged(*a, fn=fn, short=short, **k):
                ok = fn(*a, **k)
                self.path.append(short + ("+" if ok else "-"))
                return ok
            setattr(tr, name, staged)
        lm = slam.local_mapper
        solve, merge = lm._solve_local_ba, lm._merge_local_ba

        def counted_solve(*a, **k):
            self.local_ba += 1
            return solve(*a, **k)

        def measured_merge(built, result):
            ms, cams, pts = lm.map, built["cams"], built["pts"]
            c0, p0 = _centres(ms.kf_Tcw[cams]), ms.mp_pos[pts].astype(np.float64)
            merge(built, result)
            dc = np.linalg.norm(_centres(ms.kf_Tcw[cams]) - c0, axis=1)
            dp = np.linalg.norm(ms.mp_pos[pts] - p0, axis=1)
            self.event(f"local BA: {len(cams)} cams, {len(pts)} points; keyframe centres moved "
                       f"up to {dc.max():.4f} m, points median {np.median(dp):.4f} m, "
                       f"largest {dp.max():.4f} m")
            if self.dump_ba is not None and dc.max() > self.dump_ba[0]:
                self._dump(lm, built, result)
        lm._solve_local_ba, lm._merge_local_ba = counted_solve, measured_merge

    def _dump(self, lm, built, result):
        """Save a local-BA problem, the window and the merged result as
        numpy (`python tests/torch_parity.py ba_problem FILE` solves it
        again in both packages)."""
        out = Path(self.dump_ba[1]) / f"ba_frame{self.frame}.npz"
        out.parent.mkdir(parents=True, exist_ok=True)
        prob = {f"prob_{k}": np.asarray(v.cpu() if hasattr(v, "cpu") else v)
                for k, v in built["prob"]._asdict().items()}
        cam = lm.config.camera
        np.savez_compressed(
            out, **prob, cams=np.asarray(built["cams"]),
            cam_free=np.asarray(built["cam_free"]), E=built["E"],
            new_cams=np.asarray(result[0]), new_pts=np.asarray(result[1]),
            inlier=np.asarray(result[2]), inv_sigma2=np.asarray(lm.inv_sigma2, np.float32),
            camera=np.asarray([cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, cam.width, cam.height],
                              np.float64))
        self.event(f"local BA problem saved to {out}")

    def _record(self, slam, Tcw, fused0, staged0, kfs0, out, dt):
        tr, ms = slam.tracker, slam.map
        path = (["fused"] * (tr.fused_frames - fused0) + ["staged"] * (tr.staged_frames - staged0)
                + self.path)
        lc = getattr(slam, "loop_closer", None)
        lines = out.splitlines()
        rec = dict(
            frame=self.frame, state=slam.tracking_state.name, path=path,
            trk=[ln.strip()[len("[trk] "):] for ln in lines if ln.strip().startswith("[trk]")],
            log=[ln for ln in lines if ln.strip() and not ln.strip().startswith("[trk]")],
            Tcw=None if Tcw is None else np.asarray(Tcw, np.float64)[:3, :4].ravel().tolist(),
            ref_kf=int(tr.trajectory[-1][3]) if tr.trajectory else -1,
            kf_made=bool(ms.n_kf > kfs0), kfs_live=int(ms.n_keyframes()),
            mps_live=int(ms.n_map_points()), kfs_made=int(ms.n_kf),
            loops=int(lc.n_loops_closed) if lc is not None and hasattr(lc, "n_loops_closed")
            else 0,
            local_ba=self.local_ba, events=list(self.events), s=round(dt, 4))
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()

    @contextlib.contextmanager
    def patch(self, system_cls):
        """Instrument every System made inside the block and record each of
        its track_* calls; restore the class after."""
        saved = {k: system_cls.__dict__[k] for k in
                 ("__init__", "track_stereo", "track_rgbd", "track_monocular")}
        tracer = self

        def init(slam, *a, **k):
            saved["__init__"](slam, *a, **k)
            tracer._instrument(slam)

        def traced(name):
            def track(slam, *args):
                *imgs, ts = args
                if tracer.rng is not None:
                    imgs = [(np.asarray(im, np.float32)
                             + tracer.rng.uniform(-tracer.grey, tracer.grey, np.shape(im))
                             ).astype(np.float32) for im in imgs]
                tr, ms = slam.tracker, slam.map
                fused0, staged0, kfs0 = tr.fused_frames, tr.staged_frames, ms.n_kf
                tracer.events, tracer.path = [], []
                buf = io.StringIO()
                t0 = time.perf_counter()
                try:
                    with contextlib.redirect_stdout(buf):
                        Tcw = saved[name](slam, *imgs, ts)
                except StopTrace:       # stopped inside the frame: keep its lines
                    tracer._record(slam, None, fused0, staged0, kfs0, buf.getvalue(),
                                   time.perf_counter() - t0)
                    raise
                tracer._record(slam, Tcw, fused0, staged0, kfs0, buf.getvalue(),
                               time.perf_counter() - t0)
                tracer.frame += 1
                if tracer.stop_after is not None and tracer.frame > tracer.stop_after:
                    raise StopTrace
                return Tcw
            return track

        system_cls.__init__ = init
        for name in ("track_stereo", "track_rgbd", "track_monocular"):
            setattr(system_cls, name, traced(name))
        try:
            yield self
        finally:
            for k, v in saved.items():
                setattr(system_cls, k, v)


def _centres(T):
    T = np.asarray(T, np.float64)
    return -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])


def read_trace(path):
    """(meta, per-frame records, result or None) of a trace file; a cut last
    line is dropped."""
    meta, frames, result = {}, [], None
    with open(path) as f:
        for line in f:
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                break
            if "meta" in d:
                meta = d["meta"]
            elif "result" in d:
                result = d["result"]
            else:
                frames.append(d)
    return meta, frames, result


def centre(Tcw):
    T = np.asarray(Tcw, np.float64).reshape(3, 4)
    return -T[:, :3].T @ T[:, 3]


def _branch(rec):
    return rec["state"], tuple(rec["path"])


def compare_traces(a, b):
    """The first frame where two runs' records part, by each measure, the
    per-frame centre distance in mm (NaN where a run has no pose) and how
    the gap opened ("growth", "jump" or None when it never left float
    level)."""
    n = min(len(a), len(b))
    mm = np.full(n, np.nan)
    for i in range(n):
        if a[i]["Tcw"] is not None and b[i]["Tcw"] is not None:
            mm[i] = 1e3 * np.linalg.norm(centre(a[i]["Tcw"]) - centre(b[i]["Tcw"]))

    def first(pred):
        return next((i for i in range(n) if pred(a[i], b[i], mm[i])), None)

    out = dict(
        frames=n,
        state_or_path=first(lambda x, y, d: _branch(x) != _branch(y)),
        trk_counts=first(lambda x, y, d: x["trk"] != y["trk"]),
        keyframe=first(lambda x, y, d: x["kf_made"] != y["kf_made"]),
        centre_over_1mm=first(lambda x, y, d: (x["Tcw"] is None) != (y["Tcw"] is None)
                              or d > PART_MM),
        centre_mm=mm)
    left = first(lambda x, y, d: d > FLOAT_LEVEL_MM)
    out["left_float_level"] = left
    out["gap"] = None if left is None else "jump" if mm[left] > PART_MM else "growth"
    return out


def compare(path_a, path_b) -> dict:
    (ma, a, ra), (mb, b, rb) = read_trace(path_a), read_trace(path_b)
    res = compare_traces(a, b)
    mm = res["centre_mm"]
    print(f"compare {path_a} ({len(a)} frames) against {path_b} ({len(b)} frames)")
    for k in ("state_or_path", "trk_counts", "keyframe", "centre_over_1mm", "left_float_level"):
        i = res[k]
        print(f"  first frame parted by {k}: {i}" + ("" if i is None else (
            f"  A {_branch(a[i])} kf {a[i]['kf_made']} trk {a[i]['trk']}\n"
            f"    B {_branch(b[i])} kf {b[i]['kf_made']} trk {b[i]['trk']}")))
    print(f"  the gap: {res['gap']}")
    print("  camera centre distance, mm per frame:", " ".join(f"{v:.6g}" for v in mm))
    print("  keyframes made per frame:", [r.get("kfs_made") for r in a[:res["frames"]]], "against",
          [r.get("kfs_made") for r in b[:res["frames"]]])
    for tag, r in (("A", ra), ("B", rb)):
        if r is not None:
            print(f"  result {tag}:", {k: r.get(k) for k in (
                "tracked_frac", "keyframes", "map_points", "loops_closed", "lost_streaks",
                "kfs_live_at_loops", "ate_rmse_m")})
    return res


def ground_truth_poses(meta):
    """The circuit's true Tcw of every frame for a trace's run arguments."""
    from orb_slam2_detailed_comments_tpu_torch.examples.kitti_class_benchmark import (
        circuit_poses)
    return circuit_poses(meta["frames"], meta["radius"], meta["laps"])


def summarize(path) -> dict:
    """A trace's run in numbers, whether it ran to its end or was cut:
    frames, the frames that closed a loop, the LOST streaks, keyframes made
    and live at the last frame, local-BA solves, the live ATE (the tracked
    frames' live centres against the truth, aligned as the circuit's
    ate_live_m is), the live error (in the first camera's frame, where the
    map starts, unaligned) at its largest and every 100 frames, each local
    BA's largest keyframe move before and after the first loop (count,
    median, largest, over 1 m; traces that record them); the exported ATE
    when the run ended."""
    from orb_slam2_detailed_comments_tpu_torch.evaluation.ate import ate_rmse
    from orb_slam2_detailed_comments_tpu_torch.examples.kitti_class_benchmark import (
        lost_streaks)
    meta, frames, result = read_trace(path)
    poses = ground_truth_poses(meta)
    ok = [r["frame"] for r in frames if r["state"] == "OK" and r["Tcw"] is not None]
    est = np.asarray([centre(frames[i]["Tcw"]) for i in ok])
    gt = -np.einsum("nji,nj->ni", poses[ok, :3, :3], poses[ok, :3, 3])
    err = np.linalg.norm(est - (gt @ poses[0, :3, :3].T + poses[0, :3, 3]), axis=1)
    loops, prev = [], 0
    for r in frames:
        if r["loops"] > prev:
            loops.append(r["frame"])
            prev = r["loops"]
    last = frames[-1]
    err_at = dict(zip(ok, err))
    out = dict(frames=len(frames), loops=loops,
               lost_streaks=lost_streaks([r["state"] for r in frames], "OK"),
               kfs_made=last["kfs_made"], kfs_live=last["kfs_live"], local_ba=last["local_ba"],
               ate_live_m=round(float(ate_rmse(est, gt, with_scale=meta["sensor"] == "mono")),
                                4),
               live_err_max_m=round(float(err.max()), 4),
               live_err_max_frame=ok[int(np.argmax(err))],
               live_err_m_every_100=[round(float(err_at[f]), 2) if f in err_at else None
                                     for f in range(0, len(frames), 100)])
    # each local BA's largest keyframe move, before and after the first loop
    moves = [(r["frame"], float(e.split("moved up to ")[1].split(" m")[0]))
             for r in frames for e in r.get("events", ()) if e.startswith("local BA:")]
    for part, sel in (("before_loop", lambda f: not loops or f < loops[0]),
                      ("after_loop", lambda f: loops and f >= loops[0])):
        m = np.asarray([v for f, v in moves if sel(f)])
        if m.size:
            out[f"lba_kf_move_{part}"] = dict(n=int(m.size), median_m=round(float(np.median(m)), 3),
                                              max_m=round(float(m.max()), 3),
                                              over_1m=int((m > 1.0).sum()))
    if result is not None:
        out["ate_rmse_m"] = result["ate_rmse_m"]
    return out


def add_run_arguments(ap):
    """The circuit's arguments, at the KITTI-class run (a)'s values."""
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--width", type=int, default=1241)
    ap.add_argument("--height", type=int, default=376)
    ap.add_argument("--features", type=int, default=2000)
    ap.add_argument("--radius", type=float, default=50.0)
    ap.add_argument("--laps", type=float, default=2.0)
    ap.add_argument("--sensor", choices=("stereo", "rgbd", "mono"), default="stereo")
    ap.add_argument("--out")
    ap.add_argument("--stop-after", type=int)
    ap.add_argument("--noise", type=int)


def run_kwargs(args):
    return dict(n_frames=args.frames, width=args.width, height=args.height,
                features=args.features, radius=args.radius, laps=args.laps,
                sensor=args.sensor, progress=False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_run_arguments(ap)
    ap.add_argument("--dump-ba", nargs=2, metavar=("METRES", "DIR"),
                    help="save every local-BA problem that moves a keyframe more than "
                         "METRES into DIR")
    ap.add_argument("--threads", type=int, help="torch's CPU threads")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    ap.add_argument("--summary", nargs="+", metavar="FILE")
    args = ap.parse_args(argv)
    if args.compare:
        compare(*args.compare)
        return 0
    if args.summary:
        for path in args.summary:
            print(path, json.dumps(summarize(path)))
        return 0
    if not args.out:
        ap.error("--out FILE is needed")
    import torch
    from orb_slam2_detailed_comments_tpu_torch import system
    from orb_slam2_detailed_comments_tpu_torch.examples import kitti_class_benchmark as K
    from orb_slam2_detailed_comments_tpu_torch.examples._driver import check_device

    device = check_device(args.device)
    if args.threads:
        torch.set_num_threads(args.threads)
    meta = dict(vars(args), package="orb_slam2_detailed_comments_tpu_torch",
                torch=torch.__version__, numpy=np.__version__)
    if torch.device(device).type == "cuda":
        import subprocess
        meta["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
    tracer = CircuitTracer(args.out, args.stop_after, args.noise, _perturb_grey(), meta,
                           dump_ba=args.dump_ba and (float(args.dump_ba[0]), args.dump_ba[1]))
    result = None
    try:
        with tracer.patch(system.System):
            result = K.run(**run_kwargs(args), device=device)
    except StopTrace:
        pass
    finally:
        tracer.close(result)
    print(json.dumps({"trace": args.out, "frames": tracer.frame, "result": result}))
    return 0


def _perturb_grey():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.PERTURB_GREY


if __name__ == "__main__":
    raise SystemExit(main())
