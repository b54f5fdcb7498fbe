#!/usr/bin/env python3
"""How far the asynchronous pipeline's mapping worker lags the tracker, and
what that does to the map: tools/bench_e2e.py's 265-frame loop, several
runs side by side, each in a process of its own, with per-frame and
per-keyframe records.

    python3 tools/async_lag_probe.py VARIANT[,VARIANT...] [--out DIR]

VARIANT:
    sync       System at its stereo defaults (the synchronous pipeline)
    async      System(async_mapping=True) as the package has it: the tracker
               inserts keyframes freely only while the worker is idle (the
               reference's AcceptKeyFrames, ROADMAP.md C.18)
    jax_rule   async with the JAX package's back-pressure instead: keyframes
               accepted while fewer than three are queued

The frames are rendered once (8 spawned processes) and each run is forked
from that process, so all runs see the same images; side by side they also
share the host, which makes each one slower than alone. Each run writes
DIR/probe_<i>_<variant>.json (default DIR: build/async_lag_probe):

    summary     bench_e2e's result (ATE, loops, keyframes, ms a frame, ...)
    live_err    per frame, the distance of the tracker's camera centre, as
                returned at that frame, from the ground truth in the first
                camera's frame (no alignment: the drift as it builds up)
    frames      per frame: keyframes queued ("q") and queued or in process
                ("pending") after the frame, live keyframes, map points
    prep        per mapped keyframe: the tracker's frame when the worker
                took it up, whether the local BA was deferred or built
    merge       per local-BA merge: how far it moved the window's central
                keyframe ("kf_move", m) and any of its free keyframes
                ("max_move"), and the window's size

and prints one summary line a run. Needs a CUDA card; PROBE_DEV=cpu with
PROBE_W=640 PROBE_FRAMES=24 runs a small copy on the CPU.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

VARIANTS = ("sync", "async", "jax_rule")


def child(idx, variant, scene, out_dir):
    import bench_e2e as B
    from orb_slam2_detailed_comments_tpu_torch import system as S
    from orb_slam2_detailed_comments_tpu_torch.backend import async_pipeline as AP
    from orb_slam2_detailed_comments_tpu_torch.backend import local_mapping as LM

    if variant == "jax_rule":
        AP.AsyncLocalMapper.accept_keyframes = lambda self: self.queue.qsize() < 3

    _, poses, _ = scene
    frames_rec, prep_rec, merge_rec = [], [], []
    holder = {}
    track_stereo = S.System.track_stereo

    def track(self, left, right, ts):
        holder["slam"] = self
        out = track_stereo(self, left, right, ts)
        lm = self.local_mapper
        frames_rec.append({
            "i": len(frames_rec), "Tcw": None if out is None else np.asarray(out).tolist(),
            "q": int(lm.queue_len()) if hasattr(lm, "queue_len") else 0,
            "pending": int(getattr(lm, "_pending", 0)),
            "kfs": int(self.map.n_keyframes()), "n_kf": int(self.map.n_kf),
            "mps": int(self.map.n_map_points())})
        return out

    prepare, merge_ba = LM.LocalMapper.prepare_keyframe, LM.LocalMapper._merge_local_ba

    def prep(self, kf, run_ba=True):
        slam = holder.get("slam")
        fid = slam.tracker.frame_id if slam is not None else -1
        out = prepare(self, kf, run_ba)
        prep_rec.append({"kf": int(kf), "frame": int(fid), "deferred": bool(self._deferred),
                         "built": out is not None, "n_pending": len(self.pending)})
        return out

    def merge(self, built, result):
        before = self.map.kf_Tcw[built["local"]].copy()
        merge_ba(self, built, result)
        after = self.map.kf_Tcw[built["local"]]
        d = [float(np.linalg.norm(np.linalg.inv(a)[:3, 3] - np.linalg.inv(b)[:3, 3]))
             for a, b in zip(after, before)]
        merge_rec.append({"kf": int(built["local"][0]), "n_local": len(built["local"]),
                          "n_cams": len(built["cams"]), "n_pts": int(len(built["pts"])),
                          "max_move": max(d), "kf_move": d[0]})

    S.System.track_stereo = track
    LM.LocalMapper.prepare_keyframe = prep
    LM.LocalMapper._merge_local_ba = merge
    t0 = time.time()
    try:
        res = B.run_e2e(async_mapping=variant != "sync", progress_every=0, scene=scene,
                        device=os.environ.get("PROBE_DEV", "cuda"))
        err = None
    except Exception:   # recorded and reported: the other runs go on
        res, err = None, traceback.format_exc()
    e = res["extra"] if res else {}
    T0inv = np.linalg.inv(poses[0])
    live = []
    for r in frames_rec:
        if r["Tcw"] is None:
            live.append(None)
            continue
        c_est = np.linalg.inv(np.asarray(r["Tcw"]))[:3, 3]
        c_gt = np.linalg.inv(poses[r["i"]] @ T0inv)[:3, 3]
        live.append(float(np.linalg.norm(c_est - c_gt)))
    out = {"variant": variant, "idx": idx, "error": err, "s": time.time() - t0,
           "summary": {k: e.get(k) for k in (
               "tracked", "keyframes", "keyframes_allocated", "map_points", "loops_closed",
               "loop_frames_ms", "loop_ate_m", "ate_m", "error_by_window_m", "n_processed",
               "n_ba_aborted", "n_ba_stale", "n_kf_deferred", "frames_kf_waiting",
               "gba_completed", "gba_aborted", "median_ms", "p90_ms", "max_ms", "wall_s",
               "device")},
           "stage_ms": e.get("stage_ms"), "live_err": live,
           "frames": [{k: v for k, v in r.items() if k != "Tcw"} for r in frames_rec],
           "prep": prep_rec, "merge": merge_rec}
    (out_dir / f"probe_{idx}_{variant}.json").write_text(json.dumps(out))
    s = out["summary"]
    moves = np.asarray([m["kf_move"] for m in merge_rec]) if merge_rec else np.zeros(1)
    busy = np.mean([r["pending"] >= 2 for r in frames_rec]) if frames_rec else 0.0
    print(f"[{idx} {variant}] failed={err is not None} ate={s.get('ate_m')} "
          f"loop_ate={s.get('loop_ate_m')} tracked={s.get('tracked')} "
          f"keyframes={s.get('keyframes')}/{s.get('keyframes_allocated')} "
          f"deferred={s.get('n_kf_deferred')} aborted={s.get('n_ba_aborted')} "
          f"stale={s.get('n_ba_stale')} frames_with_2_pending={busy:.2f} "
          f"kf_move_m p50/p90/max={np.median(moves):.3f}/{np.percentile(moves, 90):.3f}/"
          f"{moves.max():.3f} median_ms={s.get('median_ms')} frame_loop_s={s.get('wall_s')}",
          flush=True)
    if err:
        print(err, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", help="comma-separated: " + ", ".join(VARIANTS))
    ap.add_argument("--out", default=str(REPO / "build" / "async_lag_probe"))
    args = ap.parse_args()
    variants = args.variants.split(",")
    bad = [v for v in variants if v not in VARIANTS]
    if bad:
        ap.error(f"unknown variants {bad}")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    import bench_e2e as B
    if os.environ.get("PROBE_DEV", "cuda") == "cuda":
        import subprocess
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip(), flush=True)
    t = time.time()
    w = int(os.environ.get("PROBE_W", "0"))
    if w:
        B.GEOMETRY.update(width=w, height=int(round(w * 376 / 1241)), features=1000)
    n = int(os.environ.get("PROBE_FRAMES", "265"))
    scene = B.render_loop(265, 1.0, 31, workers=0 if w else 8)
    scene = (scene[0], scene[1][:n], scene[2][:n])
    print(f"rendered in {time.time() - t:.1f} s", flush=True)
    ctx = mp.get_context("fork")    # the parent has not touched the card
    procs = [ctx.Process(target=child, args=(i, v, scene, out_dir))
             for i, v in enumerate(variants)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(1500)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    print("exit codes", codes, flush=True)
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    raise SystemExit(main())
