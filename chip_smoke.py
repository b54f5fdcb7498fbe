#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (nvcc, into build/kernels/) and
checks each one bit for bit against its plain PyTorch version on full maps
at the shapes of the main path ([3]), printing its time per call, its
device time and its bound. Then it drives the port at full size:

  [4]/[5] the per-frame tracking program: the KITTI-geometry stereo step and
          fused frame (1241x376, 2000 features, a 4096-point local map in the
          8192-slot pad) and the TUM-geometry mono step and fused frame
          (640x480, 1000 features), checked against the JAX package's
          inlier counts on the same inputs;
  [6]     pose recovery from perturbed predictions, and one profiled
          fused stereo and fused mono frame (CUDA kernels per frame and the
          device's busy share);
  [7]-[9] the tracking front end, `Tracker`, for SEQ_FRAMES frames of a
          rendered sequence per sensor: stereo at KITTI00-02 geometry, RGB-D
          and mono at TUM1 geometry. It prints and checks the frames
          tracked, the frames on the fused and on the staged path, the
          keyframes and the ATE against the rendered ground truth (held
          against the JAX Tracker's anchors below), and the median ms per
          fused and per staged frame.
  [10]-[12] `System(..., enable_loop_closing=False)` per sensor on the same
          frames (local mapping and relocalization, the shipped vocabulary):
          the mapped frames, SYS_BLANK blank frames that must leave it LOST,
          and up to SYS_REVISITS revisits of frame SYS_REVISIT_FRAME's view.
          It checks frames tracked, the LOST outcome, the revisit that
          relocalizes, live keyframes and map points and the ATE against
          the JAX System's anchors, prints ms per keyframe frame, other
          frame and relocalization attempt, the tracker's and the local
          mapper's stages (local-BA solve per bucket), and asserts that no
          local-BA solve syncs with the host (torch's sync debug mode).
  [13]    local BA on a synthetic problem at each bucket: ms per solve, CUDA
          kernels and host syncs per solve (asserted 0), and two solves of
          one problem bit-identical (asserted).
  [14]    the grouped global BA: (a) the stereo System's whole map after
          [10] through build_global_ba_problem and solve_global_ba (the
          path it took, E against FLAT_GBA_MAX_EDGES), held against the
          flat solver on the same problem; (b) examples/bench_gba.py's
          problem (1408 cameras, 60k points, 360,448 edges): ms per solve
          and per GN iteration, CUDA kernels, host syncs (asserted 0), peak
          device memory, two solves bit-identical (asserted), the route
          through solve_global_ba, and the final robust cost held within
          GBA_COST_RTOL of the JAX package's on the CPU (JAX_CPU_GBA).
  [15]    System(..., enable_loop_closing=False), monocular, with
          configs/KITTI04-12.yaml (1226x370, 2000 features) on a rendered
          sequence: it must initialize and track MONO_KITTI_TRACKED frames
          after; it prints the initialization's global-BA edges and path,
          then runs the whole map's global BA (ROADMAP.md C.9).
  [16]    loop closing's solvers: Sim3 RANSAC and optimize_sim3 on seeded
          loop matches (300, 30% outliers; free and fixed scale), which
          must recover the rotation within 0.1 deg and the scale within
          1%; optimize_pose_graph on examples/bench_pose_graph.py's circle
          graphs (POSE_GRAPH_CASES: K=1408 auto (banded), K=256 auto
          (dense), K=1408 cg), each cutting the mean edge error and the
          mean translation error at least 100x; ms, host syncs and CUDA
          kernels of each.
  [17]    System(cfg, Sensor.RGBD) with loop closing on, around
          tests/test_loop_sequence.py's lap at 640x480 (LOOP_LAP, 120
          frames): frames tracked, the loops closed and their keyframes,
          live keyframes and map points and the exported trajectory's ATE
          against the JAX System's anchors (JAX_CPU_LOOP); ms per keyframe
          and other frame before and after the loop, the loop-closing
          frame's ms by the loop closer's stages, its host syncs, the
          essential graph's backend and size and the global BA's edges,
          path and host syncs (asserted 0).
  [18]    LoopCloser fed a drifted 270-keyframe loop at KITTI00-02
          geometry (drifted_loop_map, 2000 keypoints a keyframe) through
          on_new_keyframe alone: the loop it closes, S_cl, the banded
          essential graph, the keyframe errors against the truth and the
          global BA's robust cost against the JAX LoopCloser's on the same
          map (JAX_CPU_LOOP_MAP); the same times as [17].
  [19]    the asynchronous pipeline: (a) [10]'s stereo phase through
          System(..., async_mapping=True), waiting for the mapping worker
          after each frame: [10]'s limits against the JAX anchors, every
          keyframe processed by the worker, no host sync in a local-BA
          solve, and whether its keyframes, points and exported trajectory
          are bit-identical to [10]'s; (b) tools/bench_e2e.py's loop at full
          KITTI width (1241x376, 2000 features, E2E_FRAMES frames: one lap
          of a 25 m circle at 2.26 deg a frame and the revisit that closes
          it; the tool's own lap is 265 frames), free-running,
          through System at its stereo defaults (loop closing and the global
          BA on) with async_mapping=True (the sync lap is cut for time; the
          tool runs it): frames tracked, loops closed, exported ATE
          (limits at E2E_*), keyframes, map points, ms a frame (median, p90,
          max after the warm-up), the mapper's n_processed, n_ba_aborted
          and n_ba_stale, the frames with a keyframe waiting in the
          worker's queue, and the global-BA runner's counts.
  [20]    the dataset drivers on files: each sequence written in its
          dataset's layout with the port's PNG writer and decoded back
          equal (write_dataset; the writer filters each row as libpng
          does, and Average and Paeth rows, which decode serially, are
          asserted present), then run through the port's
          examples/run_slam.py with System at the settings file's defaults
          (loop closing on): (a) kitti-stereo, [10]'s frames at
          configs/KITTI00-02.yaml, with --viz (the frame, the map and
          status.json written, no plotting library); (b) kitti-mono, [15]'s at
          configs/KITTI04-12.yaml; (c) tum-rgbd at configs/TUM1.yaml ([11]'s
          path and world at a hand-held camera's range, through TUM1's lens
          distortion; RGB colour PNGs, 16-bit depth 4 ms later,
          groundtruth.txt): frames tracked, keyframes, map points,
          exported frames and the driver's ground-truth ATE held against
          the JAX package's own run_slam on the same files
          (JAX_CPU_RUN_SLAM), the three trajectory files parsed, ms a frame
          as the driver prints them, ms to load a frame and its share of
          the median frame; (d)
          examples/train_vocabulary.py on (a)'s left images: the DBoW2 text
          loaded back through the drivers' make_system, each image's words
          equal and each image first against itself; (e) FrameDrawer on
          (a)'s last frame, written as PNG and read back equal.
  [21]    the entry points and the sharded global BA (parallel/): (a)
          graft_entry.entry()'s fused mono frame (K1 and K2's ORB site once
          a frame) against the JAX package's entry() (JAX_CPU_ENTRY); (b)
          graft_entry.dryrun_multichip(1), a spawned rank over NCCL; (c) a
          world of one rank over NCCL in this process: [14](b)'s problem
          through distributed_global_ba_grouped, fused and through its
          handle under a stop check that never fires, each bit-identical to
          [14](b)'s solve_grouped, with ms a solve, CUDA kernels, busy share,
          host syncs (asserted 0), peak memory and the robust cost against
          JAX_CPU_GBA; "dense" on [14](a)'s stereo map against its flat
          solve, and on DENSE_ROUTE's problem (DENSE_MAX_CAMS cameras at
          bench_gba's density, a map the route sends to "dense") against
          solve_grouped, with ms a solve, host syncs (asserted 0) and peak
          memory; (d) examples/bench_scaling.py's rows at SCALING's ranks
          and size over Gloo (one spawn, a process group a row), every
          rank on this one card (times that measure no interconnect), and
          its one-rank row on the points in another order (the float-order
          yardstick), each within GBA_CAM_TOL and GBA_PT_TOL of the
          one-rank solve and its robust cost within GBA_COST_RTOL.
  [22]    the KITTI-class monocular circuit
          (examples/kitti_class_benchmark.py at KITTI_CLASS_MONO.json's
          configuration: 300 frames at 640x480, 1000 features, two laps of a
          12.5 m circle in a 25 m cylinder; System with loop closing and the
          global BA on, the free-scale Sim3 correction): tracked share,
          loops, exported ATE as a share of the travel and the lap-to-lap
          scale drift held to the JAX package's gates, printed beside the
          committed JAX row's ATE, keyframes and tracked share; ms a frame,
          the loop-closing frame's stages and the essential graph.

Each path is driven with the kernels' launch counts set to 0 just before it
and read just after; a path fails unless each extraction made one
fast_pyramid and one orb_desc launch (train_vocabulary: one extraction an
image) and each stereo frame one stereo_sad launch (the other sensors
none), and no path launched patch_gather, fast_score_nms_raw or
fast_score_nms: those three are on no path and are
driven once per [3] shape instead. [14], [16], [18] and [21](c) run no
image and launch no kernel (asserted). The line
before the last is the per-kernel JSON (launches, errors, times, bounds);
the last is {"ok": true, "device": {...}}. There is no CPU path: without a
CUDA device the script fails. It imports neither jax nor the JAX package,
and checks that before it prints its result.
"""
from __future__ import annotations

import functools
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# Inlier counts of the JAX package (orb_slam2_detailed_comments_tpu) on
# bench.py's own inputs, run on the CPU with ORB_DESC_ONEHOT=0 (the exact
# gather descriptor the port implements), jax 0.9.0.
JAX_CPU_INLIERS = {
    "stereo_tracking_step": 451,
    "fused_stereo_frame": 451,
    "mono_tracking_step": 283,
    "fused_mono_frame": 283,
}
INLIER_RTOL = 0.02
N_FRAMES = 10
TIMING_REPS = 50
POSE_TOL_M, POSE_TOL_DEG = 0.01, 0.1
PAD_SLOTS = 8192  # the production local-map pad (frontend/device_map.py)

# ---- the tracker phases -----------------------------------------------------
# Geometry of the reference's settings files (configs/KITTI00-02.yaml,
# configs/TUM1.yaml; TUM1's distortion is left out, as the renderer is a
# pinhole camera). The frames are tests/synthetic_world.py::PlanesWorld
# renders along SEQ_STEP-metre sideways steps, with seeded sensor noise of
# +-SEQ_NOISE grey levels (no two texture samples tie, so the float32 ulps
# between XLA's and torch's pyramids do not flip BRIEF comparisons).
# tex_scale (texture px per world unit) keeps each field of view on the
# 2048-px texture (render_sequence checks it); the finer TUM texture gives
# monocular initialization the matches it needs.
SEQ_FRAMES = 30
SEQ_STEP = 0.05
SEQ_NOISE = 2.0
_TUM1 = dict(fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989, bf=40.0,
             width=640, height=480)
TRACK_SEQS = {
    "stereo": dict(cam=dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448,
                            width=1241, height=376),
                   n_features=2000, fps=10.0, th_depth=35.0, tex_scale=32.0),
    "rgbd": dict(cam=_TUM1, n_features=1000, fps=30.0, th_depth=40.0, tex_scale=48.0),
    "mono": dict(cam=_TUM1, n_features=1000, fps=30.0, th_depth=40.0, tex_scale=48.0),
    # [15]: configs/KITTI04-12.yaml's camera (2000 features, the YAML's own
    # settings). At this width the 2048-px texture allows 32 px per unit
    # at most; with its default 4,000 blobs the monocular initialization
    # never keeps 100 points, with the 12,000 of tests/synthetic_world.py's
    # CylinderWorld it initializes on frame 4 (the port on the CPU)
    "mono_kitti": dict(cam=dict(fx=707.0912, fy=707.0912, cx=601.8873, cy=183.1104,
                                bf=379.8145, width=1226, height=370),
                       tex_scale=32.0, n_blobs=12000),
}
# The JAX package's Tracker on the same frames, run on the CPU with
# ORB_FUSED_TRACK=1, ORB_DESC_ONEHOT=0, ORB_FAST_PALLAS=0 and
# ORB_PATCH_PALLAS=0, jax 0.9.0, by `JAX_PLATFORMS=cpu python
# tests/torch_parity.py` (jax_tracker_anchor). Limits: tracked frames exact; fused
# frames and keyframes within TRACK_COUNT_TOL; ATE within ATE_RTOL of the
# anchor or ATE_ATOL_M, whichever is larger (float32 sums in another order
# on the card move poses by micrometres per frame).
JAX_CPU_TRACKER = {
    "stereo": dict(tracked=30, fused=28, keyframes=4, ate_m=0.011411294233990387),
    "rgbd": dict(tracked=30, fused=28, keyframes=16, ate_m=0.004857959301703721),
    "mono": dict(tracked=25, fused=23, keyframes=25, ate_m=0.016620162112954053),
}
TRACK_COUNT_TOL = 1
ATE_RTOL, ATE_ATOL_M = 0.10, 0.002

# ---- the System phases --------------------------------------------------------
# System(..., enable_loop_closing=False) with the shipped vocabulary on the
# tracker phases' frames, then SYS_BLANK blank frames and up to SYS_REVISITS
# revisits of frame SYS_REVISIT_FRAME's view (drive_system).
SYS_BLANK = 3
SYS_REVISITS = 4
SYS_REVISIT_FRAME = 12
# The JAX package's System on the same frames (drive_system), run on the
# CPU in the modes of JAX_CPU_TRACKER, jax 0.9.0, by `JAX_PLATFORMS=cpu
# python tests/torch_parity.py system` (jax_system_anchor). Limits: frames
# tracked, the LOST outcome and the revisit that relocalizes (None: none
# did) exact; live keyframes within SYS_KF_TOL; live map points within
# SYS_MP_RTOL; ATE within ATE_RTOL of the anchor or SYS_ATE_ATOL_M,
# whichever is larger. SYS_ATE_ATOL_M is the tracker phases' ATE_ATOL_M,
# except mono's: the JAX package's own mono phase, with +-1e-3 grey levels
# of noise on its images (seeds 1-4, chip_smoke.perturbed_run;
# `tests/torch_parity.py system mono noise1 noise2 noise3 noise4`), lands
# at 24.433, 17.118, 20.520 and 20.332 mm against its anchor's 28.397, so
# up to 11.279 mm from it; the port on the card under the same seeds lands
# at 16.500-21.162 mm (tools/system_devices.py). Monocular mapping at this
# size is chaotic: its keyframes and map points move too (4-6 and 709-852
# in the JAX package's five runs).
JAX_CPU_SYSTEM = {
    "stereo": dict(tracked=30, lost=True, relocalized=None, keyframes=6, map_points=1367,
                   ate_m=0.00823005233723447),
    "rgbd": dict(tracked=30, lost=True, relocalized=0, keyframes=28, map_points=930,
                 ate_m=0.008151105497309867),
    "mono": dict(tracked=25, lost=True, relocalized=None, keyframes=4, map_points=709,
                 ate_m=0.02839745149811372),
}
SYS_KF_TOL = 1
SYS_MP_RTOL = 0.05
SYS_ATE_ATOL_M = {"stereo": ATE_ATOL_M, "rgbd": ATE_ATOL_M, "mono": 0.0113}

# ---- bounds: NVIDIA's H100 SXM data sheet at 700 W -----------------------------
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations per output pixel of the FAST kernels: 2 polarities x
# (the min tree's 4 x 16 mins over the 16 arcs of 9 + 15 maxes) on the ring
# samples, 2 subtractions of the centre, 1 max, the threshold; the 3x3 NMS
# (6 maxes, 3 compares); the separable 7-tap blur (2 x (7 multiplies + 6
# adds)). Arc by arc, 16 x 8 mins a polarity on 16 ring differences, the
# score was 304 operations; with the tree on the differences 176; on the
# samples (csrc/fast_pyramid.cu::arc_score) 162.
FAST_SCORE_OPS = 2 * (4 * 16 + 15) + 2 + 1 + 1
NMS_OPS = 9
BLUR_OPS = 2 * (7 + 6)
# float32 operations per valid keypoint of orb_desc: the IC moments (2
# multiplies, 2 adds per circle pixel; 2 x 5 adds of the lane tree), the
# angle's atan2, cos and sin (counted as 3), and per rotated sample 2
# multiplies, 1 add and 1 rounding (512), then 256 compares
IC_CIRCLE_PX = 749   # pixels of the radius-15 circle (ops/pattern.py mask)
ORB_DESC_OPS = 4 * IC_CIRCLE_PX + 10 + 3 + 512 * 4 + 256
# float32 operations of K5's early test per pixel of the image + 1 px
# (csrc/fast_pyramid.cu::may_pass: 4 subtractions, 8 compares); the arc
# score is counted only for the pixels that pass it
FAST_TEST_OPS = 4 + 8
# float32 operations per slot of stereo_sad: the centre normalisation of the
# 11x11 template and 11x21 strip, 11 offsets x 121 x (subtract, abs, add),
# the 4-step column tree of each offset, the argmin (10 compares) and the
# parabola (~12)
STEREO_SAD_OPS = 121 + 231 + 11 * 121 * 3 + 11 * 4 + 10 + 12

KERNEL_SYMBOLS = {"fast_pyramid": "fast_pyramid_kernel", "fast_score_nms_raw": "fast_pyramid_kernel",
                  "fast_score_nms": "fast_nms_kernel", "patch_gather": "patch_gather_kernel",
                  "orb_desc": "orb_desc_kernel", "stereo_sad": "stereo_sad_kernel"}
PALLAS_PATCH = "orb_slam2_detailed_comments_tpu/ops/pallas_patch.py:91"
PALLAS_FAST = "orb_slam2_detailed_comments_tpu/ops/pallas_fast.py"
CSRC = "orb_slam2_detailed_comments_tpu_torch/csrc"
KERNELS = {  # name: (source, TPU kernels it replaces)
    "fast_pyramid": (f"{CSRC}/fast_pyramid.cu", f"{PALLAS_FAST}:528, {PALLAS_FAST}:334"),
    "fast_score_nms_raw": (f"{CSRC}/fast_pyramid.cu", f"{PALLAS_FAST}:199"),
    "fast_score_nms": (f"{CSRC}/fast_pyramid.cu", f"{PALLAS_FAST}:405"),
    "patch_gather": (f"{CSRC}/patch_gather.cu", PALLAS_PATCH),
    "orb_desc": (f"{CSRC}/orb_desc.cu", PALLAS_PATCH),
    "stereo_sad": (f"{CSRC}/stereo_sad.cu", PALLAS_PATCH),
}
OFF_PATH = ("fast_score_nms_raw", "fast_score_nms", "patch_gather")   # driven in [3]


def _smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps=TIMING_REPS):
    """Median ms per call of fn over `reps` back-to-back calls after a
    warm-up, each between its own pair of CUDA events: the device time of
    the call, or the host time to issue it where that is longer (as a
    caller pays it)."""
    import torch
    fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def _device_ms(fn, symbol, reps=TIMING_REPS):
    """Device ms per launch of the CUDA kernel `symbol` over `reps` calls of
    fn, from torch.profiler's CUPTI trace; a trace that shows no launch of
    it is taken once more (one such trace was seen), then None."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if symbol in e.key]
        n = sum(e.count for e in evs)
        if n:
            return sum(e.device_time_total for e in evs) / 1e3 / n
        print(f"    (the trace holds no {symbol} launch, only "
              f"{sorted({e.key[:40] for e in prof.key_averages()})})", flush=True)
    return None


def _frame_ms(fn, n=N_FRAMES):
    """Run fn n times; host-clock ms per frame, each ending in a sync."""
    import torch
    out, times = None, []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return out, statistics.median(times)


def _share(busy):
    return "not measured" if busy is None else f"{100 * busy:.2f}%"


def _max_err(a, b):
    return float((a - b).abs().max())


def _bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    float32 operations over the peak rate outside the tensor cores."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _orb_desc_work(det, angle):
    """(bytes, operations) that orb_desc must spend on these keypoints: the
    level pixels under the valid keypoints' IC circles and the blurred
    pixels at their rotated samples, each read once (the union over all
    keypoints, counted on the device), the slots' xy and valid read and
    their angle and descriptor written; ORB_DESC_OPS per valid keypoint."""
    import torch
    from orb_slam2_detailed_comments_tpu_torch.ops.orb_desc import DESC_RADIUS, desc_constants
    dev = angle.device
    px, py = desc_constants(dev)[2:]
    r = torch.arange(-15, 16, device=dev)
    vv, uu = torch.meshgrid(r, r, indexing="ij")
    inside = vv * vv + uu * uu <= 240
    du, dv = uu[inside], vv[inside]
    n_px, s = 0, 0
    for img, n in zip(det.levels, det.counts):
        B, H, W = img.shape
        xy = det.xy_level[:, s:s + n].long()
        ok = det.valid[:, s:s + n]
        x = torch.where(xy[..., 0] < 0, xy[..., 0] + W + 2 * DESC_RADIUS, xy[..., 0]).clamp(0, W - 1)
        y = torch.where(xy[..., 1] < 0, xy[..., 1] + H + 2 * DESC_RADIUS, xy[..., 1]).clamp(0, H - 1)
        b = torch.arange(B, device=dev)[:, None, None].expand(B, n, 1)
        a = angle[:, s:s + n, None]
        c, sn = torch.cos(a), torch.sin(a)
        sx = torch.round(px * c - py * sn).long()
        sy = torch.round(px * sn + py * c).long()
        for ddx, ddy in ((du.expand(B, n, -1), dv.expand(B, n, -1)), (sx, sy)):
            cy = (y[..., None] + ddy).clamp(0, H - 1)
            cx = (x[..., None] + ddx).clamp(0, W - 1)
            idx = ((b * H + cy) * W + cx)[ok]
            n_px += int(torch.unique(idx).numel())
        s += n
    slots = det.valid.numel()
    return 4 * n_px + slots * (8 + 1 + 4 + 32), int(det.valid.sum()) * ORB_DESC_OPS


def _gather_bytes(src, xy, ph, pw):
    """Bytes that patch_gather must move for a (C, H, W) stack and (B, 2)
    window starts: the pixels under the windows (starts wrapped and clamped
    as patch_gather_plain takes them), each read once over all windows and
    channels (the union, counted on the device), the starts read and the
    (B, C, ph, pw) windows written."""
    import torch
    C, H, W = src.shape
    x, y = xy[:, 0].long(), xy[:, 1].long()
    x0 = torch.where(x < 0, x + W, x).clamp(0, W - pw)
    y0 = torch.where(y < 0, y + H, y).clamp(0, H - ph)
    rows = y0[:, None, None] + torch.arange(ph, device=src.device)[:, None]
    cols = x0[:, None, None] + torch.arange(pw, device=src.device)
    n_px = int(torch.unique(rows * W + cols).numel())
    return 4 * (C * n_px + xy.numel() + xy.shape[0] * C * ph * pw)


def _stereo_sad_bytes(img_l, xl, yl, xr, idx):
    """Bytes that stereo_sad must move for these slots: the pixels under the
    11x11 templates of the left image and the 11x21 strips of the right one
    (edge-clamped), each read once over all slots (the union per image,
    counted on the device), xl, yl, idx and xr read and two floats a slot
    written."""
    import torch
    from orb_slam2_detailed_comments_tpu_torch.ops.stereo_sad import SAD_HALF, SLIDE, round_clamp
    H, W = img_l.shape
    dev = img_l.device
    yl_i = round_clamp(yl, H)
    rows = (yl_i[:, None, None] + torch.arange(-SAD_HALF, SAD_HALF + 1, device=dev)[:, None])
    rows = rows.clamp(0, H - 1)
    n_px = 0
    for xc, half in ((round_clamp(xl, W), SAD_HALF),
                     (round_clamp(xr[idx.long()], W), SAD_HALF + SLIDE)):
        cols = (xc[:, None, None] + torch.arange(-half, half + 1, device=dev)).clamp(0, W - 1)
        n_px += int(torch.unique(rows * W + cols).numel())
    N = xl.numel()
    return 4 * (n_px + 3 * N + xr.numel() + 2 * N)


def _profile_frame(fn):
    """One call of fn under torch.profiler after a warm-up: the CUDA
    kernels it launched and the device's busy share, the union of the
    device activities' intervals over the host time of the call (the
    profiler slows the host, so the share is a lower bound). The device
    activities are read from the profiler's raw events: building its
    FunctionEvent list takes the host seconds for a call of tens of
    thousands of kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    dev = sorted((e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3) for e in events)
    if not dev:
        return None, None
    kernels = sum(1 for e in events if not e.name().startswith(("Memcpy", "Memset")))
    busy, (lo, hi) = 0.0, dev[0]
    for a, b in dev[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    return kernels, busy / wall_us


def pad_map(pos, normal, mind, maxd, desc, valid):
    """A local map of bench.py's inputs packed into the PAD_SLOTS-slot pad
    of the fused frames (frontend/device_map.py's layout)."""
    import torch
    n, dev = pos.shape[0], pos.device
    packed = torch.zeros((PAD_SLOTS, 8), dtype=torch.float32, device=dev)
    packed[:n] = torch.cat([pos, normal, mind[:, None], maxd[:, None]], 1)
    d = torch.zeros((PAD_SLOTS, 8), dtype=torch.int32, device=dev)
    d[:n] = desc
    v = torch.zeros((PAD_SLOTS,), dtype=torch.bool, device=dev)
    v[:n] = valid
    return packed, d, v


# ---- rendered sequences (numpy; no jax) ------------------------------------------

def smooth_trajectory(n_frames, step=SEQ_STEP, yaw_amp=0.02, y_amp=0.05):
    """World->camera poses of a sideways-dominant smooth path: a numpy copy
    of tests/synthetic_world.py::smooth_trajectory."""
    poses = []
    for i in range(n_frames):
        y = y_amp * np.sin(2 * np.pi * i / max(n_frames, 1) * 2)
        yaw = yaw_amp * np.sin(2 * np.pi * i / max(n_frames, 1))
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = -R @ np.array([step * i, y, 0.0], np.float32)
        poses.append(T)
    return np.stack(poses)


def _right_pose(Tcw, baseline):
    T_rl = np.eye(4, dtype=np.float32)
    T_rl[0, 3] = -baseline
    return T_rl @ Tcw


def _check_on_texture(world, poses, rays=None):
    """Every ray of the image border must hit the texture inside its
    wrap-around: a wrapped texture repeats features and makes false matches.
    (Each plane's texture coordinates are affine in the hit point, so the
    border rays bound the whole image.) `rays`: (H, W, 3) camera-frame
    directions of the pixels, if not the pinhole camera's."""
    H, W = world.height, world.width
    if rays is None:
        us = np.concatenate([np.arange(W), np.arange(W), np.zeros(H), np.full(H, W - 1)])
        vs = np.concatenate([np.zeros(W), np.full(W, H - 1), np.arange(H), np.arange(H)])
        d_c = np.stack([(us - world.cx) / world.fx, (vs - world.cy) / world.fy,
                        np.ones_like(us)], -1)
    else:
        d_c = np.concatenate([rays[0], rays[-1], rays[:, 0], rays[:, -1]])
    size = world.tex.shape[0]
    for Tcw in poses:
        R, t = Tcw[:3, :3], Tcw[:3, 3]
        p, lam, _ = world._intersect(-R.T @ t, (d_c @ R)[None])
        off = np.where(p[..., 2] > (world.z_near + world.z_far) / 2, size // 2, 0)
        tx = p[..., 0] * world.tex_scale + size // 2 + off * 0.5
        ty = p[..., 1] * world.tex_scale + size // 2
        if not (lam.min() > 0 and tx.min() >= 0 and tx.max() < size - 1
                and ty.min() >= 0 and ty.max() < size - 1):
            raise AssertionError(f"the view leaves the {size}-px texture: x {tx.min():.0f}.."
                                 f"{tx.max():.0f}, y {ty.min():.0f}..{ty.max():.0f}")


@functools.lru_cache(maxsize=None)
@functools.lru_cache(maxsize=None)
def render_sequence(sensor):
    """(poses (N, 4, 4) world->camera, frames: the argument tuples of the
    tracker's entry point without the timestamp) for the TRACK_SEQS entry
    `sensor` (monocular unless "stereo" or "rgbd")."""
    from orb_slam2_detailed_comments_tpu_torch.examples._driver import load_synthetic_world
    synthetic_world = load_synthetic_world()
    PlanesWorld = synthetic_world.PlanesWorld
    seq = TRACK_SEQS[sensor]
    c = seq["cam"]
    world = PlanesWorld(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"], width=c["width"],
                        height=c["height"], tex_scale=seq["tex_scale"])
    if "n_blobs" in seq:
        world.tex = synthetic_world.make_texture(n_blobs=seq["n_blobs"])
    poses = smooth_trajectory(SEQ_FRAMES)
    baseline = c["bf"] / c["fx"]
    _check_on_texture(world, poses)
    if sensor == "stereo":
        _check_on_texture(world, [_right_pose(T, baseline) for T in poses])
    rng = np.random.default_rng(0)

    def noisy(img):
        return np.clip(img + rng.uniform(-SEQ_NOISE, SEQ_NOISE, img.shape), 0, 255).astype(np.float32)

    frames = []
    for T in poses:
        args = [noisy(world.render(T))]
        if sensor == "stereo":
            args.append(noisy(world.render(_right_pose(T, baseline))))
        elif sensor == "rgbd":
            args.append(world.render_depth(T))
        frames.append(tuple(args))
    return poses, frames


PERTURB_GREY = 1e-3


def perturbed_run(sensor, spec):
    """The inputs of a System phase changed by nothing of substance, for
    reading how far a System's counts and ATE move under such a change
    (tests/torch_parity.py system, tools/system_devices.py). `spec`:
    None (the phase's own frames), "noise<seed>" (every image plus seeded
    uniform noise of +-PERTURB_GREY grey levels, far below the images'
    1-level quantization; depth maps untouched) or "staged" (the frames
    as they are, tracked on the staged path instead of the fused one).
    Returns (poses, frames, use_fused)."""
    poses, frames = render_sequence(sensor)
    if spec is None or spec == "staged":
        return poses, frames, spec is None
    if not spec.startswith("noise"):
        raise ValueError(f"unknown perturbation {spec!r}")
    rng = np.random.default_rng(int(spec[len("noise"):]))
    n_img = 2 if sensor == "stereo" else 1
    frames = [tuple((a + rng.uniform(-PERTURB_GREY, PERTURB_GREY, a.shape)).astype(np.float32)
                    if k < n_img else a for k, a in enumerate(f)) for f in frames]
    return poses, frames, True


BA_CAM = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=40.0, width=640, height=480)


def _rotation(w):
    """Rodrigues: rotation vector (3,) -> (3, 3)."""
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def synthetic_ba_problem(bucket, seed=0, fill=0.9, outlier_share=0.03):
    """A seeded local-BA problem padded to `bucket` = (C, P, E), a bucket of
    backend/local_mapping.BA_BUCKETS, as numpy arrays named as BAProblem's
    fields. C - 2 cameras 0.25 m apart in a sideways row look at `fill` * P points 4-12 m
    away (BA_CAM intrinsics); each point is seen by 2-4 of the cameras that
    see it, in point-major edge order (one seen by fewer is not valid); half the edges are stereo; the
    observations carry 0.5 px of noise and about `outlier_share` of them
    15-30 px more. The first two cameras are fixed; the free ones and the points
    start from a perturbed estimate."""
    C, P, E = bucket
    rng = np.random.default_rng(seed)
    n_cams, n_pts = C - 2, int(fill * P)
    f, cx, cy, bf = BA_CAM["fx"], BA_CAM["cx"], BA_CAM["cy"], BA_CAM["bf"]
    cam_Tcw = np.tile(np.eye(4), (C, 1, 1))
    for c in range(n_cams):
        R = _rotation(rng.normal(0, 0.02, 3))
        cam_Tcw[c, :3, :3] = R
        cam_Tcw[c, :3, 3] = -R @ np.array([0.25 * c, rng.normal(0, 0.05), 0.0])
    span = 0.25 * n_cams
    X = np.stack([rng.uniform(-2.0, span + 2.0, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                  rng.uniform(4.0, 12.0, n_pts)], -1)
    pc = np.einsum("cij,pj->pci", cam_Tcw[:n_cams, :3, :3], X) + cam_Tcw[:n_cams, :3, 3]
    u = f * pc[..., 0] / pc[..., 2] + cx
    v = f * pc[..., 1] / pc[..., 2] + cy
    seen = (pc[..., 2] > 0) & (u >= 0) & (u < BA_CAM["width"]) & (v >= 0) & (v < BA_CAM["height"])
    # each point: 2-4 random cameras among those that see it (a point seen
    # by fewer than two is left out)
    key = np.where(seen, rng.random(seen.shape), 2.0)
    order = np.argsort(key, axis=1)
    n_obs = np.minimum(rng.integers(2, 5, n_pts), seen.sum(1))
    n_obs[n_obs < 2] = 0
    take = np.arange(n_cams)[None, :] < n_obs[:, None]
    e_pt, slot = np.nonzero(take)
    e_cam = order[e_pt, slot]
    n_e = min(e_pt.size, E)
    e_pt, e_cam = e_pt[:n_e], e_cam[:n_e]
    obs = np.stack([u[e_pt, e_cam], v[e_pt, e_cam], u[e_pt, e_cam] - bf / pc[e_pt, e_cam, 2]], -1)
    obs += rng.normal(0, 0.5, obs.shape)
    # at most one outlier a point, and only on points seen 3-4 times: the
    # gated outlier must not leave a point with a single edge
    bad = (rng.random(n_e) < outlier_share) & (n_obs[e_pt] >= 3) & (slot[:n_e] == 0)
    obs[bad, :2] += rng.uniform(15, 30, (int(bad.sum()), 2)) * rng.choice([-1, 1], (int(bad.sum()), 2))
    obs[rng.random(n_e) < 0.5, 2] = -1.0
    init = cam_Tcw.copy()
    for c in range(2, n_cams):
        init[c, :3, :3] = _rotation(rng.normal(0, 0.002, 3)) @ init[c, :3, :3]
        init[c, :3, 3] += rng.normal(0, 0.01, 3)
    points = np.zeros((P, 3))
    points[:n_pts] = X + rng.normal(0, 0.03, X.shape)

    def pad(a, n, dtype):
        out = np.zeros((n,) + a.shape[1:], dtype)
        out[:len(a)] = a
        return out

    return dict(
        cam_Tcw=init.astype(np.float32), cam_free=np.arange(C) >= 2,
        cam_valid=np.arange(C) < n_cams, points=points.astype(np.float32),
        point_valid=pad(n_obs > 0, P, bool), edge_cam=pad(e_cam, E, np.int32),
        edge_point=pad(e_pt, E, np.int32), edge_obs=pad(obs, E, np.float32),
        edge_octave=pad(rng.integers(0, 4, n_e), E, np.int32),
        edge_valid=np.arange(E) < n_e)


# ---- loop closing's solvers ([14], [16]; numpy, no jax) ----------------------

# examples/bench_gba.py's default problem: 11 KITTI sequences x 128
# keyframes, 60k points, 256 observations a keyframe (~360k edges)
GBA_BENCH = dict(n_cams=1408, n_points=60000, obs_per_cam=256)
GBA_CAM = dict(fx=718.0, fy=718.0, cx=607.0, cy=185.0)
GBA_INV_S2 = np.array([1.0 / 1.2 ** (2 * i) for i in range(8)], np.float32)
# The JAX package's grouped global BA on the same problem, run on the CPU
# (its exact-float32 "gather" formulation, 10 LM x 50 CG, jax 0.9.0) by
# `JAX_PLATFORMS=cpu python tests/torch_parity.py gba` (jax_gba_anchor): the
# robust cost over all edges before and after. [14] holds the port's final
# cost within GBA_COST_RTOL of it, and its solve of the stereo System's map
# against the flat solver within the JAX package's own grouped-against-flat
# tolerances (tests/test_global_ba_grouped.py:101-104).
JAX_CPU_GBA = dict(edges=360448, cost_before=2032548352.0, cost_after=134502.96875)
GBA_COST_RTOL = 0.01
GBA_CAM_TOL, GBA_PT_TOL = 2e-3, 2e-2
# ---- [21] the entry points and the sharded global BA --------------------------
# The JAX package's __graft_entry__.entry() (the fused mono frame on
# example_tracking_args' 640x480 noise image and 4096 random map points),
# run on the CPU in the modes of JAX_CPU_TRACKER, jax 0.9.0, by
# `JAX_PLATFORMS=cpu python tests/torch_parity.py entry` (jax_entry_anchor):
# valid keypoints, matched map points, the two stages' inliers, visible map
# points and the pose. [21](a) holds the counts exact and the pose within
# POSE_TOL_M and POSE_TOL_DEG (random descriptors match one point: the pose
# is that one point's GN step from the identity, as in JAX).
JAX_CPU_ENTRY = dict(keypoints=1000, matched=1, n_in=1, n_in1=1, visible=3076, Tcw=[
    [0.9998890161514282, 0.004791791085153818, 0.014107983559370041, 0.0016092658042907715],
    [-0.004135446157306433, 0.9989241361618042, -0.046190086752176285, -0.005943243857473135],
    [-0.014314137399196625, 0.04612661525607109, 0.9988330602645874, -0.002333652460947633],
    [0.0, 0.0, 0.0, 1.0]])
# [21](c): a problem the sharded route solves with "dense": DENSE_MAX_CAMS
# cameras at examples/bench_gba.py's density (256 observations a camera,
# 60,000 points a 1,408 cameras, so 21,818 points), bench_scaling's draws.
# Held to solve_grouped at GBA_CAM_TOL, GBA_COST_RTOL and, for the points
# the mapper would triangulate, GBA_PT_TOL: the drawn points include some
# whose rays meet at under acos(TRIANGULATION_COS) = 1.15 deg, whose depth
# the observations hardly fix, so two float32 solvers part there by cm
# (PERF.md section 6); a map from the port's mapper holds no such
# monocular point.
DENSE_ROUTE = dict(n_cams=512, n_points=21818, obs_per_cam=256)
# backend/local_mapping.py's monocular triangulation gate (the reference's
# cosParallaxRays < 0.9998)
TRIANGULATION_COS = 0.9998


def max_parallax_deg(prob, cam_Tcw, points):
    """Each point's largest angle (degrees) between two of its observing
    rays, at the given cameras and points; 0 for a point seen once."""
    import torch
    R, t = cam_Tcw[:, :3, :3], cam_Tcw[:, :3, 3]
    centers = -(R.transpose(1, 2) @ t[..., None])[..., 0]
    e_cam, e_pt = prob.edge_cam.long(), prob.edge_point.long()
    ray = points[e_pt] - centers[e_cam]
    ray = ray / ray.norm(dim=1, keepdim=True)
    n_pts = points.shape[0]
    order = torch.argsort(e_pt, stable=True)
    e_pt, ray = e_pt[order], ray[order]
    deg = torch.bincount(e_pt, minlength=n_pts)
    slot = torch.arange(e_pt.shape[0], device=e_pt.device) - (torch.cumsum(deg, 0) - deg)[e_pt]
    rays = torch.zeros(n_pts, int(deg.max()), 3, device=points.device)
    seen = torch.zeros(rays.shape[:2], dtype=torch.bool, device=points.device)
    rays[e_pt, slot] = ray
    seen[e_pt, slot] = True
    cos = torch.einsum("pid,pjd->pij", rays, rays)
    pair = seen[:, :, None] & seen[:, None, :] & ~torch.eye(seen.shape[1], dtype=torch.bool,
                                                             device=seen.device)
    cos = torch.where(pair, cos, torch.ones((), device=cos.device))
    return torch.rad2deg(torch.acos(cos.amin(dim=(1, 2)).clamp(-1.0, 1.0)))
# [21](d): examples/bench_scaling.py's rows at these ranks over Gloo, every
# rank on the one card, and its permuted one-rank row. Its problem cut to
# half the cameras and half the points (obs_per_cam kept: six observations
# a point, as at full size), with solve_global_ba's schedule (10 LM x 50 CG;
# at the driver's default 4 x 30 the LM stops far from its optimum, where
# any change of float order, the point order on one rank as much as a
# second rank, flips edges across the chi2 gate: PERF.md section 6), one
# timed solve a row (its default 3). Each row within the JAX tests' grouped
# tolerances (GBA_CAM_TOL, GBA_PT_TOL) of the one-rank solve, its robust
# cost within GBA_COST_RTOL.
SCALING = dict(ranks=(1, 2, 4), cams=704, points=30000, obs_per_cam=256, iters=10, cg=50,
               reps=1, permuted=1)
# [15]: the mono System at configs/KITTI04-12.yaml must initialize and track
# this many of the rendered frames after the one it initialized on
MONO_KITTI_TRACKED = 10
# [16]: (keyframes, backend, GN iterations) as examples/bench_pose_graph.py
# runs them (KITTI-00's ~1400 keyframes), but the banded solve at 10
# iterations where the bench runs 20 (the script's time; the cg solve cuts
# the errors 660x in 10), and each Sim3 step timed SIM3_TIMED times
POSE_GRAPH_CASES = ((1408, "auto", 10), (256, "auto", 10), (1408, "cg", 10))
SIM3_TIMED = 3


def gba_bench_problem(n_cams, n_points, obs_per_cam, seed=0):
    """examples/bench_scaling.py::build_problem's draws as numpy arrays named
    as BAProblem's fields (the port's examples/bench_scaling.problem_arrays):
    cameras on a long noisy forward path, each observing obs_per_cam random
    points (monocular, 0.5 px of noise); the first two cameras fixed, the
    points perturbed by 5 cm."""
    from orb_slam2_detailed_comments_tpu_torch.examples.bench_scaling import problem_arrays
    return problem_arrays(n_cams, n_points, obs_per_cam, seed)


def _small_sim3(xi):
    """exp_sim3 of a drift-sized tangent: a numpy copy of
    examples/bench_pose_graph.py's (Rodrigues, exp of the scale, V to
    second order)."""
    rho, phi, sigma = xi[:3], xi[3:6], xi[6]
    th = np.linalg.norm(phi)
    Wm = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]], [-phi[1], phi[0], 0]])
    if th < 1e-8:
        R = np.eye(3) + Wm
    else:
        R = np.eye(3) + np.sin(th) / th * Wm + (1 - np.cos(th)) / th ** 2 * (Wm @ Wm)
    S = np.eye(4)
    S[:3, :3] = np.exp(sigma) * R
    S[:3, 3] = (np.eye(3) + 0.5 * (Wm + sigma * np.eye(3))) @ rho
    return S.astype(np.float32)


def circle_pose_graph(Kn, seed=7, drift=0.01, covis_every=4):
    """A numpy copy of examples/bench_pose_graph.py::circle_problem:
    keyframes on a 50 m circle, a drifted odometry chain, one loop edge and
    a covisibility edge every `covis_every` keyframes, all measurements
    exact. Returns (fields of PoseGraphProblem as numpy arrays, S_true,
    S_est)."""
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(Kn) / Kn
    c, s = np.cos(ang), np.sin(ang)
    R_all = np.zeros((Kn, 3, 3))
    R_all[:, 0, 0], R_all[:, 0, 2], R_all[:, 1, 1] = c, s, 1.0
    R_all[:, 2, 0], R_all[:, 2, 2] = -s, c
    C_all = 50.0 * np.stack([s, np.zeros(Kn), 1 - c], -1)
    S_true = np.tile(np.eye(4), (Kn, 1, 1))
    S_true[:, :3, :3] = R_all
    S_true[:, :3, 3] = -np.einsum("kij,kj->ki", R_all, C_all)
    S_true = S_true.astype(np.float32)
    S_true_inv = np.linalg.inv(S_true.astype(np.float64))

    def rel(i, j):
        return (S_true[j].astype(np.float64) @ S_true_inv[i]).astype(np.float32)

    S_est = [S_true[0]]
    for i in range(1, Kn):
        noise = _small_sim3(np.concatenate([rng.normal(0, drift, 6), [rng.normal(0, drift / 2)]]))
        S_est.append((noise @ rel(i - 1, i) @ S_est[i - 1]).astype(np.float32))
    S_est = np.stack(S_est)
    e_i = list(range(Kn - 1)) + [Kn - 1] + list(range(0, Kn - covis_every, covis_every))
    e_j = list(range(1, Kn)) + [0] + [i + covis_every for i in range(0, Kn - covis_every,
                                                                     covis_every)]
    E = len(e_i)
    prob = dict(S_init=S_est, vertex_fixed=np.arange(Kn) == 0, vertex_valid=np.ones(Kn, bool),
                edge_i=np.asarray(e_i, np.int32), edge_j=np.asarray(e_j, np.int32),
                edge_Sji=np.stack([rel(i, j) for i, j in zip(e_i, e_j)]),
                edge_valid=np.ones(E, bool), edge_weight=np.ones(E, np.float32))
    return prob, S_true, S_est


SIM3_K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], np.float32)
SIGMA2 = np.array([1.2 ** (2 * i) for i in range(8)], np.float32)


def loop_matches(n=300, outlier_share=0.3, scale=1.3, seed=0):
    """Seeded loop-closure matches between a candidate keyframe (2) and the
    current one (1), as tests/test_sim3_posegraph.py builds them: n points
    2-9 m in front of camera 2, p1 = s R p2 + t, `outlier_share` of them
    moved 1-3 m in camera 1, pixels by SIM3_K, octaves 0-3. Returns
    (p1, p2, uv1, uv2, oct1, oct2, R, t, s)."""
    rng = np.random.default_rng(seed)
    R = _rotation(rng.normal(0, 0.2, 3))
    t = rng.normal(0, 0.5, 3)
    p2 = rng.uniform([-2, -2, 4], [2, 2, 9], (n, 3))
    p1 = scale * p2 @ R.T + t
    bad = rng.choice(n, int(outlier_share * n), replace=False)
    p1[bad] += rng.uniform(1, 3, (bad.size, 3))

    def project(p):
        return (p[:, :2] / p[:, 2:3]) * SIM3_K[0, 0] + SIM3_K[:2, 2]

    o1, o2 = rng.integers(0, 4, n), rng.integers(0, 4, n)
    return (p1.astype(np.float32), p2.astype(np.float32), project(p1).astype(np.float32),
            project(p2).astype(np.float32), o1, o2, R, t, scale)


def slam_config_kwargs(sensor):
    """Keyword arguments of SlamConfig, OrbConfig and PinholeCamera (the
    same fields in both packages) for a tracker phase."""
    s = TRACK_SEQS[sensor]
    return dict(camera=dict(s["cam"]), orb=dict(n_features=s["n_features"], max_keypoints=2048),
                fps=s["fps"], th_depth=s["th_depth"])


def drive_tracker(tracker, sensor, poses, frames, sync=lambda: None):
    """Feed the frames to a Tracker (either package's). Returns the frames
    tracked, the frames that took the fused path (a fused frame whose gate
    fails finishes on the staged cascade) and the staged path (the others:
    initialization, the first frame after it, thin-map fallbacks), the
    keyframes, the ATE against the rendered ground truth (rigid alignment;
    with scale for mono) and the host ms of each fused and staged frame."""
    from orb_slam2_detailed_comments_tpu_torch.evaluation.ate import ate_rmse
    entry = getattr(tracker, {"stereo": "track_stereo", "rgbd": "track_rgbd",
                              "mono": "track_monocular"}[sensor])
    fps = TRACK_SEQS[sensor]["fps"]
    est, gt, ms_fused, ms_staged = [], [], [], []
    for i, args in enumerate(frames):
        n_fused = tracker.fused_frames
        t0 = time.perf_counter()
        Tcw = entry(*args, i / fps)
        sync()
        dt = 1e3 * (time.perf_counter() - t0)
        (ms_fused if tracker.fused_frames > n_fused else ms_staged).append(dt)
        if Tcw is not None and tracker.state.name == "OK":
            est.append(np.linalg.inv(Tcw)[:3, 3])
            gt.append(np.linalg.inv(poses[i])[:3, 3])
    if len(est) < 3:
        raise AssertionError(f"{sensor}: only {len(est)} frames tracked")
    ate = ate_rmse(np.asarray(est, np.float64), np.asarray(gt, np.float64),
                   with_scale=sensor == "mono")
    return dict(tracked=len(est), fused=len(ms_fused), staged=len(ms_staged),
                keyframes=int(tracker.map.n_keyframes()), ate_m=ate,
                ms_fused=ms_fused, ms_staged=ms_staged)


def drive_system(slam, sensor, poses, frames, sync=lambda: None):
    """Drive a System (either package's) through the three parts of a
    System phase: the SEQ_FRAMES mapped frames, SYS_BLANK blank frames
    (black images, zero depth), which must leave it LOST, and up to
    SYS_REVISITS revisits of frame SYS_REVISIT_FRAME's view, as
    tests/test_relocalization.py does. Returns the counts the phases are
    held to (frames tracked, LOST after the blanks, the revisit that
    relocalized, keyframes and map points alive at the end, the ATE of the
    mapped frames against the rendered ground truth) and the host ms of
    each keyframe frame, non-keyframe frame and relocalization attempt."""
    from orb_slam2_detailed_comments_tpu_torch.evaluation.ate import ate_rmse
    entry = getattr(slam, {"stereo": "track_stereo", "rgbd": "track_rgbd",
                           "mono": "track_monocular"}[sensor])
    fps = TRACK_SEQS[sensor]["fps"]
    reloc_ms = []
    relocalizer = slam.tracker.relocalizer

    def timed_relocalizer(frame):
        t0 = time.perf_counter()
        ok = relocalizer(frame)
        sync()
        reloc_ms.append(1e3 * (time.perf_counter() - t0))
        return ok

    if relocalizer is not None:
        slam.tracker.relocalizer = timed_relocalizer
    est, gt, ms_kf, ms_other = [], [], [], []

    def feed(args, ts):
        n_kf = slam.map.n_kf
        t0 = time.perf_counter()
        Tcw = entry(*args, ts)
        sync()
        (ms_kf if slam.map.n_kf > n_kf else ms_other).append(1e3 * (time.perf_counter() - t0))
        return Tcw if Tcw is not None and slam.tracking_state.name == "OK" else None

    for i, args in enumerate(frames):
        Tcw = feed(args, i / fps)
        if Tcw is not None:
            est.append(np.linalg.inv(Tcw)[:3, 3])
            gt.append(np.linalg.inv(poses[i])[:3, 3])
    if len(est) < 3:
        raise AssertionError(f"{sensor}: only {len(est)} frames tracked")
    ate = ate_rmse(np.asarray(est, np.float64), np.asarray(gt, np.float64),
                   with_scale=sensor == "mono")
    blank = tuple(np.zeros_like(a) for a in frames[0])
    for j in range(SYS_BLANK):
        feed(blank, (len(frames) + j) / fps)
    lost = slam.tracking_state.name == "LOST"
    relocalized, reloc_err_m = None, None
    for j in range(SYS_REVISITS):
        Tcw = feed(frames[SYS_REVISIT_FRAME], (len(frames) + SYS_BLANK + j) / fps)
        if Tcw is not None:
            relocalized = j
            reloc_err_m = float(np.linalg.norm(np.linalg.inv(Tcw)[:3, 3]
                                               - np.linalg.inv(poses[SYS_REVISIT_FRAME])[:3, 3]))
            break
    slam.tracker.relocalizer = relocalizer
    return dict(tracked=len(est), lost=lost, relocalized=relocalized, positions=np.asarray(est),
                keyframes=int(slam.map.n_keyframes()), map_points=int(slam.map.n_map_points()),
                ate_m=ate, reloc_err_m=reloc_err_m, ms_kf=ms_kf, ms_other=ms_other,
                reloc_ms=reloc_ms)


# ---- [17] a loop lap through System with loop closing on ------------------------
# tests/test_loop_sequence.py's lap (CylinderWorld of radius 8, the camera on
# a 4 m circle looking outward, the last OVERLAP frames revisiting the first
# views) at TUM's width: 640x480, 1000 features, the lap test's 83 deg field
# of view (fx 360) and 0.5 m baseline, with the tracker phases' +-SEQ_NOISE
# grey levels of seeded sensor noise (the JAX and torch pyramids part by
# float32 ulps on flat regions, which flips FAST ties and BRIEF comparisons;
# loop_lap_frames("clean") renders the lap without it)
LOOP_LAP = dict(cam=dict(fx=360.0, fy=360.0, cx=320.0, cy=240.0, bf=180.0, width=640,
                         height=480),
                n_features=1000, max_keypoints=1024, fps=10.0, max_keyframes=150,
                max_map_points=40000, radius=8.0, frames=120, path_radius=4.0, overlap=32)


# The JAX package's System(cfg, Sensor.RGBD, enable_loop_closing=True) on
# the same frames (drive_loop_lap), run on the CPU in the modes of
# JAX_CPU_TRACKER, jax 0.9.0, by `JAX_PLATFORMS=cpu python
# tests/torch_parity.py loop` (jax_loop_anchor; about 20 min): loops as
# (frame, keyframe). Limits: frames tracked and the number of loops exact,
# each loop's keyframe within LOOP_KF_TOL; live keyframes within SYS_KF_TOL;
# live map points within SYS_MP_RTOL; the exported trajectory's ATE within
# ATE_RTOL of the anchor or LOOP_ATE_ATOL_M, whichever is larger.
# LOOP_ATE_ATOL_M is the JAX package's own spread: with +-1e-3 grey levels
# of noise on its images (seeds 1-2, loop_lap_frames; `tests/torch_parity.py
# loop noise1 noise2`) its lap lands at 21.666 and 26.767 mm against the
# anchor's 31.529, so up to 9.863 mm from it; it closes the same loop at
# frame 83 each time, with 82 and 78 live keyframes and 6,442 and 6,462
# map points. Without the sensor noise (`loop clean`) it closes the same
# loop with 78 live keyframes, 6,790 map points and 40.304 mm.
JAX_CPU_LOOP = dict(tracked=120, loops=[(83, 83)], keyframes=80, allocated=120,
                    map_points=6422, ate_m=0.03152907496912604)
LOOP_KF_TOL = 2
LOOP_ATE_ATOL_M = 0.0099


def loop_lap_misses(res, ref=JAX_CPU_LOOP):
    """The anchors of [17] that a lap's result (drive_loop_lap) misses, as
    text; none if it meets them all."""
    out = []
    if res["tracked"] != ref["tracked"]:
        out.append(f"tracked {res['tracked']} (JAX {ref['tracked']})")
    if len(res["loops"]) != len(ref["loops"]) \
            or any(abs(a[1] - b[1]) > LOOP_KF_TOL for a, b in zip(res["loops"], ref["loops"])):
        out.append(f"loops (frame, keyframe) {res['loops']} (JAX {ref['loops']})")
    if abs(res["keyframes"] - ref["keyframes"]) > SYS_KF_TOL:
        out.append(f"keyframes {res['keyframes']} (JAX {ref['keyframes']})")
    if abs(res["map_points"] - ref["map_points"]) > SYS_MP_RTOL * ref["map_points"]:
        out.append(f"map points {res['map_points']} (JAX {ref['map_points']})")
    if abs(res["ate_m"] - ref["ate_m"]) > max(ATE_RTOL * ref["ate_m"], LOOP_ATE_ATOL_M):
        out.append(f"ATE {res['ate_m']} m (JAX {ref['ate_m']} m)")
    return out


def loop_lap_config_kwargs():
    """Keyword arguments of SlamConfig, OrbConfig and PinholeCamera (the
    same fields in both packages) for the lap."""
    s = LOOP_LAP
    return dict(camera=dict(s["cam"]), orb=dict(n_features=s["n_features"],
                                                max_keypoints=s["max_keypoints"]),
                fps=s["fps"], max_keyframes=s["max_keyframes"],
                max_map_points=s["max_map_points"])


@functools.lru_cache(maxsize=None)
def render_loop_lap(noise=SEQ_NOISE):
    """(poses (N, 4, 4) world->camera, frames: (image, depth) per frame) of
    the LOOP_LAP sequence, its images with +-`noise` grey levels of seeded
    sensor noise (none if 0)."""
    from orb_slam2_detailed_comments_tpu_torch.examples._driver import load_synthetic_world
    sw = load_synthetic_world()
    s, c = LOOP_LAP, LOOP_LAP["cam"]
    world = sw.CylinderWorld(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"], width=c["width"],
                             height=c["height"], radius=s["radius"])
    poses = sw.loop_trajectory(s["frames"], path_radius=s["path_radius"], overlap=s["overlap"])
    rng = np.random.default_rng(0)
    frames = []
    for T in poses:
        img = world.render(T)
        if noise:
            img = np.clip(img + rng.uniform(-noise, noise, img.shape), 0, 255)
        frames.append((img.astype(np.float32), world.render_depth(T).astype(np.float32)))
    return poses, frames


def loop_lap_frames(spec=None):
    """The lap's frames; with spec "noise<seed>" every image plus seeded
    uniform noise of +-PERTURB_GREY grey levels (as perturbed_run); with
    "clean" the images rendered without the sensor noise."""
    if spec == "clean":
        return render_loop_lap(0.0)
    poses, frames = render_loop_lap()
    if spec is None:
        return poses, frames
    if not spec.startswith("noise"):
        raise ValueError(f"unknown perturbation {spec!r}")
    rng = np.random.default_rng(int(spec[len("noise"):]))
    return poses, [((img + rng.uniform(-PERTURB_GREY, PERTURB_GREY, img.shape)).astype(np.float32),
                    depth) for img, depth in frames]


def exported_ate(slam, poses):
    """The ATE of the exported trajectory (every frame recomputed from its
    corrected reference keyframe, io/trajectory.py::recover_frame_trajectory),
    as tests/test_loop_sequence.py scores a lap, and the number of frames in it."""
    from orb_slam2_detailed_comments_tpu_torch.evaluation.ate import ate_rmse
    from orb_slam2_detailed_comments_tpu_torch.io.trajectory import recover_frame_trajectory
    rec = recover_frame_trajectory(slam.tracker.trajectory, slam.map)
    est = np.asarray([np.linalg.inv(T)[:3, 3] for _, _, T in rec], np.float64)
    gt = np.asarray([np.linalg.inv(poses[f])[:3, 3] for f, _, _ in rec], np.float64)
    return ate_rmse(est, gt, with_scale=False), len(rec)


def drive_loop_lap(slam, poses, frames, sync=lambda: None):
    """Feed the lap to a System (either package's) with loop closing on.
    Returns the frames tracked, the loops closed with the frame and the
    keyframe of each, the live keyframes and map points at the end, the
    keyframes allocated, the exported trajectory's ATE, and the host ms of
    each frame with whether it made a keyframe, and the loop closer's stage
    ms of each loop-closing frame (the port's LoopCloser has a timer)."""
    fps = LOOP_LAP["fps"]
    lc = slam.loop_closer
    timer = getattr(lc, "timer", None)
    tracked, loops, frame_ms, stage_ms = 0, [], [], []
    for i, (img, depth) in enumerate(frames):
        n_kf, n_loops = slam.map.n_kf, lc.n_loops_closed
        seen = {k: len(v) for k, v in timer.samples.items()} if timer else {}
        t0 = time.perf_counter()
        Tcw = slam.track_rgbd(img, depth, i / fps)
        sync()
        frame_ms.append((1e3 * (time.perf_counter() - t0), slam.map.n_kf > n_kf))
        tracked += Tcw is not None and slam.tracking_state.name == "OK"
        if lc.n_loops_closed > n_loops:
            loops.append((i, int(lc.last_loop_kf)))
            if timer:
                stage_ms.append({k: 1e3 * sum(v[seen.get(k, 0):])
                                 for k, v in timer.samples.items() if len(v) > seen.get(k, 0)})
    ate, n_exported = exported_ate(slam, poses)
    return dict(tracked=tracked, loops=loops, keyframes=int(slam.map.n_keyframes()),
                allocated=int(slam.map.n_kf), map_points=int(slam.map.n_map_points()),
                ate_m=ate, exported=n_exported, frame_ms=frame_ms, stage_ms=stage_ms)


# ---- [18] LoopCloser on a drifted loop at KITTI size ---------------------------
# configs/KITTI00-02.yaml's camera and 2000 keypoints a keyframe; LAP_KFS
# keyframes on a circle of LOOP_RADIUS m facing along it (KITTI-00 takes
# keyframes ~1.5 m apart), then REVISIT_KFS keyframes that drive the first
# segments again one lane over (LANE_M m to the side, YAW_DEG deg off),
# so the consistency chain reaches 3 on the fourth of them. More than 256
# keyframes: the essential graph takes the banded backend, as a KITTI-00
# loop does.
LOOP_MAP = dict(cam=TRACK_SEQS["stereo"]["cam"], n_features=2000, max_keypoints=2048,
                lap_kfs=264, revisit_kfs=6, radius=62.0, new_points=300, shared_points=100,
                depth=(5.0, 40.0), lane_m=0.5, yaw_deg=1.0, yaw_bias=1e-4, rot_drift=1e-4,
                trans_drift=0.01,
                pixel_noise=0.5, desc_flips=4, seed=0)


# The JAX package's LoopCloser on the same map (drive_loop_map), run on the
# CPU, jax 0.9.0, by `JAX_PLATFORMS=cpu python tests/torch_parity.py
# loop_map` (jax_loop_map_anchor). Limits: the loop closed, its keyframe and
# loop keyframe exact; S_cl within 1e-3 rad and 1e-3 relative in
# translation; the essential graph's keyframes and edges exact; the lap-end
# and mean keyframe-centre errors within 10%, each cut at least 2x from the
# drifted map's; the global BA's edges exact, its robust cost after within
# GBA_COST_RTOL.
JAX_CPU_LOOP_MAP = dict(
    closed=[(267, 3, [[0.9998468, -2.85e-05, -0.0175022, -0.4981329],
                      [2.28e-05, 0.9999999, -0.0003244, 0.0087016],
                      [0.0175022, 0.000324, 0.9998468, -0.0075218], [0.0, 0.0, 0.0, 1.0]])],
    graphs=[(270, 274)], err_before=(1.7957355150520642, 1.0568584840761488),
    err_after=(0.01874759132233069, 0.18975269653714144),
    gba=[dict(edges=107842, cost_before=220615.359375, cost_after=13969.3046875)])


def loop_map_config_kwargs():
    s = LOOP_MAP
    return dict(camera=dict(s["cam"]), orb=dict(n_features=s["n_features"],
                                                max_keypoints=s["max_keypoints"]),
                fps=10.0, th_depth=35.0, max_keyframes=s["lap_kfs"] + s["revisit_kfs"] + 8,
                max_map_points=(s["lap_kfs"] + s["revisit_kfs"]) * s["new_points"] + 8)


def _pose(R, C):
    """World -> camera (4, 4) float32 from camera-to-world rotation R and centre C."""
    T = np.eye(4)
    T[:3, :3] = R.T
    T[:3, 3] = -R.T @ C
    return T.astype(np.float32)


def drifted_loop_map(MapStore, FrameData, cfg):
    """A MapStore (either package's, built by its MapStore and FrameData
    classes and SlamConfig `cfg`) of the LOOP_MAP drive, in the manner of
    tests/test_loop_closing.py::build_drifted_loop: each keyframe's pose
    carries the odometry drift accumulated so far (a yaw bias of yaw_bias
    rad a keyframe, as odometry drifts, on a random walk of rot_drift rad
    and trans_drift m a keyframe), and each keyframe creates
    its own map points from its drifted pose (new_points seen in the image
    at `depth` m; stereo, ur = u - bf / z) and re-observes shared_points of
    the previous keyframe's through the drifted map, as odometry would. The
    revisiting keyframes see the first segments' true points from their
    true poses, with descriptors a few bits off (desc_flips), and create
    duplicates of them: nothing links the two ends until a loop is closed.
    Every keyframe has n_features keypoints, the rest with random
    descriptors and no map point. Returns (map, true poses, drifted poses)
    as (K, 4, 4) world -> camera arrays."""
    s = LOOP_MAP
    c = s["cam"]
    fx, fy, cx, cy, bf = c["fx"], c["fy"], c["cx"], c["cy"], c["bf"]
    W, H = c["width"], c["height"]
    rng = np.random.default_rng(s["seed"])
    n_lap, n_rev = s["lap_kfs"], s["revisit_kfs"]

    def true_pose(k):
        lap = k >= n_lap
        a = 2 * np.pi * (k - n_lap if lap else k) / n_lap
        z = np.array([np.cos(a), 0.0, np.sin(a)])          # along the circle
        x = np.array([np.sin(a), 0.0, -np.cos(a)])
        C = s["radius"] * np.array([np.sin(a), 0.0, 1.0 - np.cos(a)])
        R = np.stack([x, [0.0, 1.0, 0.0], z], 1)
        if lap:
            C = C + s["lane_m"] * x
            R = R @ _rotation(np.array([0.0, np.radians(s["yaw_deg"]), 0.0]))
        return _pose(R, C)

    gt = np.stack([true_pose(k) for k in range(n_lap + n_rev)])
    est = [gt[0]]
    for k in range(1, len(gt)):
        rel = gt[k].astype(np.float64) @ np.linalg.inv(gt[k - 1].astype(np.float64))
        noise = np.eye(4)
        noise[:3, :3] = _rotation(rng.normal(0, s["rot_drift"], 3) + [0.0, s["yaw_bias"], 0.0])
        noise[:3, 3] = rng.normal(0, s["trans_drift"], 3)
        est.append((noise @ rel @ est[-1]).astype(np.float32))
    est = np.stack(est)

    def project(pc):
        return np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], -1)

    def in_image(uv, pc):
        return ((pc[:, 2] > 0.5) & (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0)
                & (uv[:, 1] < H))

    def flip(desc):
        out = desc.copy()
        for row in out:
            for b in rng.choice(256, s["desc_flips"], replace=False):
                row[b // 32] ^= np.uint32(1 << (b % 32))
        return out

    cap = cfg.orb.max_keypoints
    ms = MapStore(cfg)
    seg_true, seg_desc, prev_ids = [], [], None
    for k in range(len(gt)):
        Twc_gt = np.linalg.inv(gt[k].astype(np.float64))
        Twc_est = np.linalg.inv(est[k].astype(np.float64))
        if k < n_lap:     # new points in view: a pixel and a depth
            uv = rng.uniform([0, 0], [W, H], (s["new_points"], 2))
            z = rng.uniform(*s["depth"], s["new_points"])
            pc = np.stack([(uv[:, 0] - cx) / fx * z, (uv[:, 1] - cy) / fy * z, z], -1)
            desc = rng.integers(0, 2 ** 32, (s["new_points"], 8), dtype=np.uint32)
            seg_true.append(pc @ Twc_gt[:3, :3].T + Twc_gt[:3, 3])
            seg_desc.append(desc)
            kp_desc = desc
        else:             # the revisit: segment k - n_lap's true points
            pw = seg_true[k - n_lap]
            pc = pw @ gt[k, :3, :3].T.astype(np.float64) + gt[k, :3, 3]
            vis = in_image(project(pc), pc)
            pc, kp_desc = pc[vis], flip(seg_desc[k - n_lap][vis])
        n_new = len(pc)
        xy = np.zeros((cap, 2), np.float32)
        desc_all = rng.integers(0, 2 ** 32, (cap, 8), dtype=np.uint32)
        ur = np.full(cap, -1.0, np.float32)
        depth = np.full(cap, -1.0, np.float32)
        valid = np.zeros(cap, bool)
        valid[:s["n_features"]] = True
        xy[:s["n_features"]] = rng.uniform([0, 0], [W, H], (s["n_features"], 2))
        xy[:n_new] = project(pc) + rng.normal(0, s["pixel_noise"], (n_new, 2))
        ur[:n_new] = xy[:n_new, 0] - bf / pc[:, 2]
        depth[:n_new] = pc[:, 2]
        desc_all[:n_new] = kp_desc
        # the previous keyframe's points seen again, through the drifted map
        shared, shared_slots = np.empty(0, np.int64), np.empty(0, np.int64)
        if prev_ids is not None:
            pcs = ms.mp_pos[prev_ids].astype(np.float64) @ est[k, :3, :3].T + est[k, :3, 3]
            ok = np.nonzero(in_image(project(pcs), pcs))[0][:s["shared_points"]]
            shared = prev_ids[ok]
            shared_slots = n_new + np.arange(ok.size)
            xy[shared_slots] = project(pcs[ok]) + rng.normal(0, s["pixel_noise"], (ok.size, 2))
            ur[shared_slots] = xy[shared_slots, 0] - bf / pcs[ok, 2]
            depth[shared_slots] = pcs[ok, 2]
            desc_all[shared_slots] = flip(ms.mp_desc[shared])
        frame = FrameData(
            frame_id=k, timestamp=0.1 * k, xy=xy, response=np.ones(cap, np.float32),
            octave=np.zeros(cap, np.int32), angle=np.zeros(cap, np.float32),
            desc=np.where(valid[:, None], desc_all, 0).astype(np.uint32), valid=valid,
            ur=np.where(valid, ur, -1.0).astype(np.float32),
            depth=np.where(valid, depth, -1.0).astype(np.float32), Tcw=est[k].copy())
        kf = ms.add_keyframe(frame)
        ids = ms.add_map_points_batch((pc @ Twc_est[:3, :3].T + Twc_est[:3, 3]).astype(np.float32),
                                      kf, np.arange(n_new))
        if shared.size:
            ms.add_observations_batch(shared, kf, shared_slots)
        ms.update_point_descriptors(np.concatenate([ids, shared]))
        ms.update_normal_and_depth(np.concatenate([ids, shared]))
        ms.update_connections(kf)
        prev_ids = ids
    return ms, gt, est


def loop_map_errors(ms, gt, n_lap):
    """Camera-centre errors (m) of the live keyframes against the truth:
    (the lap's end keyframe n_lap - 1, the mean)."""
    kfs = ms.keyframe_ids()
    err = np.linalg.norm(np.stack([np.linalg.inv(ms.kf_Tcw[k].astype(np.float64))[:3, 3]
                                   - np.linalg.inv(gt[k].astype(np.float64))[:3, 3]
                                   for k in kfs]), axis=1)
    return float(err[list(kfs).index(n_lap - 1)]), float(err.mean())


def drive_loop_map(lc, sync=lambda: None):
    """Feed every keyframe of the map to a LoopCloser (either package's)
    through on_new_keyframe alone. Returns the loops closed as (keyframe,
    loop keyframe, S_cl) and the host ms of each call."""
    correct, closed, call_ms = lc._correct_loop, [], []

    def recorded(kf, loop_kf, S_cl, loop_points):
        closed.append((int(kf), int(loop_kf), np.array(S_cl, np.float64)))
        return correct(kf, loop_kf, S_cl, loop_points)

    lc._correct_loop = recorded
    for k in lc.map.keyframe_ids():
        t0 = time.perf_counter()
        lc.on_new_keyframe(int(k))
        sync()
        call_ms.append(1e3 * (time.perf_counter() - t0))
    lc._correct_loop = correct
    return closed, call_ms


# ---- [19] the asynchronous pipeline ---------------------------------------------
# (a) [10]'s stereo phase through System(async_mapping=True), drained after
# each frame; (b) tools/bench_e2e.py's loop at full KITTI width, async
# (E2E_MODES): E2E_FRAMES frames, one lap and the revisit that closes it.
# Cut for time in two ways: the sync lap is gone ([17] and [22] drive the
# synchronous System through a loop; `python3 tools/bench_e2e.py` runs it),
# and the lap is 180 frames, 2.26 deg a frame (the tool's default 265 frames
# turn examples/bench_e2e.py's 1.53 deg), with a 21-frame revisit. Async must
# track what the two laps' checks let it at least (sync E2E_TRACKED_SHARE of
# the frames, async that less E2E_ASYNC_SLACK, 5% of the frames), close a
# loop and keep the exported ATE under E2E_ATE_SHARE of the travel (the JAX
# package's async lap gate, tests/test_loop_sequence.py:177).
# No JAX anchor: past 128 stored keyframes the JAX keyframe store corrupts
# fuse and triangulation (ROADMAP.md C.1).
E2E_FRAMES, E2E_LAPS, E2E_OVERLAP = 180, 1.0, 21
E2E_MODES = ("async",)
E2E_TRACKED_SHARE = 0.98
E2E_ASYNC_SLACK = 9
E2E_ATE_SHARE = 0.02
ASYNC_WAIT_S = 300.0     # the longest wait for the mapping worker or a global BA
E2E_RENDER_WORKERS = 8   # spawned processes that render (b)'s frames (the same images)


# ---- [20] the dataset drivers on files ---------------------------------------------
# Each sequence is written in its dataset's own layout with the port's PNG
# writer (io/png.py), decoded back (asserted equal), then run through the
# port's examples/run_slam.py with System at the settings file's defaults
# (loop closing on): (a) kitti-stereo, [10]'s frames rounded to uint8, at
# configs/KITTI00-02.yaml; (b) kitti-mono, [15]'s, at configs/KITTI04-12.yaml;
# (c) tum-rgbd at configs/TUM1.yaml: [11]'s path shape and world at a hand-held
# RGB-D camera's range (TUM_WORLD: planes 1.6-2.8 m away, 2 cm a frame, 0.6
# m/s at 30 fps), rendered through TUM1's lens distortion (the YAML's k1..k3,
# p1, p2; run_slam undistorts the keypoints with them), the images as 8-bit
# RGB (channel offsets TUM_RGB_OFFSET, so the RGB-to-grey conversion has work
# to do), the depth as 16-bit PNGs x5000 stamped TUM_DEPTH_LAG_S after the
# colour frames, and groundtruth.txt stamped TUM_GT_LAG_S after them (both
# within the 20 ms of the association). [11]'s own world, 6-10 m away, lies
# beyond TUM1's close-depth threshold (ThDepth 40 x 7.7 cm = 3.1 m): every
# frame became a keyframe and the driver's ATE moved by up to 11 mm under
# +-1e-3 grey levels of noise (PERF.md section 6).
DATASET_SEQS = {"kitti-stereo": ("KITTI00-02.yaml", "stereo"),
                "kitti-mono": ("KITTI04-12.yaml", "mono_kitti"),
                "tum-rgbd": ("TUM1.yaml", "tum1")}
TUM_T0 = 1305031102.0
TUM_DEPTH_LAG_S, TUM_GT_LAG_S = 0.004, 0.002
TUM_RGB_OFFSET = (6, 0, -15)
TUM1_DIST = (0.262383, -0.953104, -0.005358, 0.002628, 1.163314)   # k1 k2 p1 p2 k3
TUM_WORLD = dict(z_near=1.6, z_far=2.8, tex_scale=128.0, step=0.02)
PNG_LEVEL = 1      # zlib level of the written sequences (speed; any level decodes alike)
PNG_THREADS = 8    # threads that write the sequences' PNGs and decode them back
# The JAX package's own examples/run_slam.py on the byte-identical files
# (System at the settings' defaults, loop closing on), run on the CPU in the
# modes of JAX_CPU_TRACKER, jax 0.9.0, by `JAX_PLATFORMS=cpu python
# tests/torch_parity.py run_slam` (jax_run_slam_anchor; 4-8 min a sequence):
# frames tracked (not lost in the tracker's log), live keyframes and map
# points, frames exported, the driver's ground-truth ATE (rounded to 0.1 mm
# by evaluate_against_gt). Limits ([10]-[12]'s System limits): tracked and
# exported exact, keyframes within SYS_KF_TOL, map points within
# SYS_MP_RTOL, ATE within ATE_RTOL of the anchor or ATE_ATOL_M, whichever is
# larger. Monocular mapping here is chaotic, so kitti-mono's map points and
# ATE are held instead to the interval that the JAX package's own runs cover
# (RUN_SLAM_MONO_RUNS: the anchor and the same run with +-1e-3 grey levels of
# noise on every loaded image, seeds 1-10; `tests/torch_parity.py run_slam
# kitti-mono noise1 ... noise10`), from its least to its largest value,
# widened by SYS_MP_RTOL and by ATE_RTOL or ATE_ATOL_M as above
# (run_slam_misses): 409-1,441 points, 15.6-96.1 mm (seeds 1-4 alone:
# 468-1,441 points, 18.6-96.1 mm). Those runs track 26 frames each time
# with 4-5 keyframes. The JAX tum-rgbd run under
# noise1 and noise2 keeps 8 keyframes, 760 and 803 points, 2.9 and 2.7 mm.
JAX_CPU_RUN_SLAM = {
    "kitti-stereo": dict(tracked=30, keyframes=7, map_points=1381, exported=30, ate_m=0.0089),
    "kitti-mono": dict(tracked=26, keyframes=5, map_points=493, exported=26, ate_m=0.0850),
    "tum-rgbd": dict(tracked=30, keyframes=8, map_points=764, exported=30, ate_m=0.0031),
}
#                   the anchor, then noise1, noise2, ..., noise10
RUN_SLAM_MONO_RUNS = dict(map_points=(493, 1372, 1244, 1210, 828, 1276, 1276, 953, 431, 1280,
                                      1246),
                          ate_m=(0.0850, 0.0207, 0.0874, 0.0282, 0.0329, 0.0176, 0.0227, 0.0547,
                                 0.0733, 0.0373, 0.0465))
VOC_STRIDE = 3     # (d): train_vocabulary on every third left image of (a)


def run_slam_misses(name, res, ref):
    """The anchors of JAX_CPU_RUN_SLAM that a run_slam summary misses, as
    text; none if it meets them all."""
    if res["gt"] is None:
        return [f"no ground-truth evaluation ({res['exported']} frames exported)"]
    got = dict(res, ate_m=res["gt"]["ate_rmse_m"])
    out = [f"{k} {got[k]} (JAX {ref[k]})" for k in ("tracked", "exported") if got[k] != ref[k]]
    if abs(got["keyframes"] - ref["keyframes"]) > SYS_KF_TOL:
        out.append(f"keyframes {got['keyframes']} (JAX {ref['keyframes']})")
    # the anchor alone, or for kitti-mono every JAX run: from the least to
    # the largest, widened by System's limits
    runs = (RUN_SLAM_MONO_RUNS if name == "kitti-mono"
            else {k: (ref[k],) for k in ("map_points", "ate_m")})
    lo, hi = min(runs["map_points"]), max(runs["map_points"])
    mp_lo, mp_hi = lo * (1 - SYS_MP_RTOL), hi * (1 + SYS_MP_RTOL)
    lo, hi = min(runs["ate_m"]), max(runs["ate_m"])
    ate_lo, ate_hi = lo - max(ATE_RTOL * lo, ATE_ATOL_M), hi + max(ATE_RTOL * hi, ATE_ATOL_M)
    if not mp_lo <= got["map_points"] <= mp_hi:
        out.append(f"map points {got['map_points']} (JAX {ref['map_points']}, limits "
                   f"{mp_lo:.1f}-{mp_hi:.1f})")
    if not ate_lo <= got["ate_m"] <= ate_hi:
        out.append(f"ATE {got['ate_m']} m (JAX {ref['ate_m']} m, limits {ate_lo:.5f}-"
                   f"{ate_hi:.5f} m)")
    return out


def distorted_rays(cam, dist):
    """(H, W, 3) float32 camera-frame directions (x, y, 1) of the pixels of
    a camera with radial-tangential distortion (k1, k2, p1, p2, k3): the
    fixed-point undistortion of cv::undistortPoints, to convergence."""
    k1, k2, p1, p2, k3 = dist
    us, vs = np.meshgrid(np.arange(cam["width"], dtype=np.float64),
                         np.arange(cam["height"], dtype=np.float64))
    xd, yd = (us - cam["cx"]) / cam["fx"], (vs - cam["cy"]) / cam["fy"]
    x, y = xd, yd
    for _ in range(100):
        r2 = x * x + y * y
        icd = 1.0 / (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x, y = (xd - dx) * icd, (yd - dy) * icd
    return np.stack([x, y, np.ones_like(x)], -1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def render_tum1():
    """(poses, frames: (image, depth) per frame) of TUM_WORLD seen through
    configs/TUM1.yaml's lens: each pixel's ray undistorted (distorted_rays),
    the texture sampled where it hits and the depth its camera z;
    +-SEQ_NOISE grey levels of seeded noise as render_sequence."""
    c, w = TRACK_SEQS["rgbd"]["cam"], TUM_WORLD
    from orb_slam2_detailed_comments_tpu_torch.examples._driver import load_synthetic_world
    world = load_synthetic_world().PlanesWorld(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"],
                                           width=c["width"], height=c["height"],
                                           tex_scale=w["tex_scale"], z_near=w["z_near"],
                                           z_far=w["z_far"])
    rays = distorted_rays(c, TUM1_DIST)
    poses = smooth_trajectory(SEQ_FRAMES, step=w["step"])
    _check_on_texture(world, poses, rays)
    rng = np.random.default_rng(0)
    frames = []
    for T in poses:
        R, t = T[:3, :3], T[:3, 3]
        p, lam, _ = world._intersect(-R.T @ t, rays @ R)
        img = np.where(lam > 0, world._sample_texture(p[..., 0], p[..., 1], p[..., 2]), 0.0)
        img = np.clip(img + rng.uniform(-SEQ_NOISE, SEQ_NOISE, img.shape), 0, 255)
        frames.append((img.astype(np.float32), np.maximum(lam, 0.0).astype(np.float32)))
    return poses, frames


def _quat_xyzw(R):
    """Unit quaternion (x, y, z, w) of a rotation matrix (float64)."""
    w = math.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    x = math.copysign(math.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2])) / 2, R[2, 1] - R[1, 2])
    y = math.copysign(math.sqrt(max(0.0, 1.0 - R[0, 0] + R[1, 1] - R[2, 2])) / 2, R[0, 2] - R[2, 0])
    z = math.copysign(math.sqrt(max(0.0, 1.0 - R[0, 0] - R[1, 1] + R[2, 2])) / 2, R[1, 0] - R[0, 1])
    return x, y, z, w


def write_dataset(name, root):
    """Write the DATASET_SEQS sequence `name` under `root` in its dataset's
    layout. Returns (settings path, sequence directory, the images written
    as [(path, array)]); the arrays are what a decoder must give back."""
    from orb_slam2_detailed_comments_tpu_torch.io.png import write_png
    from concurrent.futures import ThreadPoolExecutor
    yaml_name, render = DATASET_SEQS[name]
    seq = Path(root) / name
    poses, frames = render_tum1() if render == "tum1" else render_sequence(render)
    written = []

    def png(path, arr):
        path.parent.mkdir(parents=True, exist_ok=True)
        written.append((str(path), arr))

    def u8(img):
        return np.clip(np.rint(img), 0, 255).astype(np.uint8)

    twc = [np.linalg.inv(T.astype(np.float64)) for T in poses]
    if name.startswith("kitti"):
        fps = 10.0
        for i, f in enumerate(frames):
            for cam_dir, img in zip(("image_0", "image_1"), f):
                png(seq / cam_dir / f"{i:06d}.png", u8(img))
        (seq / "times.txt").write_text("".join(f"{i / fps:.6e}\n" for i in range(len(frames))))
        (seq / "poses.txt").write_text("".join(
            " ".join(f"{v:.9e}" for v in T[:3, :4].reshape(-1)) + "\n" for T in twc))
    else:
        fps = 30.0
        stamps = [TUM_T0 + i / fps for i in range(len(frames))]
        rgb_lines, depth_lines = [], []
        for ts, (img, depth) in zip(stamps, frames):
            g = np.rint(img)[..., None] + np.asarray(TUM_RGB_OFFSET, np.float64)
            png(seq / "rgb" / f"{ts:.6f}.png", np.clip(g, 0, 255).astype(np.uint8))
            td = ts + TUM_DEPTH_LAG_S
            png(seq / "depth" / f"{td:.6f}.png",
                np.clip(np.rint(depth * 5000.0), 0, 65535).astype(np.uint16))
            rgb_lines.append(f"{ts:.6f} rgb/{ts:.6f}.png\n")
            depth_lines.append(f"{td:.6f} depth/{td:.6f}.png\n")
        head = "# written by chip_smoke.py\n# timestamp filename\n"
        (seq / "rgb.txt").write_text(head + "".join(rgb_lines))
        (seq / "depth.txt").write_text(head + "".join(depth_lines))
        (seq / "groundtruth.txt").write_text("# timestamp tx ty tz qx qy qz qw\n" + "".join(
            f"{ts + TUM_GT_LAG_S:.6f} " + " ".join(f"{v:.7f}" for v in T[:3, 3])
            + " " + " ".join(f"{v:.7f}" for v in _quat_xyzw(T[:3, :3])) + "\n"
            for ts, T in zip(stamps, twc)))
    # zlib releases the interpreter lock: the files are compressed in threads
    with ThreadPoolExecutor(PNG_THREADS) as pool:
        list(pool.map(lambda job: write_png(*job, level=PNG_LEVEL), written))
    return str(REPO / "configs" / yaml_name), str(seq), written


def drive_datasets(device, zero_counts, check_path, path_launches):
    """[20]: write each DATASET_SEQS sequence, decode it back, run the port's
    run_slam on it and hold the result to JAX_CPU_RUN_SLAM; then (d)
    train_vocabulary and (e) the frame drawer. zero_counts, check_path and
    path_launches are main's launch bookkeeping; `device` is run_slam's."""
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from orb_slam2_detailed_comments_tpu_torch.examples import _driver, run_slam, train_vocabulary
    from orb_slam2_detailed_comments_tpu_torch.frontend.tracking import Sensor
    from orb_slam2_detailed_comments_tpu_torch.io.png import read_png, row_filters, write_png
    from orb_slam2_detailed_comments_tpu_torch.viz.drawers import FrameDrawer
    drivers = {}
    with tempfile.TemporaryDirectory() as root:
        for tag, name in (("20a", "kitti-stereo"), ("20b", "kitti-mono"), ("20c", "tum-rgbd")):
            t0 = time.perf_counter()
            settings, seq, written = write_dataset(name, root)
            s_write = time.perf_counter() - t0
            # the writer picks each row's filter as libpng does: the files carry
            # Average and Paeth rows, which decode serially, as real ones do
            filters = sum(row_filters(p) for p, _ in written)
            if not (filters[3] and filters[4]):
                raise AssertionError(f"[{tag}] no Average or Paeth rows written: {filters}")
            with ThreadPoolExecutor(PNG_THREADS) as pool:
                decoded = list(pool.map(lambda job: read_png(job[0]), written))
            differ = [p for (p, a), b in zip(written, decoded) if not np.array_equal(a, b)]
            if differ:
                raise AssertionError(f"[{tag}] {len(differ)} images decode unlike written: "
                                     f"{differ[:3]}")
            # timed after the decoding above, which built io/png.py's C library
            ds = run_slam.open_dataset(name, settings, seq)[0]
            t0 = time.perf_counter()
            for i in range(4):
                ds[i]               # the loading cost of one frame: decode, grey, float
            ms_load = 1e3 * (time.perf_counter() - t0) / 4
            n_frames = len(render_tum1()[1] if name == "tum-rgbd"
                           else render_sequence(DATASET_SEQS[name][1])[1])
            zero_counts()
            out = os.path.join(root, name + "_out")
            viz = ["--viz", os.path.join(root, "viz")] if name == "kitti-stereo" else []
            res = run_slam.run([name, settings, seq, out, "--device", device] + viz)
            n = check_path(f"[{tag}] run_slam {name}", n_frames, stereo=name == "kitti-stereo")
            for k in ("fast_pyramid", "orb_desc", "stereo_sad"):
                path_launches[k] += n[k]
            rows = {}
            for part, cols in (("tum", 8), ("kitti", 12), ("kf_tum", 8)):
                lines = Path(f"{out}_{part}.txt").read_text().splitlines()
                vals = np.asarray([ln.split() for ln in lines], np.float64)
                if vals.shape[1:] != (cols,) or not np.isfinite(vals).all():
                    raise AssertionError(f"[{tag}] {out}_{part}.txt does not parse")
                rows[part] = len(lines)
            ms = sorted(1e3 * t for t in res["times_s"])
            ref = JAX_CPU_RUN_SLAM[name]
            gt = res["gt"] or dict(ate_rmse_m=math.nan, rpe_trans_rmse_m=math.nan, n_pairs=0)
            print(f"[{tag}] run_slam {name} ({DATASET_SEQS[name][0]}, {n_frames} frames, "
                  f"{len(written)} PNGs written in {s_write:.2f} s, their rows filtered None, "
                  f"Sub, Up, Average, Paeth {filters.tolist()}, decoded equal to what was "
                  f"written; {ms_load:.3f} ms to load a frame, "
                  f"{100 * ms_load / ms[len(ms) // 2]:.2f}% of the median frame): tracked "
                  f"{res['tracked']} (JAX {ref['tracked']}), keyframes {res['keyframes']} "
                  f"(JAX {ref['keyframes']}), map points {res['map_points']} (JAX "
                  f"{ref['map_points']}), exported {res['exported']} (JAX {ref['exported']}), "
                  f"ground-truth ATE {1e3 * gt['ate_rmse_m']:.1f} mm over {gt['n_pairs']} pairs "
                  f"(JAX {1e3 * ref['ate_m']:.1f} mm), RPE {1e3 * gt['rpe_trans_rmse_m']:.1f} mm; "
                  f"trajectory rows (tum, kitti, kf_tum) {tuple(rows.values())}; ms a frame "
                  f"median {ms[len(ms) // 2]:.3f}, mean {statistics.mean(ms):.3f}", flush=True)
            trk = res["slam"].tracker
            print(f"[{tag}] {trk.fused_frames} of {res['frames']} frames on the fused path; "
                  f"tracker stages, median ms (count): " + ", ".join(
                      f"{k} {v['median_ms']:.3f} ({v['count']})"
                      for k, v in sorted(trk.timer.summary().items())), flush=True)
            misses = run_slam_misses(name, res, ref)
            if viz:
                # --viz: the frame and the map drawn in numpy, no plotting library
                shapes = [read_png(os.path.join(viz[1], f)).shape for f in ("frame.png", "map.png")]
                status = json.loads(Path(viz[1], "status.json").read_text())
                print(f"[{tag}] --viz wrote frame.png {shapes[0]}, map.png {shapes[1]}, "
                      f"status {status}; matplotlib imported: {'matplotlib' in sys.modules}",
                      flush=True)
                if status["keyframes"] != res["keyframes"] or "matplotlib" in sys.modules:
                    misses.append(f"--viz status {status}")
            if rows["tum"] != res["exported"] or rows["kitti"] != res["exported"] \
                    or rows["kf_tum"] != res["keyframes"]:
                misses.append(f"trajectory rows {rows}")
            if misses:
                raise AssertionError(f"[{tag}] run_slam {name}: " + "; ".join(misses))
            drivers[name] = (seq, res)

        # (d) train_vocabulary on (a)'s left images, the DBoW2 text loaded
        # back through the drivers' System route
        seq_a, res_a = drivers["kitti-stereo"]
        voc_path = os.path.join(root, "voc.txt")
        n_imgs = len(range(0, res_a["frames"], VOC_STRIDE))
        zero_counts()
        t0 = time.perf_counter()
        voc, descs = train_vocabulary.run(["kitti-mono", seq_a, voc_path, "--stride",
                                           str(VOC_STRIDE), "--features", "2000",
                                           "--device", device])
        s_train = time.perf_counter() - t0
        n = check_path("[20d] train_vocabulary", n_imgs, stereo=False)
        for k in ("fast_pyramid", "orb_desc"):
            path_launches[k] += n[k]
        loaded = _driver.make_system(voc_path, str(REPO / "configs" / "KITTI00-02.yaml"),
                                     Sensor.STEREO, device=device).voc
        words_equal, bag_err, bags = True, 0.0, []
        for d in descs:
            valid = np.ones(len(d), bool)
            (w0, b0), (w1, b1) = voc.transform(d, valid), loaded.transform(d, valid)
            words_equal &= bool(np.array_equal(w0, w1))
            bag_err = max(bag_err, float(np.abs(b0 - b1).max()))
            bags.append(b1)
        self_first = [int(np.argmax([loaded.score(b, o) for o in bags])) == i
                      for i, b in enumerate(bags)]
        print(f"[20d] train_vocabulary (kitti-mono, stride {VOC_STRIDE}): {n_imgs} images, "
              f"{sum(len(d) for d in descs)} descriptors, a k={loaded.k}, L={loaded.L} tree of "
              f"{loaded.n_words} words in {s_train:.2f} s; loaded back from DBoW2 text through "
              f"make_system: words equal {words_equal}, largest bag difference {bag_err:.2e} "
              f"(the text keeps 6 decimals of each weight), each image first against itself "
              f"{all(self_first)}", flush=True)
        if not (words_equal and bag_err <= 1e-5 and all(self_first)
                and loaded.n_words == voc.n_words):
            raise AssertionError(f"[20d] vocabulary round trip: words {words_equal}, bag "
                                 f"{bag_err}, self-retrieval {self_first}")

        # (e) the viewer's matplotlib-free half on (a)'s last frame
        slam_a = res_a["slam"]
        img = read_png(os.path.join(seq_a, "image_0", f"{res_a['frames'] - 1:06d}.png"))
        text = FrameDrawer.status_text(slam_a)
        rgb = FrameDrawer(slam_a.config).draw(img.astype(np.float32), slam_a.tracker.last_frame,
                                              state_text=text)
        frame_png = os.path.join(root, "frame.png")
        write_png(frame_png, rgb)
        same = bool(np.array_equal(read_png(frame_png), rgb))
        n_marked = int((rgb[:img.shape[0]] != img[..., None]).any(-1).sum())
        print(f"[20e] FrameDrawer on (a)'s last frame: {rgb.shape[1]}x{rgb.shape[0]}, "
              f"{n_marked} pixels marked, banner {text!r}; written and read back equal {same}",
              flush=True)
        if not same or not n_marked or "MATCHES" not in text:
            raise AssertionError(f"[20e] frame image: equal {same}, {n_marked} marked")


def drive_parallel(dev, zero_counts, read_counts, check_path, path_launches, count_syncs,
                   gba_ref=None, stereo_map=None):
    """[21]: the port's entry points and its sharded global BA on the card.
    (a) graft_entry.entry()'s fused mono frame against JAX_CPU_ENTRY; (b)
    dryrun_multichip(1) over NCCL; (c) in this process, a world of one rank
    over NCCL: examples/bench_gba.py's problem through
    distributed_global_ba_grouped, fused and through the handle polled by a
    check that never fires, each bit-identical to solve_grouped (gba_ref:
    [14](b)'s (cam_Tcw, points), else solved here), "dense" on
    `stereo_map` ([14](a)'s (prob, camera, inv_sigma2, flat solve)) against
    its flat solve and on DENSE_ROUTE's problem against solve_grouped; (d)
    examples/bench_scaling.py's rows (SCALING) over Gloo, every rank on
    this card. (c) launches no kernel (asserted)."""
    import tempfile
    import torch
    import torch.distributed as dist
    from orb_slam2_detailed_comments_tpu_torch.examples.bench_scaling import (
        CAM, INV_S2, build_problem, scaling_rows)
    from orb_slam2_detailed_comments_tpu_torch.geometry.camera import PinholeCamera
    from orb_slam2_detailed_comments_tpu_torch.graft_entry import dryrun_multichip, entry
    from orb_slam2_detailed_comments_tpu_torch.models.slam_step import unpack_host_blob
    from orb_slam2_detailed_comments_tpu_torch.optim import global_ba as GBA
    from orb_slam2_detailed_comments_tpu_torch.optim import global_ba_grouped as GBG
    from orb_slam2_detailed_comments_tpu_torch.parallel import multihost
    from orb_slam2_detailed_comments_tpu_torch.parallel.distributed_ba_grouped import (
        DistributedGroupedGBA, distributed_global_ba_grouped, make_grouped_mesh)

    def no_launch(name):
        n = {k: v for k, v in read_counts().items() if v}
        if n:
            raise AssertionError(f"{name} launched kernels {n}")

    # (a) entry(): one fused mono frame
    fn, args = entry(device=dev)
    zero_counts()
    (blob, desc), ms = _frame_ms(lambda: fn(*args))
    n = check_path("[21a] entry()", N_FRAMES, stereo=False)
    for k in ("fast_pyramid", "orb_desc"):
        path_launches[k] += n[k]
    b, ts, vis = (t.cpu().numpy() for t in unpack_host_blob(blob, desc.shape[0]))
    got = dict(keypoints=int(b[:, 7].sum()), matched=int(((b[:, 8] >= 0) & (b[:, 9] > 0)).sum()),
               n_in=int(ts[16]), n_in1=int(ts[20]), visible=int(vis.sum()))
    T_ref = np.asarray(JAX_CPU_ENTRY["Tcw"], np.float32)
    T = ts[:16].reshape(4, 4)
    d_t = float(np.linalg.norm(T[:3, 3] - T_ref[:3, 3]))
    cos = (np.trace(T[:3, :3].T @ T_ref[:3, :3]) - 1) / 2
    d_r = math.degrees(math.acos(min(1.0, max(-1.0, cos))))
    print(f"[21a] entry() fused_mono_frame 640x480: {ms:.3f} ms/frame (median of {N_FRAMES}); "
          f"{got} (JAX {dict((k, v) for k, v in JAX_CPU_ENTRY.items() if k != 'Tcw')}); pose "
          f"off JAX's by {1e3 * d_t:.3f} mm, {d_r:.5f} deg", flush=True)
    if any(got[k] != JAX_CPU_ENTRY[k] for k in got) or d_t > POSE_TOL_M or d_r > POSE_TOL_DEG:
        raise AssertionError(f"[21a] entry() differs from the JAX package's: {got}, "
                             f"{d_t} m, {d_r} deg")

    # (b) the dry run, one rank over NCCL
    zero_counts()
    t0 = time.perf_counter()
    deltas = dryrun_multichip(1, device=str(dev))
    print(f"[21b] dryrun_multichip(1) over NCCL: {time.perf_counter() - t0:.1f} s (a spawned "
          f"rank); largest camera and point distances from the single-device solve "
          f"{deltas} (limit 1e-2 each)", flush=True)

    # (c) a world of one over NCCL, in this process
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        multihost.initialize(f"file://{tmp}/store", 1, 0, device=dev)
        try:
            backend = dist.get_backend()
            prob = build_problem(**GBA_BENCH, device=dev)
            gcam = PinholeCamera(**CAM)
            inv_s2 = torch.from_numpy(INV_S2).to(dev)
            if gba_ref is None:
                gba_ref = GBG.solve_grouped(GBG.group_global_problem(prob), gcam, inv_s2,
                                            10, 50, 1e-5)[:2]
            mesh = make_grouped_mesh(dev)
            # "gemm", as "auto" takes it above DENSE_MAX_CAMS cameras
            fused = distributed_global_ba_grouped(prob, gcam, inv_s2, mesh, 10, 50,
                                                  backend="gemm")
            t0 = time.perf_counter()
            h = DistributedGroupedGBA(prob, gcam, inv_s2, mesh, cg_iters=50, backend="gemm")
            torch.cuda.synchronize()
            ms_prep = 1e3 * (time.perf_counter() - t0)
            polls = []

            def never():
                polls.append(1)
                return False

            run = functools.partial(h.solve, 10, never)
            out, n_sync = count_syncs(run)
            n_polls = len(polls)
            _, ms_solve = _frame_ms(run, n=3)
            torch.cuda.reset_peak_memory_stats()
            run()
            torch.cuda.synchronize()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            n_kernels, busy = _profile_frame(run)
            cam_params = (gcam.fx, gcam.fy, gcam.cx, gcam.cy, gcam.bf)
            cost = float(GBA._robust_cost(out[0], out[1], prob, prob.edge_valid, cam_params,
                                          inv_s2, True))
            same_fused = all(torch.equal(a, r) for a, r in zip(fused, gba_ref))
            same_handle = all(torch.equal(a, r) for a, r in zip(out, gba_ref))
            ref = JAX_CPU_GBA
            print(f"[21c] world of 1 rank over {backend!r}: bench_gba's problem "
                  f"({int(prob.edge_cam.shape[0])} edges) through distributed_global_ba_grouped "
                  f"({h.backend}, 10 LM x 50 CG): fused equal to solve_grouped {same_fused}; "
                  f"the handle polled {n_polls} times by a check that never fires, equal "
                  f"{same_handle}; {ms_solve:.3f} ms per solve (median of 3; [14](b)'s "
                  f"single-device solve_grouped on an H100 80GB HBM3 at 700 W: 1735.101 "
                  f"ms), {ms_prep:.3f} ms to shard and lay out, {n_kernels} CUDA kernels, device busy {_share(busy)}, "
                  f"{n_sync} host syncs, peak device memory {peak_gb:.3f} GB; robust cost "
                  f"{cost:.6g} (JAX on the CPU {ref['cost_after']:.6g}, "
                  f"{100 * (cost / ref['cost_after'] - 1):+.3f}%)", flush=True)
            if not (same_fused and same_handle) or n_sync or n_polls != 6:
                raise AssertionError(f"[21c] sharded world of one: equal {same_fused}, "
                                     f"{same_handle}; {n_sync} syncs, {n_polls} polls")
            if not (math.isfinite(cost) and abs(cost / ref["cost_after"] - 1) <= GBA_COST_RTOL):
                raise AssertionError(f"[21c] robust cost {cost}, JAX {ref['cost_after']}")
            del prob, fused, h, out, gba_ref
            if stereo_map is not None:
                sprob, scam, sinv, sflat = stereo_map
                dense = distributed_global_ba_grouped(sprob, scam, sinv, mesh, 10, 50,
                                                      backend="dense")
                d_cam, d_pt = _max_err(dense[0], sflat[0]), _max_err(dense[1], sflat[1])
                print(f"[21c] dense on [14](a)'s stereo map ({int(sprob.cam_Tcw.shape[0])} "
                      f"cameras, {int(sprob.edge_cam.shape[0])} edges) against its flat solve: "
                      f"cameras {d_cam:.3e}, points {d_pt:.3e} (limits {GBA_CAM_TOL}, "
                      f"{GBA_PT_TOL})", flush=True)
                if d_cam > GBA_CAM_TOL or d_pt > GBA_PT_TOL:
                    raise AssertionError("[21c] dense and flat global BA disagree")
            # "dense" where the route takes it, against the grouped PCG solve
            dprob = build_problem(**DENSE_ROUTE, device=dev)
            dref = GBG.solve_grouped(GBG.group_global_problem(dprob), gcam, inv_s2, 10, 50,
                                     1e-5)[:2]
            hd = DistributedGroupedGBA(dprob, gcam, inv_s2, mesh, cg_iters=50)
            run_d = functools.partial(hd.solve, 10)
            torch.cuda.synchronize()
            live_gb = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            dense, n_sync = count_syncs(run_d)
            torch.cuda.synchronize()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            _, ms_dense = _frame_ms(run_d, n=3)
            # the points the mapper would triangulate (DENSE_ROUTE's comment)
            par = max_parallax_deg(dprob, *dref)
            tri = par >= math.degrees(math.acos(TRIANGULATION_COS))
            d_cam, d_all = _max_err(dense[0], dref[0]), _max_err(dense[1], dref[1])
            d_pt = _max_err(dense[1][tri], dref[1][tri])
            d_low = float((dense[1] - dref[1]).abs().amax(1)[par >= 3.0].max())
            costs = [float(GBA._robust_cost(c, x, dprob, dprob.edge_valid, cam_params, inv_s2,
                                            True)) for c, x in (dense, dref)]
            print(f"[21c] {hd.backend} at the route's size: {DENSE_ROUTE['n_cams']} cameras, "
                  f"{DENSE_ROUTE['n_points']} points, {int(dprob.edge_cam.shape[0])} edges, 10 "
                  f"LM: {ms_dense:.3f} ms per solve (median of 3), {n_sync} host syncs, peak "
                  f"device memory {peak_gb:.3f} GB ({peak_gb - live_gb:.3f} GB above the "
                  f"{live_gb:.3f} GB live before it); against solve_grouped (10 LM x 50 CG): "
                  f"cameras {d_cam:.3e}, the {int(tri.sum())} points with rays at "
                  f"{math.degrees(math.acos(TRIANGULATION_COS)):.3f} deg or more {d_pt:.3e} "
                  f"(limits {GBA_CAM_TOL}, {GBA_PT_TOL}; at 3 deg or more {d_low:.3e}; all "
                  f"{DENSE_ROUTE['n_points']} points {d_all:.3e}), robust cost "
                  f"{costs[0]:.6g} against {costs[1]:.6g}", flush=True)
            if hd.backend != "dense" or n_sync or d_cam > GBA_CAM_TOL or d_pt > GBA_PT_TOL \
                    or not abs(costs[0] / costs[1] - 1) <= GBA_COST_RTOL:
                raise AssertionError(f"[21c] {hd.backend} at the route's size: {n_sync} syncs, "
                                     f"{d_cam}, {d_pt}, costs {costs}")
            del dprob, dref, hd, dense
        finally:
            dist.destroy_process_group()
    no_launch("[21c] the sharded global BA")

    # (d) the scaling driver, every rank on this card over Gloo
    t0 = time.perf_counter()
    rows, _ = scaling_rows(device=str(dev), backend="gloo", **SCALING)
    secs = time.perf_counter() - t0
    far = [r for r in rows if r["cam_delta"] > GBA_CAM_TOL or r["point_delta"] > GBA_PT_TOL
           or abs(r["cost_vs_first"]) > GBA_COST_RTOL]
    print(f"[21d] examples/bench_scaling.py over Gloo, all ranks on this one card (their times "
          f"measure no interconnect): {SCALING['cams']} cameras, {SCALING['points']} points, "
          f"{SCALING['cams'] * SCALING['obs_per_cam']} edges, {SCALING['iters']} LM x "
          f"{SCALING['cg']} CG, {SCALING['reps']} timed solve(s) a row, {secs:.1f} s; each "
          f"row against the first: cameras within {GBA_CAM_TOL}, points within {GBA_PT_TOL}, "
          f"robust cost within {100 * GBA_COST_RTOL:g}%; the last row is one rank on the "
          f"points in another order (what float order alone moves)", flush=True)
    for r in rows:
        print(f"[21d] {json.dumps(r)}", flush=True)
    if far:
        raise AssertionError(f"[21d] rows off the one-rank solve: {far}")


# ---- [22] the KITTI-class monocular circuit ----------------------------------------
# examples/kitti_class_benchmark.py's run() at KITTI_CLASS_MONO.json's
# configuration (the JAX package's committed row: 300 frames, 640x480, 1000
# features, a camera on a 12.5 m circle inside a textured cylinder of 25 m,
# two laps whose last 18 frames revisit the start; the row's 165.98 m of
# travel and lap scale 12.19 are this radius's: at 50 m the port travels
# 331.96 m at scale 23.94, PERF.md section 6): System(Sensor.MONOCULAR) with
# loop closing and the global BA after a loop on, the free-scale (Sim3) loop
# correction. The gates are the JAX package's own (tests/test_kitti_class.py):
# tracked share, a loop closed, the exported ATE under 1% of the travel, and
# the lap-to-lap scale drift under 1%. Mono's ATE is chaotic (ROADMAP.md C.8,
# C.22): the gates hold, not the JAX row's digits, which are printed beside.
KITTI_MONO = dict(n_frames=300, width=640, height=480, features=1000, radius=25.0, laps=2.0,
                  sensor="mono")
KITTI_MONO_ROW = "KITTI_CLASS_MONO.json"
KITTI_TRACKED_FRAC = 0.95
KITTI_ATE_PCT_TRAVEL = 1.0
KITTI_SCALE_DRIFT_PCT = 1.0
KITTI_RENDER_WORKERS = 8   # spawned processes that render [22]'s frames (the same images)


def kitti_mono_misses(res):
    """What [22]'s result misses of its gates (empty when it passes)."""
    misses = []
    if not res["tracked_frac"] > KITTI_TRACKED_FRAC:
        misses.append(f"tracked share {res['tracked_frac']}")
    if res["loops_closed"] < 1:
        misses.append("no loop closed")
    if not res["ate_pct_travel"] < KITTI_ATE_PCT_TRAVEL:
        misses.append(f"ATE {res['ate_pct_travel']}% of the travel")
    if not abs(res.get("scale_drift_pct", math.inf)) < KITTI_SCALE_DRIFT_PCT:
        misses.append(f"scale drift {res.get('scale_drift_pct')}% (lap scales "
                      f"{res.get('lap_scales')})")
    return misses


def drive_kitti_mono(device, zero_counts, check_path, path_launches):
    """[22]: the KITTI-class monocular circuit through the port's
    examples/kitti_class_benchmark.circuit, held to its gates; one
    fast_pyramid and one orb_desc launch a frame, no stereo_sad."""
    from orb_slam2_detailed_comments_tpu_torch.examples import kitti_class_benchmark as kcb
    row = json.loads((REPO / KITTI_MONO_ROW).read_text())
    zero_counts()
    res, slam, rec = kcb.circuit(**KITTI_MONO, progress=False, device=device,
                                 render_workers=KITTI_RENDER_WORKERS)
    n = check_path("[22] KITTI-class mono circuit", KITTI_MONO["n_frames"], stereo=False)
    for k in ("fast_pyramid", "orb_desc", "stereo_sad"):
        path_launches[k] += n[k]
    lc = slam.loop_closer
    print(f"[22] KITTI-class mono circuit ({res['resolution']}, {res['features']} features, "
          f"{res['frames']} frames, radius {KITTI_MONO['radius']} m, {KITTI_MONO['laps']} laps): "
          f"tracked share {res['tracked_frac']} (JAX row {row['tracked_frac']}), loops closed "
          f"{res['loops_closed']} (JAX row {row['loops_closed']}), exported ATE "
          f"{res['ate_rmse_m']} m = {res['ate_pct_travel']}% of {res['travel_m']} m (JAX row "
          f"{row['ate_rmse_m']} m = {row['ate_pct_travel']}%), live ATE {res['ate_live_m']} m, "
          f"keyframes {res['keyframes']} (JAX row {row['keyframes']}), map points "
          f"{res['map_points']} (JAX row {row['map_points']}), lap scales {res.get('lap_scales')}, "
          f"scale drift {res.get('scale_drift_pct')}% (JAX row {row['scale_drift_pct']}%), lost "
          f"streaks {res['lost_streaks']}, live keyframes at loops {res['kfs_live_at_loops']}; "
          f"ms a frame median {res['ms_per_frame']['median']}, p90 {res['ms_per_frame']['p90']}; "
          f"fused {res['fused_frames']}, staged {res['staged_frames']}; BoW "
          + json.dumps({k: v for k, v in res.items() if k.startswith("bow_")})
          + (f"; truncations {res['truncations']}" if "truncations" in res else ""), flush=True)
    for i, kf, stage_ms in rec["loop_frames"]:
        print(f"[22] loop-closing frame {i} (keyframe {kf}): {rec['frame_ms'][i]:.3f} ms; loop "
              f"closer stages ms: " + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items()),
              flush=True)
    print(f"[22] essential graph (backend, keyframes, edges) {lc.last_graph}; global BA "
          f"{slam.gba_runner.last_edges} edges; loop-closer stages, median ms (count): "
          + ", ".join(f"{k} {v['median_ms']:.3f} ({v['count']})"
                      for k, v in sorted(lc.timer.summary().items())), flush=True)
    misses = kitti_mono_misses(res)
    if misses:
        raise AssertionError("[22] " + "; ".join(misses) + f": {json.dumps(res)}")
    return res


def _load_tool(name):
    """A script of tools/ as a module (tools is not a package; on the path,
    the processes it spawns can import it too)."""
    import importlib
    if str(REPO / "tools") not in sys.path:
        sys.path.insert(0, str(REPO / "tools"))
    return importlib.import_module(name)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    from orb_slam2_detailed_comments_tpu_torch.frontend.tracking import Sensor, Tracker
    from orb_slam2_detailed_comments_tpu_torch.geometry.camera import PinholeCamera
    from orb_slam2_detailed_comments_tpu_torch.geometry.se3 import exp_se3, log_se3
    from orb_slam2_detailed_comments_tpu_torch.models import slam_step as S
    from orb_slam2_detailed_comments_tpu_torch.ops import _kernels
    from orb_slam2_detailed_comments_tpu_torch.ops.fast_pyramid import (
        fast_nms_survivors, fast_pyramid, fast_pyramid_plain, fast_score_nms,
        fast_score_nms_plain, fast_score_nms_raw, fast_score_nms_raw_plain)
    from orb_slam2_detailed_comments_tpu_torch.ops.hamming import hamming_distance_pairs
    from orb_slam2_detailed_comments_tpu_torch.ops.orb import (
        Keypoints, detect_keypoints, extract_orb_batch)
    from orb_slam2_detailed_comments_tpu_torch.ops.orb_desc import (
        DESC_RADIUS, orb_desc, orb_desc_plain)
    from orb_slam2_detailed_comments_tpu_torch.ops.patch_gather import (
        patch_gather, patch_gather_plain)
    from orb_slam2_detailed_comments_tpu_torch.ops.pyramid import build_pyramid, edge_pad
    from orb_slam2_detailed_comments_tpu_torch.ops.stereo import coarse_match
    from orb_slam2_detailed_comments_tpu_torch.ops.stereo_sad import stereo_sad, stereo_sad_plain
    from orb_slam2_detailed_comments_tpu_torch.backend import local_mapping as LM
    from orb_slam2_detailed_comments_tpu_torch.optim.local_ba import (
        BAProblem, local_bundle_adjustment)
    from orb_slam2_detailed_comments_tpu_torch.state.map_store import MapStore
    from orb_slam2_detailed_comments_tpu_torch.system import System
    from orb_slam2_detailed_comments_tpu_torch.utils.config import (
        OrbConfig, SlamConfig, load_settings_yaml)
    from orb_slam2_detailed_comments_tpu_torch.backend.local_mapping import solve_global_ba
    from orb_slam2_detailed_comments_tpu_torch.geometry.sim3 import log_sim3, sim3_inverse
    from orb_slam2_detailed_comments_tpu_torch.optim import global_ba as GBA
    from orb_slam2_detailed_comments_tpu_torch.optim import global_ba_grouped as GBG
    from orb_slam2_detailed_comments_tpu_torch.optim.global_ba import global_bundle_adjustment
    from orb_slam2_detailed_comments_tpu_torch.optim.pose_graph import (
        PoseGraphProblem, optimize_pose_graph, pose_graph_backend)
    from orb_slam2_detailed_comments_tpu_torch.optim.sim3_opt import optimize_sim3
    from orb_slam2_detailed_comments_tpu_torch.solvers.sim3_solver import solve_sim3_ransac
    from orb_slam2_detailed_comments_tpu_torch.backend import gba_runner as GR
    from orb_slam2_detailed_comments_tpu_torch.backend.gba_runner import GlobalBARunner
    from orb_slam2_detailed_comments_tpu_torch.backend.local_mapping import LocalMapper
    from orb_slam2_detailed_comments_tpu_torch.backend.loop_closing import LoopCloser
    from orb_slam2_detailed_comments_tpu_torch.place.kf_database import KeyFrameDatabase
    from orb_slam2_detailed_comments_tpu_torch.state.frame import FrameData
    from orb_slam2_detailed_comments_tpu_torch.system import load_default_vocabulary
    from orb_slam2_detailed_comments_tpu_torch.examples.bench_host import map_state, same_state

    t_start = time.perf_counter()

    def clock():
        print(f"    {time.perf_counter() - t_start:.1f} s into the run", flush=True)
    dev = torch.device("cuda", 0)
    print(_smi(), flush=True)     # the card's name and power limit
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    diag = _kernels.build()
    _kernels.library()
    print(f"[2] kernels built in {time.perf_counter() - t0:.2f} s -> {_kernels.library_path().name}",
          flush=True)
    for line in diag.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            print(f"    {line.strip()}")

    counters = {"fast_pyramid": fast_pyramid, "fast_score_nms_raw": fast_score_nms_raw,
                "fast_score_nms": fast_score_nms, "patch_gather": patch_gather,
                "orb_desc": orb_desc, "stereo_sad": stereo_sad}

    def zero_counts():
        for f in counters.values():
            f.launches = 0

    def read_counts():
        return {k: f.launches for k, f in counters.items()}

    # ---- [3] kernels against their plain versions at main-path shapes ----
    (img_l, img_r, *_), orb_s, cam_s = S.make_stereo_inputs(device=dev)
    (img_m, *_), orb_m, _ = S.make_consistent_inputs(device=dev)
    report = {k: {"max_abs_err": 0.0} for k in counters}

    def record(name, err, ms, plain_ms, n_bytes, n_ops, call):
        """Hold the kernel's error at 0, print its device time per launch
        (torch.profiler over TIMING_REPS calls) and bound at this shape; the
        first shape of each kernel is the reported one."""
        if err != 0.0:
            raise AssertionError(f"{name} differs from its plain version: {err}")
        r = report[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        bound_ms, bound_by = _bound(n_bytes, n_ops)
        dev_ms = _device_ms(call, KERNEL_SYMBOLS[name])
        print(f"    device {'not measured' if dev_ms is None else f'{dev_ms:.4f}'} ms per "
              f"launch; bound {bound_ms:.4f} ms ({bound_by}; {n_bytes / 1e6:.2f} MB, "
              f"{n_ops / 1e6:.1f} M operations)", flush=True)
        if "ms" not in r:
            r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=None)

    for tag, imgs, orb in (("stereo 2x8 lv 1241x376", torch.stack([img_l, img_r]), orb_s),
                           ("mono 1x8 lv 640x480", img_m[None], orb_m)):
        levels = [lv.contiguous() for lv in build_pyramid(imgs, orb.n_levels, orb.scale_factor)]
        th = float(orb.min_th_fast)
        got = fast_pyramid(levels, th)
        ref = fast_pyramid_plain(levels, th)
        torch.cuda.synchronize()
        err = max(_max_err(g, r) for g, r in zip(sum(got, []), sum(ref, [])))
        kern = functools.partial(fast_pyramid, levels, th)
        ms, plain_ms = _cuda_ms(kern), _cuda_ms(functools.partial(fast_pyramid_plain, levels, th))
        px = sum(lv.numel() for lv in levels)
        print(f"[3] fast_pyramid {tag}: max|kernel-plain| {err} (nms, raw, blur; full maps); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        record("fast_pyramid", err, ms, plain_ms, 16 * px,
               px * (FAST_SCORE_OPS + NMS_OPS + BLUR_OPS), kern)

        # orb_desc on this extraction's own keypoints and maps
        det = detect_keypoints(imgs, orb)
        args = (det.levels, det.blur, det.xy_level, det.valid, det.counts)
        (ga, gd), (ra, rd) = orb_desc(*args), orb_desc_plain(*args)
        torch.cuda.synchronize()
        n_ang = int((ga != ra).sum())
        n_desc = int((gd != rd).any(-1).sum())
        err = max(_max_err(ga, ra), float(hamming_distance_pairs(gd, rd).max()))
        kern = functools.partial(orb_desc, *args)
        ms, plain_ms = _cuda_ms(kern), _cuda_ms(functools.partial(orb_desc_plain, *args))
        print(f"[3] orb_desc {tag}: {ga.numel()} slots, {int(det.valid.sum())} valid, levels "
              f"{det.counts}: angles differing {n_ang}, descriptors differing {n_desc}, "
              f"max|kernel-plain| {err} (angle rad, or most bits of one descriptor); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        record("orb_desc", err, ms, plain_ms, *_orb_desc_work(det, ra), kern)

    # stereo_sad at the main path's slots: the keypoints and coarse matches
    # of the bench pair and of the first frame of the stereo tracker phase
    kw = slam_config_kwargs("stereo")
    trk_pair = torch.from_numpy(np.stack(render_sequence("stereo")[1][0])).to(dev)
    for tag, pair_lr, orb, cam in (
            ("bench pair 1241x376", torch.stack([img_l, img_r]), orb_s, cam_s),
            ("tracker frame 0 1241x376", trk_pair, OrbConfig(**kw["orb"]),
             PinholeCamera(**kw["camera"]))):
        kp = extract_orb_batch(pair_lr, orb)
        kl, kr = (Keypoints(*[a[i] for a in kp]) for i in (0, 1))
        m = coarse_match(kl, kr, cam, orb)
        args = (pair_lr[0], pair_lr[1], kl.xy[:, 0].contiguous(), kl.xy[:, 1].contiguous(),
                kr.xy[:, 0].contiguous(), m.idx)
        got, ref = stereo_sad(*args), stereo_sad_plain(*args)
        torch.cuda.synchronize()
        err = max(_max_err(a, b) for a, b in zip(got, ref))
        kern = functools.partial(stereo_sad, *args)
        ms, plain_ms = _cuda_ms(kern), _cuda_ms(functools.partial(stereo_sad_plain, *args))
        print(f"[3] stereo_sad {tag}: {m.idx.numel()} slots, {int(m.ok.sum())} matched: "
              f"max|kernel-plain| {err} (u_r, best_sad); kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms", flush=True)
        record("stereo_sad", err, ms, plain_ms, _stereo_sad_bytes(*args[:1], *args[2:]),
               m.idx.numel() * STEREO_SAD_OPS, kern)

    # K4 on the bench image; K5 on the bench image, the 640x480 one and a
    # textured frame (its early test rejects a share that depends on the
    # image: the bound counts the arc score only for the survivors)
    th = float(orb_s.min_th_fast)
    side_inputs = (("1241x376", img_l.contiguous()), ("640x480", img_m.contiguous()),
                   ("tracker frame 0 1241x376", trk_pair[0].contiguous()))
    for tag, img in side_inputs:
        n_surv = int(fast_nms_survivors(img, th).sum())
        area = (img.shape[0] + 2) * (img.shape[1] + 2)
        cases = [("fast_score_nms", functools.partial(fast_score_nms, img, th),
                  functools.partial(fast_score_nms_plain, img, th), 8 * img.numel(),
                  FAST_TEST_OPS * area + FAST_SCORE_OPS * n_surv + NMS_OPS * img.numel())]
        if tag == "1241x376":
            cases.insert(0, ("fast_score_nms_raw", functools.partial(fast_score_nms_raw, img, th),
                             functools.partial(fast_score_nms_raw_plain, img, th),
                             16 * img.numel(),
                             (FAST_SCORE_OPS + NMS_OPS + BLUR_OPS) * img.numel()))
        for name, kern, plain, n_bytes, n_ops in cases:
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
            err = max(_max_err(g, r) for g, r in zip(got, ref))
            ms, plain_ms = _cuda_ms(kern), _cuda_ms(plain)
            extra = (f"; early test rejects {100 * (1 - n_surv / area):.2f}% of the "
                     f"{area} pixels of the image + 1 px" if name == "fast_score_nms" else "")
            print(f"[3] {name} {tag}: max|kernel-plain| {err} (full maps); "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{extra}", flush=True)
            record(name, err, ms, plain_ms, n_bytes, n_ops, kern)

    g = torch.Generator(device="cpu").manual_seed(0)
    lv0 = torch.stack([img_l, img_l])  # [raw, blur]-shaped (2, H, W) stack
    padded = edge_pad(lv0, DESC_RADIUS, DESC_RADIUS).contiguous()
    H, W = img_l.shape
    xy = torch.stack([torch.randint(-8, W + 8, (2048,), generator=g),
                      torch.randint(-8, H + 8, (2048,), generator=g)], -1).to(torch.int32).to(dev)
    pad_lr = img_l.contiguous()[None]
    # patch_gather is on no path: its SAD template and strip are fused into
    # stereo_sad, its ORB windows into orb_desc; the three shapes stay
    # checked, the SAD template reported
    gathers = ((pad_lr, xy, 11, 11), (pad_lr, xy, 11, 21), (padded, xy, 39, 39))
    for tag, (src, coords, ph, pw) in zip(("sad template 2048x11x11", "sad strip 2048x11x21",
                                           "orb 2048x(2,39,39)"), gathers):
        got = patch_gather(src, coords, ph, pw)
        ref = patch_gather_plain(src, coords, ph, pw)
        torch.cuda.synchronize()
        err = _max_err(got, ref)
        kern = functools.partial(patch_gather, src, coords, ph, pw)
        ms = _cuda_ms(kern)
        plain_ms = _cuda_ms(functools.partial(patch_gather_plain, src, coords, ph, pw))
        print(f"[3] patch_gather {tag}: max|kernel-plain| {err}; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        record("patch_gather", err, ms, plain_ms, _gather_bytes(src, coords, ph, pw), 0, kern)

    # K4, K5 and patch_gather are on no path of the system: their drive is
    # one call of each public function per phase-[3] shape, and those calls'
    # outputs are the ones held against the plain versions
    drive = [("fast_score_nms_raw", fast_score_nms_raw, fast_score_nms_raw_plain,
              (img_l.contiguous(), th))]
    drive += [("fast_score_nms", fast_score_nms, fast_score_nms_plain, (img, th))
              for _, img in side_inputs]
    drive += [("patch_gather", patch_gather, patch_gather_plain, a) for a in gathers]
    zero_counts()
    outs = [fn(*a) for _, fn, _, a in drive]
    launches = read_counts()
    torch.cuda.synchronize()
    for (name, _, plain, a), got in zip(drive, outs):
        got, ref = (got, plain(*a)) if name == "fast_score_nms_raw" else ((got,), (plain(*a),))
        if max(_max_err(x, y) for x, y in zip(got, ref)) != 0.0:
            raise AssertionError(f"the driven {name} call differs from its plain version")
    print(f"[3] off-path drive launches {launches}", flush=True)
    want = {k: sum(1 for d in drive if d[0] == k) for k in OFF_PATH}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"the off-path drive launched {launches}, expected {want}")
    path_launches = {k: launches[k] for k in OFF_PATH}

    # ---- [4]/[5] the per-frame tracking program at full size ----
    clock()

    def check_inliers(name, n_in):
        ref = JAX_CPU_INLIERS[name]
        print(f"    {name}: n_inliers {n_in} (JAX on CPU {ref}, limit +-{INLIER_RTOL:.0%})")
        if abs(n_in - ref) > INLIER_RTOL * ref:
            raise AssertionError(f"{name}: {n_in} inliers, JAX reference {ref}")

    def check_pose(name, Tcw):
        Tcw = Tcw.detach().cpu().double()
        if not bool(torch.isfinite(Tcw).all()):
            raise AssertionError(f"{name}: non-finite pose")
        return Tcw

    def check_path(name, extractions, stereo):
        """The launch counts of the path just driven: one fast_pyramid and
        one orb_desc launch per extraction, one stereo_sad launch per stereo
        frame and none otherwise, and none of the off-path kernels."""
        n = read_counts()
        print(f"    {name} path launches {n}", flush=True)
        want = dict(fast_pyramid=extractions, orb_desc=extractions,
                    stereo_sad=extractions if stereo else 0, **dict.fromkeys(OFF_PATH, 0))
        if extractions == 0 or any(n[k] != v for k, v in want.items()):
            raise AssertionError(f"the {name} path launched {n}, expected {want}")
        return n

    s_args, orb_s, cam_s = S.make_stereo_inputs(device=dev)
    img_l, img_r, Tcw_s, *s_map = s_args
    s_pad = pad_map(*s_map)
    pair = torch.stack([img_l, img_r])
    th_depth = 40.0 * cam_s.baseline
    m_args, orb_m, cam_m = S.make_consistent_inputs(device=dev)
    img_m, Tcw_m, *m_map = m_args
    m_pad = pad_map(*m_map)

    ms = {}
    zero_counts()
    out, ms["stereo_tracking_step"] = _frame_ms(
        lambda: S.stereo_tracking_step(*s_args, orb=orb_s, cam=cam_s))
    check_pose("stereo_tracking_step", out[0])
    print(f"[4] stereo_tracking_step 1241x376: {ms['stereo_tracking_step']:.3f} ms/frame "
          f"(median of {N_FRAMES})")
    check_inliers("stereo_tracking_step", int(out[3]))
    check_path("stereo_tracking_step", N_FRAMES, stereo=True)
    zero_counts()
    (blob, _), ms["fused_stereo_frame"] = _frame_ms(lambda: S.fused_stereo_frame(
        pair, Tcw_s, *s_pad, orb=orb_s, cam=cam_s, th_depth=th_depth))
    ts = S.unpack_host_blob(blob, orb_s.max_keypoints)[1]
    check_pose("fused_stereo_frame", ts[:16].reshape(4, 4))
    print(f"[4] fused_stereo_frame 1241x376: {ms['fused_stereo_frame']:.3f} ms/frame "
          f"(median of {N_FRAMES})")
    check_inliers("fused_stereo_frame", int(ts[16]))
    check_path("fused_stereo_frame", N_FRAMES, stereo=True)

    zero_counts()
    out, ms["mono_tracking_step"] = _frame_ms(
        lambda: S.mono_tracking_step(*m_args, orb=orb_m, cam=cam_m))
    check_pose("mono_tracking_step", out[0])
    print(f"[5] mono_tracking_step 640x480: {ms['mono_tracking_step']:.3f} ms/frame "
          f"(median of {N_FRAMES})")
    check_inliers("mono_tracking_step", int(out[3]))
    check_path("mono_tracking_step", N_FRAMES, stereo=False)
    zero_counts()
    (blob, _), ms["fused_mono_frame"] = _frame_ms(lambda: S.fused_mono_frame(
        img_m, Tcw_m, *m_pad, orb=orb_m, cam=cam_m))
    ts = S.unpack_host_blob(blob, orb_m.max_keypoints)[1]
    check_pose("fused_mono_frame", ts[:16].reshape(4, 4))
    print(f"[5] fused_mono_frame 640x480: {ms['fused_mono_frame']:.3f} ms/frame "
          f"(median of {N_FRAMES})")
    check_inliers("fused_mono_frame", int(ts[16]))
    check_path("fused_mono_frame", N_FRAMES, stereo=False)

    # ---- [6] pose recovery from a perturbed prediction (stereo frame) ----
    deltas = ((0.05, 0.0, 0.0, 0.0, 0.0, 0.0),           # 5 cm sideways: ~1.9 px
              (0.0, 0.0, 0.0, 0.0, 0.003, 0.0),          # 0.17 deg yaw: ~2.2 px
              (0.03, -0.02, 0.05, 0.001, -0.001, 0.002))
    for delta in deltas:
        Tcw_pred = exp_se3(torch.tensor(delta, dtype=torch.float32, device=dev))
        blob, _ = S.fused_stereo_frame(pair, Tcw_pred, *s_pad, orb=orb_s, cam=cam_s,
                                       th_depth=th_depth)
        Tcw = check_pose("pose recovery",
                         S.unpack_host_blob(blob, orb_s.max_keypoints)[1][:16].reshape(4, 4))
        err_t = float(Tcw[:3, 3].norm())
        err_r = math.degrees(float(log_se3(Tcw.float())[3:].norm()))
        print(f"[6] delta {delta}: |t| {1e3 * err_t:.3f} mm, |R| {err_r:.5f} deg")
        if not (err_t < POSE_TOL_M and err_r < POSE_TOL_DEG):
            raise AssertionError(f"pose not recovered from delta {delta}")

    # one profiled fused frame per sensor geometry: CUDA kernels per frame
    # and the device's busy share
    for name, fn in (("fused_stereo_frame", lambda: S.fused_stereo_frame(
                          pair, Tcw_s, *s_pad, orb=orb_s, cam=cam_s, th_depth=th_depth)),
                     ("fused_mono_frame", lambda: S.fused_mono_frame(
                          img_m, Tcw_m, *m_pad, orb=orb_m, cam=cam_m))):
        n_kernels, busy = _profile_frame(fn)
        print(f"[6] {name} under torch.profiler: "
              + ("no device activity traced (not measured)" if n_kernels is None else
                 f"{n_kernels} CUDA kernels per frame, device busy {100 * busy:.2f}% "
                 "of the host time of the frame"), flush=True)

    # ---- [7]-[9] the tracking front end, Tracker, per sensor ----
    clock()
    path_launches.update(fast_pyramid=0, orb_desc=0, stereo_sad=0)
    sensors = {"stereo": Sensor.STEREO, "rgbd": Sensor.RGBD, "mono": Sensor.MONOCULAR}
    for phase, sensor in enumerate(("stereo", "rgbd", "mono"), start=7):
        t0 = time.perf_counter()
        poses, frames = render_sequence(sensor)
        kw = slam_config_kwargs(sensor)
        cfg = SlamConfig(camera=PinholeCamera(**kw["camera"]), orb=OrbConfig(**kw["orb"]),
                         fps=kw["fps"], th_depth=kw["th_depth"])
        c = kw["camera"]
        print(f"[{phase}] {sensor} {c['width']}x{c['height']}, {kw['orb']['n_features']} "
              f"features, {SEQ_FRAMES} frames rendered in {time.perf_counter() - t0:.1f} s",
              flush=True)
        tracker = Tracker(cfg, MapStore(cfg), sensors[sensor], device=dev)
        zero_counts()
        res = drive_tracker(tracker, sensor, poses, frames, sync=torch.cuda.synchronize)
        n = check_path(f"Tracker {sensor}", len(frames), stereo=sensor == "stereo")
        for k in ("fast_pyramid", "orb_desc", "stereo_sad"):
            path_launches[k] += n[k]
        ref = JAX_CPU_TRACKER[sensor]
        med = {k: (f"{statistics.median(res[k]):.3f}" if res[k] else "none")
               for k in ("ms_fused", "ms_staged")}
        print(f"[{phase}] {sensor}: tracked {res['tracked']}/{SEQ_FRAMES} (JAX {ref['tracked']}), "
              f"fused {res['fused']} (JAX {ref['fused']}), staged {res['staged']}, "
              f"keyframes {res['keyframes']} (JAX {ref['keyframes']}), "
              f"ATE {1e3 * res['ate_m']:.3f} mm (JAX {1e3 * ref['ate_m']:.3f} mm); "
              f"median ms per fused frame {med['ms_fused']} ({len(res['ms_fused'])}), "
              f"per staged frame {med['ms_staged']} ({len(res['ms_staged'])})", flush=True)
        stages = tracker.timer.summary()
        print(f"[{phase}] {sensor} host stages, median ms (count): " + ", ".join(
            f"{k} {v['median_ms']:.3f} ({v['count']})" for k, v in sorted(stages.items())),
            flush=True)
        if res["tracked"] != ref["tracked"]:
            raise AssertionError(f"{sensor}: {res['tracked']} frames tracked, JAX {ref['tracked']}")
        for k in ("fused", "keyframes"):
            if abs(res[k] - ref[k]) > TRACK_COUNT_TOL:
                raise AssertionError(f"{sensor}: {k} {res[k]}, JAX {ref[k]}")
        if abs(res["ate_m"] - ref["ate_m"]) > max(ATE_RTOL * ref["ate_m"], ATE_ATOL_M):
            raise AssertionError(f"{sensor}: ATE {res['ate_m']} m, JAX {ref['ate_m']} m")
        if sensor != "mono" and res["fused"] == 0:
            raise AssertionError(f"{sensor}: the fused path never ran")

    # ---- [10]-[12] System: local mapping and relocalization, per sensor ----
    clock()

    def count_syncs(fn, *a, **k):
        """fn's result and the host syncs it made, counted by torch's sync
        debug mode (a warning per synchronizing call). Inside another count,
        the syncs are passed on to it."""
        prev = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        syncs = [w for w in caught if "synchroniz" in str(w.message)]
        for w in syncs if prev else ():
            warnings.warn(w.message)
        return out, len(syncs)

    if count_syncs(lambda: torch.ones(1, device=dev).item())[1] < 1:
        raise AssertionError("the sync count does not see an .item()")
    solves = []   # (cameras of the bucket, syncs) per local-BA solve of the System phases

    def counted_solve(prob, *a, **k):
        out, n_sync = count_syncs(local_bundle_adjustment, prob, *a, **k)
        solves.append((prob.cam_Tcw.shape[0], n_sync))
        return out

    def system_phase(phase, sensor, slam, poses, frames, sync=torch.cuda.synchronize):
        """Drive a System phase (drive_system) with the local-BA solves
        counted, check its launches and hold it to the JAX System's anchors."""
        LM.local_bundle_adjustment = counted_solve
        n_solves = len(solves)
        zero_counts()
        try:
            res = drive_system(slam, sensor, poses, frames, sync=sync)
        finally:
            LM.local_bundle_adjustment = local_bundle_adjustment
        n_fed = len(frames) + SYS_BLANK + (SYS_REVISITS if res["relocalized"] is None
                                           else res["relocalized"] + 1)
        n = check_path(f"System {sensor}", n_fed, stereo=sensor == "stereo")
        for k in ("fast_pyramid", "orb_desc", "stereo_sad"):
            path_launches[k] += n[k]
        ref = JAX_CPU_SYSTEM[sensor]
        med = {k: (f"{statistics.median(res[k]):.3f} ({len(res[k])})" if res[k] else "none")
               for k in ("ms_kf", "ms_other", "reloc_ms")}
        err = "none" if res["reloc_err_m"] is None else f"{1e3 * res['reloc_err_m']:.3f} mm"
        print(f"[{phase}] System {sensor}: tracked {res['tracked']}/{SEQ_FRAMES} "
              f"(JAX {ref['tracked']}), LOST after the blank frames {res['lost']} "
              f"(JAX {ref['lost']}), relocalized on revisit {res['relocalized']} "
              f"(JAX {ref['relocalized']}; pose error {err}), "
              f"keyframes {res['keyframes']} (JAX {ref['keyframes']}), map points "
              f"{res['map_points']} (JAX {ref['map_points']}), ATE {1e3 * res['ate_m']:.3f} mm "
              f"(JAX {1e3 * ref['ate_m']:.3f} mm)", flush=True)
        print(f"[{phase}] System {sensor} median ms per keyframe frame {med['ms_kf']}, per "
              f"other frame {med['ms_other']}, per relocalization attempt {med['reloc_ms']}",
              flush=True)
        for name, timer in (("tracker", slam.tracker.timer), ("local mapper", slam.local_mapper.timer)):
            print(f"[{phase}] System {sensor} {name} stages, median ms (count): " + ", ".join(
                f"{k} {v['median_ms']:.3f} ({v['count']})"
                for k, v in sorted(timer.summary().items())), flush=True)
        phase_solves = solves[n_solves:]
        print(f"[{phase}] System {sensor}: {len(phase_solves)} local-BA solves, buckets "
              f"{sorted({c for c, _ in phase_solves})} cameras, host syncs per solve "
              f"{sorted({s for _, s in phase_solves})}", flush=True)
        if any(s for _, s in phase_solves):
            raise AssertionError(f"{sensor}: a local-BA solve synced with the host")
        if res["tracked"] != ref["tracked"] or res["lost"] != ref["lost"] \
                or res["relocalized"] != ref["relocalized"]:
            raise AssertionError(f"System {sensor}: {res}, JAX {ref}")
        if abs(res["keyframes"] - ref["keyframes"]) > SYS_KF_TOL:
            raise AssertionError(f"System {sensor}: keyframes {res['keyframes']}, JAX {ref}")
        if abs(res["map_points"] - ref["map_points"]) > SYS_MP_RTOL * ref["map_points"]:
            raise AssertionError(f"System {sensor}: map points {res['map_points']}, JAX {ref}")
        if abs(res["ate_m"] - ref["ate_m"]) > max(ATE_RTOL * ref["ate_m"],
                                                  SYS_ATE_ATOL_M[sensor]):
            raise AssertionError(f"System {sensor}: ATE {res['ate_m']} m, JAX {ref['ate_m']} m")
        if not phase_solves:
            raise AssertionError(f"System {sensor}: local BA never ran")
        return res

    systems, system_runs = {}, {}
    for phase, sensor in enumerate(("stereo", "rgbd", "mono"), start=10):
        poses, frames = render_sequence(sensor)
        kw = slam_config_kwargs(sensor)
        cfg = SlamConfig(camera=PinholeCamera(**kw["camera"]), orb=OrbConfig(**kw["orb"]),
                         fps=kw["fps"], th_depth=kw["th_depth"])
        slam = System(cfg, sensors[sensor], enable_loop_closing=False, device=dev)
        systems[sensor] = slam
        system_runs[sensor] = (system_phase(phase, sensor, slam, poses, frames),
                               map_state(slam), poses, frames)

    # ---- [13] local BA per bucket on synthetic problems ----
    clock()
    inv_s2 = torch.tensor([1.0 / 1.2 ** (2 * i) for i in range(8)], dtype=torch.float32,
                          device=dev)
    ba_cam = PinholeCamera(**BA_CAM)
    for bucket in LM.BA_BUCKETS:
        d = synthetic_ba_problem(bucket, seed=0)
        prob = BAProblem(**{k: torch.from_numpy(v).to(dev) for k, v in d.items()})
        solve = functools.partial(local_bundle_adjustment, prob, ba_cam, inv_s2)
        first, n_sync = count_syncs(solve)
        again, ms_solve = _frame_ms(solve, n=5)
        n_kernels, busy = _profile_frame(solve)
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        print(f"[13] local BA bucket {bucket}: {int(d['edge_valid'].sum())} edges, "
              f"{int(d['point_valid'].sum())} points; {ms_solve:.3f} ms per solve (median of 5), "
              f"{n_kernels} CUDA kernels, device busy "
              f"{'not measured' if busy is None else f'{100 * busy:.2f}%'}, {n_sync} host syncs; "
              f"two solves bit-identical {same}; inliers {int(first[2].sum())}", flush=True)
        if n_sync or not same:
            raise AssertionError(f"local BA bucket {bucket}: {n_sync} syncs, identical {same}")
        if not bool(torch.isfinite(first[0]).all() & torch.isfinite(first[1]).all()):
            raise AssertionError(f"local BA bucket {bucket}: non-finite result")
    def check_no_launch(name):
        n = read_counts()
        if any(n.values()):
            raise AssertionError(f"{name} launched kernels {n}")

    def cam_params(cam):
        return (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)

    # ---- [14] the grouped global BA ----
    clock()
    # (a) the stereo System's whole map after [10]
    slam = systems["stereo"]
    zero_counts()
    prob, kfs, pts = LM.build_global_ba_problem(slam.map, dev)
    E = int(prob.edge_cam.shape[0])
    path = "grouped" if E >= LM.FLAT_GBA_MAX_EDGES else "flat"
    inv_s2_map = torch.from_numpy(slam.local_mapper.inv_sigma2).to(dev)
    t0 = time.perf_counter()
    cams_r, pts_r = LM.solve_global_ba(prob, slam.config.camera, slam.local_mapper.inv_sigma2)
    ms_route = 1e3 * (time.perf_counter() - t0)
    grouped = GBG.global_bundle_adjustment_grouped(prob, slam.config.camera, inv_s2_map)
    flat = global_bundle_adjustment(prob, slam.config.camera, inv_s2_map)
    check_no_launch("[14] global BA")
    d_cam = _max_err(grouped[0], flat[0])
    d_pt = _max_err(grouped[1], flat[1])
    routed = (cams_r, pts_r)
    same_route = all(np.array_equal(a, b.cpu().numpy())
                     for a, b in zip(routed, grouped if path == "grouped" else flat))
    print(f"[14] stereo System map: {len(kfs)} keyframes, {len(pts)} points, {E} edges "
          f"({'>=' if path == 'grouped' else 'below'} {LM.FLAT_GBA_MAX_EDGES}"
          f"{'' if path == 'grouped' else ': (b) is the evidence for the grouped path'}); "
          f"solve_global_ba took the {path} path ({ms_route:.3f} ms, its result equal to that "
          f"solver's: {same_route}); grouped against flat: cameras {d_cam:.3e}, points "
          f"{d_pt:.3e} (limits {GBA_CAM_TOL}, {GBA_PT_TOL}), inliers agree "
          f"{float((grouped[2] == flat[2]).float().mean()):.4f}", flush=True)
    if not same_route or d_cam > GBA_CAM_TOL or d_pt > GBA_PT_TOL:
        raise AssertionError("[14] grouped and flat global BA disagree on the stereo map")
    stereo_map = (prob, slam.config.camera, inv_s2_map, flat)     # for [21](c)

    # (b) examples/bench_gba.py's problem
    d = gba_bench_problem(**GBA_BENCH, seed=0)
    prob = BAProblem(**{k: torch.from_numpy(v).to(dev) for k, v in d.items()})
    gcam = PinholeCamera(**GBA_CAM)
    inv_s2 = torch.from_numpy(GBA_INV_S2).to(dev)
    zero_counts()
    t0 = time.perf_counter()
    gp = GBG.group_global_problem(prob)
    torch.cuda.synchronize()
    ms_group = 1e3 * (time.perf_counter() - t0)
    Kp, P, Ks, Us = gp.shape
    solve = functools.partial(GBG.solve_grouped, gp, gcam, inv_s2, 10, 50, 1e-5)
    first, n_sync = count_syncs(solve)
    again, ms_solve = _frame_ms(solve, n=3)
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    torch.cuda.reset_peak_memory_stats()
    solve()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_kernels, busy = _profile_frame(solve)
    calls = []

    def spy(gp_, *a):
        calls.append(gp_)
        return GBG.solve_grouped(gp_, *a)

    LM.solve_grouped = spy
    cams_r, pts_r = LM.solve_global_ba(prob, gcam, GBA_INV_S2, n_iters=10)
    LM.solve_grouped = GBG.solve_grouped
    check_no_launch("[14] global BA")
    cost0 = float(GBA._robust_cost(prob.cam_Tcw, prob.points, prob, prob.edge_valid,
                                   cam_params(gcam), inv_s2, True))
    cost = float(GBA._robust_cost(first[0], first[1], prob, prob.edge_valid, cam_params(gcam),
                                  inv_s2, True))
    ref = JAX_CPU_GBA
    print(f"[14] bench_gba problem: {GBA_BENCH['n_cams']} cameras, {GBA_BENCH['n_points']} points, "
          f"{int(d['edge_cam'].size)} edges (JAX {ref['edges']}); layout Kp {Kp}, Kc "
          f"{gp.c_sel.shape[0]}, point spill {Ks}x{Us}, camera spill "
          f"{tuple(gp.cs_sel.shape)}, built on the host in {ms_group:.3f} ms", flush=True)
    print(f"[14] grouped solve (10 LM x 50 CG): {ms_solve:.3f} ms per solve (median of 3), "
          f"{ms_solve / 10:.3f} ms per GN iteration, {n_kernels} CUDA kernels, device busy "
          f"{_share(busy)}, {n_sync} host syncs, "
          f"peak device memory {peak_gb:.3f} GB; two solves bit-identical {same}; "
          f"solve_global_ba routed to it {len(calls)} time(s), result equal "
          f"{np.array_equal(cams_r, first[0].cpu().numpy())}; robust cost {cost0:.6g} -> "
          f"{cost:.6g} (JAX on the CPU {ref['cost_before']:.6g} -> {ref['cost_after']:.6g}, "
          f"{100 * (cost / ref['cost_after'] - 1):+.3f}%)", flush=True)
    if n_sync or not same or len(calls) != 1 \
            or not np.array_equal(cams_r, first[0].cpu().numpy()):
        raise AssertionError(f"[14] grouped solve: {n_sync} syncs, identical {same}, "
                             f"routed {len(calls)}")
    if not (math.isfinite(cost) and abs(cost / ref["cost_after"] - 1) <= GBA_COST_RTOL):
        raise AssertionError(f"[14] robust cost {cost}, JAX {ref['cost_after']}")
    gba_ref = first[:2]                                            # for [21](c)

    # ---- [15] System mono at configs/KITTI04-12.yaml (ROADMAP.md C.9) ----
    clock()
    cfg = load_settings_yaml(str(REPO / "configs" / "KITTI04-12.yaml"))
    if any(getattr(cfg.camera, k) != v for k, v in TRACK_SEQS["mono_kitti"]["cam"].items()):
        raise AssertionError(f"[15] the rendered camera is not the YAML's {cfg.camera}")
    poses, frames = render_sequence("mono_kitti")
    slam = System(cfg, Sensor.MONOCULAR, enable_loop_closing=False, device=dev)
    gba_runs = []

    def recorded_gba(prob_, *a, **k):
        E_ = int(prob_.edge_cam.shape[0])
        out = solve_global_ba(prob_, *a, **k)
        gba_runs.append((E_, "grouped" if E_ >= LM.FLAT_GBA_MAX_EDGES else "flat"))
        return out

    LM.solve_global_ba = recorded_gba
    zero_counts()
    tracked, first_ok, ms_frames = [], None, []
    for i, (img,) in enumerate(frames):
        t0 = time.perf_counter()
        Tcw = slam.track_monocular(img, i / cfg.fps)
        torch.cuda.synchronize()
        ms_frames.append(1e3 * (time.perf_counter() - t0))
        ok = Tcw is not None and slam.tracking_state.name == "OK"
        tracked.append(ok)
        if ok and first_ok is None:
            first_ok = i
    n = check_path("System mono KITTI04-12", len(frames), stereo=False)
    for k in ("fast_pyramid", "orb_desc", "stereo_sad"):
        path_launches[k] += n[k]
    n_init = len(gba_runs)
    # the whole map's global BA after the run, as loop closing will call it
    slam.local_mapper.global_ba()
    LM.solve_global_ba = solve_global_ba
    after = 0 if first_ok is None else sum(tracked[first_ok + 1:])
    c = cfg.camera
    print(f"[15] System mono, configs/KITTI04-12.yaml ({c.width}x{c.height}, fx {c.fx}, "
          f"{cfg.orb.n_features} features): initialized on frame {first_ok}, tracked {after} of "
          f"the {len(frames) - 1 - (first_ok or 0)} frames after; the initializations' global "
          f"BA (edges, path) {gba_runs[:n_init]}; keyframes {slam.map.n_keyframes()}, map points "
          f"{slam.map.n_map_points()}; median ms per frame {statistics.median(ms_frames):.3f}; "
          f"the whole map's global BA {gba_runs[n_init:]}", flush=True)
    if first_ok is None or after < MONO_KITTI_TRACKED or not n_init \
            or len(gba_runs) != n_init + 1:
        raise AssertionError(f"[15] mono KITTI04-12: init {first_ok}, {after} tracked after, "
                             f"global BA {gba_runs}")

    # ---- [16] Sim3 and the essential graph ----
    clock()
    zero_counts()
    inv_sig2 = 1.0 / SIGMA2
    for scale, fix in ((1.3, False), (1.0, True)):
        p1, p2, uv1, uv2, o1, o2, R, t, s_true = loop_matches(300, 0.3, scale, seed=0)
        ransac = functools.partial(solve_sim3_ransac, p2, p1, uv2, uv1, np.ones(len(p1), bool),
                                   o2, o1, SIGMA2, SIM3_K, fix, min_inliers=20, seed=0,
                                   device=dev)
        res, sync_r = count_syncs(ransac)
        if res is None:
            raise AssertionError(f"[16] Sim3 RANSAC found no hypothesis (fix_scale {fix})")
        S0 = np.eye(4, dtype=np.float32)
        S0[:3, :3], S0[:3, 3] = res.s * res.R, res.t
        refine = functools.partial(optimize_sim3, S0, p1, p2, uv1, uv2, res.inliers,
                                   inv_sig2[o1], inv_sig2[o2], SIM3_K, fix_scale=fix, device=dev)
        opt, sync_o = count_syncs(refine)
        _, ms_r = _frame_ms(ransac, n=SIM3_TIMED)
        _, ms_o = _frame_ms(refine, n=SIM3_TIMED)
        k_o, busy_o = _profile_frame(refine)
        S12 = opt.S12.double().cpu().numpy()
        s_est = float(np.cbrt(np.linalg.det(S12[:3, :3])))
        cos = (np.trace((S12[:3, :3] / s_est).T @ R) - 1) / 2
        rot_deg = math.degrees(math.acos(min(1.0, max(-1.0, cos))))
        print(f"[16] Sim3 {'fixed' if fix else 'free'} scale (true {scale}): RANSAC {res.n_inliers} "
              f"inliers of 300, {ms_r:.3f} ms, {sync_r} host syncs; optimize_sim3 "
              f"{int(opt.n_inliers)} inliers, {ms_o:.3f} ms, {sync_o} host syncs, {k_o} CUDA "
              f"kernels, device busy {_share(busy_o)}; rotation off by {rot_deg:.5f} deg, "
              f"scale {s_est:.6f}", flush=True)
        if not (rot_deg < 0.1 and abs(s_est / scale - 1) < 0.01 and int(opt.n_inliers) >= 20):
            raise AssertionError(f"[16] Sim3 not recovered: {rot_deg} deg, scale {s_est}")

    def edge_error(Sk, pr):
        """Mean norm of the edges' 7-vector errors log(Sji Si Sj^-1)."""
        Sk = torch.as_tensor(Sk, dtype=torch.float32, device=dev)
        Sji = torch.from_numpy(pr["edge_Sji"]).to(dev)
        i, j = (torch.from_numpy(pr[k]).long().to(dev) for k in ("edge_i", "edge_j"))
        return float(log_sim3(Sji @ Sk[i] @ sim3_inverse(Sk[j])).norm(dim=1).mean())

    graphs = {}     # K -> circle_pose_graph(K): two cases share K = 1408
    for Kn, backend, n_iters in POSE_GRAPH_CASES:
        if Kn not in graphs:
            graphs[Kn] = circle_pose_graph(Kn)
        pr, S_true, S_est = graphs[Kn]
        pgp = PoseGraphProblem(**pr)
        taken = pose_graph_backend(pgp, backend)
        solve = functools.partial(optimize_pose_graph, pgp, n_iters=n_iters, backend=backend,
                                  device=dev)
        # one GN iteration, first with its host syncs counted (the run that
        # warms the case up), then profiled; then one whole solve, timed alone
        one = functools.partial(optimize_pose_graph, pgp, n_iters=1, backend=backend, device=dev)
        n_sync = count_syncs(one)[1]
        k_one, busy_one = _profile_frame(one)
        S_opt, ms_pg = _frame_ms(solve, n=1)
        S_opt = S_opt.cpu().numpy()
        t0_err = np.linalg.norm(S_est[:, :3, 3] - S_true[:, :3, 3], axis=1).mean()
        t1_err = np.linalg.norm(S_opt[:, :3, 3] - S_true[:, :3, 3], axis=1).mean()
        e0, e1 = edge_error(S_est, pr), edge_error(S_opt, pr)
        print(f"[16] pose graph K={Kn}, {pr['edge_i'].size} edges, backend {backend!r} -> "
              f"{taken}, {n_iters} GN: {ms_pg:.3f} ms per solve (warm, no sync counter); one "
              f"GN iteration: {n_sync} host syncs, {k_one} CUDA kernels, device busy "
              f"{_share(busy_one)}; "
              f"mean edge error {e0:.4g} -> {e1:.4g} "
              f"({e0 / max(e1, 1e-30):.4g}x), mean translation error {t0_err:.4g} -> "
              f"{t1_err:.4g} m ({t0_err / max(t1_err, 1e-30):.4g}x)", flush=True)
        if not (e1 * 100 <= e0 and t1_err * 100 <= t0_err):
            raise AssertionError(f"[16] pose graph K={Kn} {backend}: not cut 100x")
    check_no_launch("[16] Sim3 and the essential graph")

    # ---- [17]/[18] loop closing ----
    gba_solves = []   # (path, host syncs) of each global-BA solve behind a loop

    def counted_grouped(*a, **k):
        out, n_sync = count_syncs(GBG.solve_grouped, *a, **k)
        gba_solves.append(("grouped", n_sync))
        return out

    def counted_flat(*a, **k):
        out, n_sync = count_syncs(global_bundle_adjustment, *a, **k)
        gba_solves.append(("flat", n_sync))
        return out

    def count_loop_syncs(lc):
        """Count the host syncs of each on_new_keyframe call of a loop
        closer: (keyframe, syncs, whether it closed a loop)."""
        calls, on_kf = [], lc.on_new_keyframe

        def counted(kf):
            n_loops = lc.n_loops_closed
            out, n_sync = count_syncs(on_kf, kf)
            calls.append((int(kf), n_sync, lc.n_loops_closed > n_loops))
            return out

        lc.on_new_keyframe = counted
        return calls

    def loop_stages(stage_ms):
        return ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())

    LM.solve_grouped, LM.global_bundle_adjustment = counted_grouped, counted_flat

    # ---- [17] a loop lap through System with loop closing on ----
    clock()
    kw = loop_lap_config_kwargs()
    cfg = SlamConfig(**{**kw, "camera": PinholeCamera(**kw["camera"]),
                        "orb": OrbConfig(**kw["orb"])})
    t0 = time.perf_counter()
    poses, frames = render_loop_lap()
    ms_render = 1e3 * (time.perf_counter() - t0)
    slam = System(cfg, Sensor.RGBD, enable_loop_closing=True, enable_global_ba_on_loop=True,
                  device=dev)
    lc_calls = count_loop_syncs(slam.loop_closer)
    n_gba = len(gba_solves)
    zero_counts()
    res = drive_loop_lap(slam, poses, frames, sync=torch.cuda.synchronize)
    n = check_path("System RGB-D loop lap", len(frames), stereo=False)
    for k in ("fast_pyramid", "orb_desc", "stereo_sad"):
        path_launches[k] += n[k]
    ref = JAX_CPU_LOOP
    c = kw["camera"]
    print(f"[17] System RGB-D loop lap ({c['width']}x{c['height']}, fx {c['fx']}, "
          f"{kw['orb']['n_features']} features, {len(frames)} frames rendered in "
          f"{ms_render / 1e3:.1f} s): tracked {res['tracked']} (JAX {ref['tracked']}), loops closed "
          f"(frame, keyframe) {res['loops']} (JAX {ref['loops']}), keyframes live "
          f"{res['keyframes']} (JAX {ref['keyframes']}) of {res['allocated']} allocated (JAX "
          f"{ref['allocated']}), map points {res['map_points']} (JAX {ref['map_points']}), "
          f"exported-trajectory ATE {1e3 * res['ate_m']:.3f} mm over {res['exported']} frames "
          f"(JAX {1e3 * ref['ate_m']:.3f} mm, limit +-{1e3 * LOOP_ATE_ATOL_M:.1f} mm)", flush=True)
    first_loop = res["loops"][0][0] if res["loops"] else len(frames)
    for tag, sel in (("before the loop", slice(0, first_loop)),
                     ("after the loop", slice(first_loop + 1, None))):
        part = res["frame_ms"][sel]
        med = {kf: [ms_ for ms_, is_kf in part if is_kf == kf] for kf in (True, False)}
        print(f"[17] {tag}: median ms per keyframe frame "
              + (f"{statistics.median(med[True]):.3f} ({len(med[True])})" if med[True] else "none")
              + ", per other frame "
              + (f"{statistics.median(med[False]):.3f} ({len(med[False])})" if med[False]
                 else "none"), flush=True)
    for (i, kf), stage_ms in zip(res["loops"], res["stage_ms"]):
        n_sync = next(s for k, s, closed in lc_calls if k == kf and closed)
        print(f"[17] loop-closing frame {i} (keyframe {kf}): {res['frame_ms'][i][0]:.3f} ms; loop "
              f"closer stages ms: {loop_stages(stage_ms)}; host syncs in its loop-closer call "
              f"{n_sync}", flush=True)
    lap_gba = gba_solves[n_gba:]
    graph = slam.loop_closer.last_graph
    print(f"[17] essential graph (backend, keyframes, edges) {graph}; global BA "
          f"{slam.gba_runner.last_edges} edges, solves (path, host syncs) {lap_gba}; loop-closer "
          f"stages, median ms (count): " + ", ".join(
              f"{k} {v['median_ms']:.3f} ({v['count']})"
              for k, v in sorted(slam.loop_closer.timer.summary().items())), flush=True)
    misses = loop_lap_misses(res)
    if misses:
        raise AssertionError("[17] loop lap: " + "; ".join(misses))
    if any(s for _, s in lap_gba) or len(lap_gba) != len(res["loops"]):
        raise AssertionError(f"[17] global BA solves {lap_gba} for {len(res['loops'])} loops")

    # ---- [18] LoopCloser on a drifted loop at KITTI size ----
    clock()
    kw = loop_map_config_kwargs()
    cfg = SlamConfig(**{**kw, "camera": PinholeCamera(**kw["camera"]),
                        "orb": OrbConfig(**kw["orb"])})
    n_lap = LOOP_MAP["lap_kfs"]
    t0 = time.perf_counter()
    ms_map, gt, _ = drifted_loop_map(MapStore, FrameData, cfg)
    ms_build = 1e3 * (time.perf_counter() - t0)
    err_before = loop_map_errors(ms_map, gt, n_lap)
    voc = load_default_vocabulary()
    runner = GlobalBARunner(cfg, ms_map, device=dev)
    lc = LoopCloser(cfg, ms_map, voc, KeyFrameDatabase(voc, cfg.max_keyframes), fix_scale=True,
                    local_mapper=LocalMapper(cfg, ms_map, monocular=False, device=dev),
                    run_global_ba=True, gba_runner=runner, device=dev)
    lc_calls = count_loop_syncs(lc)
    solved = []

    def recorded_gba(prob, *a, **k):
        out = solve_global_ba(prob, *a, **k)
        solved.append((prob, out))
        return out

    GR.solve_global_ba = recorded_gba
    n_gba = len(gba_solves)
    zero_counts()
    closed, call_ms = drive_loop_map(lc, sync=torch.cuda.synchronize)
    check_no_launch("[18] LoopCloser")
    GR.solve_global_ba = solve_global_ba
    LM.solve_grouped, LM.global_bundle_adjustment = GBG.solve_grouped, global_bundle_adjustment
    err_after = loop_map_errors(ms_map, gt, n_lap)
    ref = JAX_CPU_LOOP_MAP
    inv_s2 = torch.from_numpy(runner.inv_sigma2).to(dev)
    costs = []
    for prob, (cams, pts) in solved:
        c0 = float(GBA._robust_cost(prob.cam_Tcw, prob.points, prob, prob.edge_valid,
                                    cam_params(cfg.camera), inv_s2, True))
        c1 = float(GBA._robust_cost(torch.from_numpy(cams).to(dev), torch.from_numpy(pts).to(dev),
                                    prob, prob.edge_valid, cam_params(cfg.camera), inv_s2, True))
        costs.append((int(prob.edge_cam.shape[0]), c0, c1))
    map_gba = gba_solves[n_gba:]
    c = kw["camera"]
    print(f"[18] drifted loop map ({c['width']}x{c['height']}, fx {c['fx']}, "
          f"{LOOP_MAP['n_features']} keypoints a keyframe): {ms_map.n_kf} keyframes, "
          f"{int(ms_map.mp_valid.sum())} map points at the end, built in {ms_build:.1f} ms; loops "
          f"closed (keyframe, loop keyframe) {[(k, lk) for k, lk, _ in closed]} (JAX "
          f"{[(k, lk) for k, lk, _ in ref['closed']]}); essential graph (backend, keyframes, "
          f"edges) {lc.last_graph} (JAX {ref['graphs']}); keyframe-centre error (lap end, mean) "
          f"{err_before[0]:.4f}, {err_before[1]:.4f} m -> {err_after[0]:.4f}, {err_after[1]:.4f} m "
          f"(JAX {ref['err_after'][0]:.4f}, {ref['err_after'][1]:.4f} m)", flush=True)
    for kf, n_sync, was_closed in lc_calls:
        if was_closed:
            i = [k for k, _, _ in lc_calls].index(kf)
            stage_ms = {k: 1e3 * v[-1] for k, v in lc.timer.samples.items() if k != "detect"}
            print(f"[18] loop-closing call (keyframe {kf}): {call_ms[i]:.3f} ms; stages ms: "
                  f"detect {1e3 * lc.timer.samples['detect'][i]:.3f}, {loop_stages(stage_ms)}; "
                  f"host syncs {n_sync}", flush=True)
    print(f"[18] median ms per other on_new_keyframe call "
          f"{statistics.median(ms_ for (_, _, cl), ms_ in zip(lc_calls, call_ms) if not cl):.3f} "
          f"({len(call_ms) - len(closed)}); global BA (edges, robust cost before, after) {costs} "
          f"(JAX {ref['gba']}), solves (path, host syncs) {map_gba}, "
          f"{1e3 * sum(lc.timer.samples['global_ba']):.3f} ms", flush=True)
    if len(closed) != 1 or [(k, lk) for k, lk, _ in closed] \
            != [(k, lk) for k, lk, _ in ref["closed"]]:
        raise AssertionError(f"[18] loops closed {closed}, JAX {ref['closed']}")
    S, S_ref = closed[0][2], np.asarray(ref["closed"][0][2])
    s, s_ref = np.cbrt(np.linalg.det(S[:3, :3])), np.cbrt(np.linalg.det(S_ref[:3, :3]))
    cos = (np.trace((S[:3, :3] / s).T @ (S_ref[:3, :3] / s_ref)) - 1) / 2
    d_rot = math.acos(min(1.0, max(-1.0, cos)))
    d_t = np.linalg.norm(S[:3, 3] - S_ref[:3, 3]) / np.linalg.norm(S_ref[:3, 3])
    print(f"[18] S_cl against JAX: rotation {d_rot:.3e} rad, translation {d_t:.3e} relative, "
          f"scale {s:.6f} (JAX {s_ref:.6f})", flush=True)
    if d_rot > 1e-3 or d_t > 1e-3:
        raise AssertionError(f"[18] S_cl off JAX by {d_rot} rad, {d_t} relative")
    if lc.last_graph[0] != "banded" or [lc.last_graph[1:]] != [tuple(g) for g in ref["graphs"]]:
        raise AssertionError(f"[18] essential graph {lc.last_graph}, JAX {ref['graphs']}")
    for i, name in enumerate(("lap end", "mean")):
        if abs(err_after[i] - ref["err_after"][i]) > 0.1 * ref["err_after"][i] \
                or 2 * err_after[i] > err_before[i]:
            raise AssertionError(f"[18] {name} error {err_before[i]} -> {err_after[i]} m, JAX "
                                 f"{ref['err_after'][i]} m")
    if len(costs) != 1 or abs(costs[0][2] / ref["gba"][0]["cost_after"] - 1) > GBA_COST_RTOL \
            or costs[0][0] != ref["gba"][0]["edges"] or any(s_ for _, s_ in map_gba) \
            or [p for p, _ in map_gba] != ["grouped"]:
        raise AssertionError(f"[18] global BA {costs} {map_gba}, JAX {ref['gba']}")

    # ---- [19] the asynchronous pipeline ----
    clock()
    e2e = _load_tool("bench_e2e")
    # (a) [10]'s stereo frames through the async System, drained after each frame
    _, state10, poses, frames = system_runs["stereo"]
    kw = slam_config_kwargs("stereo")
    cfg = SlamConfig(camera=PinholeCamera(**kw["camera"]), orb=OrbConfig(**kw["orb"]),
                     fps=kw["fps"], th_depth=kw["th_depth"])
    slam = System(cfg, Sensor.STEREO, enable_loop_closing=False, async_mapping=True, device=dev)

    def drained():
        slam.local_mapper.wait_idle(ASYNC_WAIT_S)
        torch.cuda.synchronize()

    try:
        system_phase("19a", "stereo", slam, poses, frames, sync=drained)
    finally:
        slam.shutdown()
    lm = slam.local_mapper
    same = same_state(map_state(slam), state10)
    print(f"[19a] async System stereo: the worker processed {lm.n_processed} of {slam.map.n_kf} "
          f"keyframes; local BA aborted {lm.n_ba_aborted}, stale {lm.n_ba_stale}; bit-identical "
          f"to [10]'s run: {same}", flush=True)
    if lm.n_processed != slam.map.n_kf:
        raise AssertionError(f"[19a] the worker processed {lm.n_processed} of {slam.map.n_kf}")

    # (b) the end-to-end lap, free-running, async (E2E_MODES)
    clock()
    t0 = time.perf_counter()
    scene = e2e.render_loop(E2E_FRAMES, E2E_LAPS, E2E_OVERLAP, workers=E2E_RENDER_WORKERS)
    ms_render = 1e3 * (time.perf_counter() - t0)
    travel = 2 * math.pi * 25.0 * E2E_LAPS      # render_loop's camera circle: 25 m
    runs = {}
    for mode in E2E_MODES:
        zero_counts()
        out = e2e.run_e2e(async_mapping=mode == "async", device=dev, progress_every=0,
                          scene=scene)
        n = check_path(f"[19b] e2e {mode}", E2E_FRAMES, stereo=True)
        for k in ("fast_pyramid", "orb_desc", "stereo_sad"):
            path_launches[k] += n[k]
        r = runs[mode] = out["extra"]
        st = r["stage_ms"]
        print(f"[19b] e2e {mode} (1241x376, 2000 features, {E2E_FRAMES} frames rendered in "
              f"{ms_render / 1e3:.1f} s): tracked {r['tracked']}, loops closed "
              f"{r['loops_closed']} (frame, ms) {r['loop_frames_ms']}, keyframes {r['keyframes']} "
              f"live of {r['keyframes_allocated']}, map points {r['map_points']}, exported ATE "
              f"{r['ate_m']:.4f} m over {r['exported_frames']} frames (limit "
              f"{E2E_ATE_SHARE * travel:.4f} m); ms a frame (after {r['warmup_excluded']}) median "
              f"{r['median_ms']:.3f}, p90 {r['p90_ms']:.3f}, max {r['max_ms']:.3f}, mean "
              f"{r['mean_ms']:.3f} ({out['value']:.3f} fps); fused {r['fused_frames']}, staged "
              f"{r['staged_frames']}; mapper n_processed {r['n_processed']}, local BA aborted "
              f"{r['n_ba_aborted']}, stale {r['n_ba_stale']}, keyframes deferred "
              f"{r['n_kf_deferred']}, frames with a keyframe waiting {r['frames_kf_waiting']}; "
              f"global BA completed "
              f"{r['gba_completed']}, aborted {r['gba_aborted']}; frames {r['wall_s']:.1f} s, "
              f"drain {r['drain_s']:.1f} s", flush=True)
        for kf, ms_, stage_ms in r["loop_calls_ms"]:
            print(f"[19b] e2e {mode} loop-closing call (keyframe {kf}): {ms_:.3f} ms; stages ms: "
                  f"{loop_stages(stage_ms)}", flush=True)
        print(f"[19b] e2e {mode} exported ATE m before and after each loop correction "
              f"(keyframe, before, after) {r['loop_ate_m']}; RMS error m by 50-frame window "
              f"{r['error_by_window_m']}", flush=True)
        for name in ("tracker", "local_mapper", "loop_closer"):
            print(f"[19b] e2e {mode} {name} stages, median ms (count): " + ", ".join(
                f"{k} {v['median_ms']:.3f} ({v['n']})" for k, v in sorted(st[name].items())),
                flush=True)
    a_ = runs["async"]
    misses = []
    if a_["tracked"] < math.ceil(E2E_TRACKED_SHARE * E2E_FRAMES) - E2E_ASYNC_SLACK:
        misses.append(f"async tracked {a_['tracked']} of {E2E_FRAMES}")
    for mode, r in runs.items():
        if r["loops_closed"] < 1:
            misses.append(f"{mode} closed no loop")
        if not r["ate_m"] < E2E_ATE_SHARE * travel:
            misses.append(f"{mode} ATE {r['ate_m']} m")
        if r["gba_completed"] + r["gba_aborted"] < r["loops_closed"]:
            misses.append(f"{mode}: {r['gba_completed']} + {r['gba_aborted']} global BAs for "
                          f"{r['loops_closed']} loops")
    if a_["n_processed"] <= 0 or a_["n_ba_stale"] > a_["keyframes_allocated"]:
        misses.append(f"async n_processed {a_['n_processed']}, stale {a_['n_ba_stale']}")
    if misses:
        raise AssertionError("[19b] " + "; ".join(misses))
    # ---- [20] the dataset drivers on files ----
    clock()
    drive_datasets(str(dev), zero_counts, check_path, path_launches)
    # ---- [21] the entry points and the sharded global BA ----
    clock()
    drive_parallel(dev, zero_counts, read_counts, check_path, path_launches, count_syncs,
                   gba_ref, stereo_map)
    # ---- [22] the KITTI-class monocular circuit ----
    clock()
    drive_kitti_mono(dev, zero_counts, check_path, path_launches)
    print(f"    main-path launches {path_launches}; whole run {time.perf_counter() - t_start:.1f} s",
          flush=True)

    jax_mods = [m for m in ("jax", "orb_slam2_detailed_comments_tpu") if m in sys.modules]
    if jax_mods:
        raise AssertionError(f"the port's run imported {jax_mods}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": path_launches[name],
         **{k: report[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}}
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
