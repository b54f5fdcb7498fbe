"""Shared inputs for the parity tests of the PyTorch port against the JAX
package (tests/test_torch_*.py).

Everything is made with numpy from a seed and handed to both packages.
Images are noise-textured: on the flat backgrounds of bench.py's images,
float32 matmuls that sum in a different order (XLA's vs torch's) move
pyramid pixels by an ulp and flip FAST plateau ties and BRIEF comparisons
of equal samples, which is a property of the inputs, not of the port; the
flat-image case is tested with the JAX package's own pyramid levels
(test_torch_ops.py).
"""
from __future__ import annotations

import contextlib
import copy
import os

import numpy as np

# the JAX package's exact modes: gather-form descriptors (its
# specification), the XLA FAST maps and the XLA patch gather
JAX_EXACT_MODES = {"ORB_DESC_ONEHOT": "0", "ORB_FAST_PALLAS": "0", "ORB_PATCH_PALLAS": "0"}


@contextlib.contextmanager
def jax_exact_modes():
    """Set JAX_EXACT_MODES for the block; the jit caches are cleared when
    the environment changes, on the way in and out (the modes are read at
    trace time)."""
    import jax
    old = {k: os.environ.get(k) for k in JAX_EXACT_MODES}
    changed = old != JAX_EXACT_MODES
    os.environ.update(JAX_EXACT_MODES)
    if changed:
        jax.clear_caches()
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if changed:
            jax.clear_caches()


def noise_image(h, w, seed):
    return np.random.default_rng(seed).uniform(0, 255, (h, w)).astype(np.float32)


def squares_image(h, w, seed, n=600):
    """bench.py's kind of image: squares on a flat 40.0 background."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 40.0, np.float32)
    for y, x in zip(rng.integers(10, h - 12, n), rng.integers(10, w - 12, n)):
        s = rng.integers(3, 10)
        img[y:y + s, x:x + s] = rng.uniform(60, 250)
    return img


H, W = 120, 160
DISP = 8            # integer stereo disparity of the small world, px
PAD_SLOTS = 512
N_POINTS = 256


def small_world(seed=0):
    """A 160x120 noise-textured stereo pair (right = left shifted by DISP
    px), its depth map, configs and a 256-point local map built from the
    JAX package's keypoints, packed into a 512-slot pad.

    Returns a dict of numpy arrays and the JAX package's OrbConfig and
    PinholeCamera."""
    import jax.numpy as jnp
    from orb_slam2_detailed_comments_tpu.geometry.camera import PinholeCamera
    from orb_slam2_detailed_comments_tpu.ops.orb import extract_orb
    from orb_slam2_detailed_comments_tpu.utils.config import OrbConfig

    rng = np.random.default_rng(seed)
    cam = PinholeCamera(fx=200.0, fy=200.0, cx=80.0, cy=60.0, bf=40.0, width=W, height=H)
    z = cam.bf / DISP
    wide = noise_image(H, W + DISP, seed + 1)
    img_l, img_r = wide[:, DISP:].copy(), wide[:, :W].copy()
    orb = OrbConfig(n_features=150, max_keypoints=256, n_levels=3)
    with jax_exact_modes():
        kp = extract_orb(jnp.asarray(img_l), orb)
    kp_xy, kp_oct = np.asarray(kp.xy), np.asarray(kp.octave)
    valid_idx = np.nonzero(np.asarray(kp.valid))[0]
    idx = rng.choice(valid_idx, N_POINTS)
    pos = np.stack([(kp_xy[idx, 0] - cam.cx) / cam.fx * z,
                    (kp_xy[idx, 1] - cam.cy) / cam.fy * z,
                    np.full(N_POINTS, z)], -1).astype(np.float32)
    dists = np.linalg.norm(pos, axis=-1)
    max_d = dists * (1.2 ** kp_oct[idx])
    packed = np.zeros((PAD_SLOTS, 8), np.float32)
    packed[:N_POINTS] = np.concatenate(
        [pos, pos / dists[:, None], (max_d / 1.2 ** 7)[:, None], max_d[:, None]], 1)
    desc = np.zeros((PAD_SLOTS, 8), np.uint32)
    desc[:N_POINTS] = np.asarray(kp.desc)[idx]
    valid = np.zeros(PAD_SLOTS, bool)
    valid[:N_POINTS] = True
    return dict(img_l=img_l, img_r=img_r, depth=np.full((H, W), z, np.float32),
                packed=packed, desc=desc, valid=valid), orb, cam


def perturbed_pose(delta=(0.01, -0.005, 0.02, 0.002, -0.001, 0.0015)):
    """A predicted pose a few pixels off identity, as float32 numpy (4, 4)."""
    import torch
    from orb_slam2_detailed_comments_tpu_torch.geometry.se3 import exp_se3
    return exp_se3(torch.tensor(delta, dtype=torch.float64)).float().numpy()


@contextlib.contextmanager
def _jax_fused_exact():
    """The JAX package with the fused path on (ORB_FUSED_TRACK=1, the
    port's default) in the exact modes, for the block."""
    old = os.environ.get("ORB_FUSED_TRACK")
    os.environ["ORB_FUSED_TRACK"] = "1"
    try:
        with jax_exact_modes():
            yield
    finally:
        if old is None:
            os.environ.pop("ORB_FUSED_TRACK")
        else:
            os.environ["ORB_FUSED_TRACK"] = old


def _chip_smoke():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def _sequence(sensor):
    """chip_smoke.py's rendered sequence for `sensor` and the JAX package's
    SlamConfig and Sensor for it."""
    chip_smoke = _chip_smoke()
    from orb_slam2_detailed_comments_tpu.frontend.tracking import Sensor
    from orb_slam2_detailed_comments_tpu.geometry.camera import PinholeCamera
    from orb_slam2_detailed_comments_tpu.utils.config import OrbConfig, SlamConfig

    poses, frames = chip_smoke.render_sequence(sensor)
    kw = chip_smoke.slam_config_kwargs(sensor)
    cfg = SlamConfig(camera=PinholeCamera(**kw["camera"]), orb=OrbConfig(**kw["orb"]),
                     fps=kw["fps"], th_depth=kw["th_depth"])
    sensor_enum = {"stereo": Sensor.STEREO, "rgbd": Sensor.RGBD, "mono": Sensor.MONOCULAR}[sensor]
    return chip_smoke, poses, frames, cfg, sensor_enum


def jax_tracker_anchor(sensor):
    """The JAX package's Tracker on chip_smoke.py's rendered full-size
    sequence for `sensor` ("stereo", "rgbd" or "mono"), with the fused path
    on (ORB_FUSED_TRACK=1) in the exact modes: the source of chip_smoke.py's
    JAX_CPU_TRACKER anchors. About 1.5 min and 3 GB per sensor on the CPU."""
    from orb_slam2_detailed_comments_tpu.frontend.tracking import Tracker
    from orb_slam2_detailed_comments_tpu.state.map_store import MapStore

    chip_smoke, poses, frames, cfg, sensor_enum = _sequence(sensor)
    with _jax_fused_exact():
        res = chip_smoke.drive_tracker(Tracker(cfg, MapStore(cfg), sensor_enum), sensor,
                                       poses, frames)
    return {k: res[k] for k in ("tracked", "fused", "keyframes", "ate_m")}


def jax_system_anchor(sensor, perturb=None):
    """The JAX package's System(..., enable_loop_closing=False) with the
    shipped vocabulary on chip_smoke.py's System phase for `sensor`: the
    rendered sequence, blank frames and revisits (chip_smoke.drive_system),
    with the fused path on in the exact modes. The source of chip_smoke.py's
    JAX_CPU_SYSTEM anchors; with `perturb` (chip_smoke.perturbed_run: "staged"
    or "noise<seed>") the same phase changed by nothing of substance, the
    source of its spread. About 2.5-5 min and 3 GB per sensor on the CPU."""
    from orb_slam2_detailed_comments_tpu.system import System

    chip_smoke, _, _, cfg, sensor_enum = _sequence(sensor)
    poses, frames, use_fused = chip_smoke.perturbed_run(sensor, perturb)
    with _jax_fused_exact():
        slam = System(cfg, sensor_enum, enable_loop_closing=False)
        slam.tracker.use_fused = use_fused
        res = chip_smoke.drive_system(slam, sensor, poses, frames)
    return {k: res[k] for k in ("tracked", "lost", "relocalized", "keyframes", "map_points",
                                "ate_m")}


def jax_loop_anchor(perturb=None):
    """The JAX package's System(cfg, Sensor.RGBD, enable_loop_closing=True,
    enable_global_ba_on_loop=True) with the shipped vocabulary on
    chip_smoke.py's [17] lap (chip_smoke.drive_loop_lap), with the fused
    path on in the exact modes. The source of chip_smoke.py's JAX_CPU_LOOP;
    with `perturb` ("noise<seed>", chip_smoke.loop_lap_frames) the same lap
    under +-1e-3 grey levels of noise, the source of its spread, and with
    "clean" the lap rendered without its +-2 grey levels of sensor noise.
    About 20 min and 4 GB on the CPU."""
    from orb_slam2_detailed_comments_tpu.frontend.tracking import Sensor
    from orb_slam2_detailed_comments_tpu.geometry.camera import PinholeCamera
    from orb_slam2_detailed_comments_tpu.system import System
    from orb_slam2_detailed_comments_tpu.utils.config import OrbConfig, SlamConfig

    chip_smoke = _chip_smoke()
    kw = chip_smoke.loop_lap_config_kwargs()
    cfg = SlamConfig(**{**kw, "camera": PinholeCamera(**kw["camera"]),
                        "orb": OrbConfig(**kw["orb"])})
    poses, frames = chip_smoke.loop_lap_frames(perturb)
    with _jax_fused_exact():
        slam = System(cfg, Sensor.RGBD, enable_loop_closing=True, enable_global_ba_on_loop=True)
        slam.tracker.use_fused = True
        res = chip_smoke.drive_loop_lap(slam, poses, frames)
    res["s_per_frame"] = sum(ms for ms, _ in res["frame_ms"]) / 1e3 / len(res["frame_ms"])
    return {k: res[k] for k in ("tracked", "loops", "keyframes", "allocated", "map_points",
                                "ate_m", "exported", "s_per_frame")}


def jax_loop_map_anchor():
    """The JAX package's LoopCloser (fix_scale=True, a stereo LocalMapper
    for the loop fusion, the inline GlobalBARunner) fed chip_smoke.py's [18]
    drifted loop (chip_smoke.drifted_loop_map) through on_new_keyframe
    alone, with the shipped vocabulary: the source of chip_smoke.py's
    JAX_CPU_LOOP_MAP. The loops closed (keyframe, loop keyframe, S_cl), the
    essential graph's keyframes and edges, the keyframe-centre errors
    against the truth before and after (the lap's end, the mean), and the
    global BA's edges and robust cost before and after. About 3 min and 4
    GB on the CPU."""
    import contextlib
    import jax.numpy as jnp
    from orb_slam2_detailed_comments_tpu.backend import gba_runner as JR
    from orb_slam2_detailed_comments_tpu.backend import loop_closing as JL
    from orb_slam2_detailed_comments_tpu.backend.local_mapping import LocalMapper
    from orb_slam2_detailed_comments_tpu.geometry.camera import PinholeCamera
    from orb_slam2_detailed_comments_tpu.optim import global_ba as JG
    from orb_slam2_detailed_comments_tpu.place.kf_database import KeyFrameDatabase
    from orb_slam2_detailed_comments_tpu.state.frame import FrameData
    from orb_slam2_detailed_comments_tpu.state.map_store import MapStore
    from orb_slam2_detailed_comments_tpu.system import load_default_vocabulary
    from orb_slam2_detailed_comments_tpu.utils.config import OrbConfig, SlamConfig

    chip_smoke = _chip_smoke()
    kw = chip_smoke.loop_map_config_kwargs()
    cfg = SlamConfig(**{**kw, "camera": PinholeCamera(**kw["camera"]),
                        "orb": OrbConfig(**kw["orb"])})
    ms, gt, est = chip_smoke.drifted_loop_map(MapStore, FrameData, cfg)
    n_lap = chip_smoke.LOOP_MAP["lap_kfs"]
    before = chip_smoke.loop_map_errors(ms, gt, n_lap)
    voc = load_default_vocabulary()
    runner = JR.GlobalBARunner(cfg, ms, contextlib.nullcontext())
    lc = JL.LoopCloser(cfg, ms, voc, KeyFrameDatabase(voc, cfg.max_keyframes), fix_scale=True,
                       local_mapper=LocalMapper(cfg, ms, monocular=False), run_global_ba=True,
                       gba_runner=runner)
    graphs, gbas = [], []
    optimize_pose_graph, solve_global_ba = JL.optimize_pose_graph, JR.solve_global_ba

    def recorded_graph(prob, **k):
        graphs.append((int(prob.S_init.shape[0]), int(prob.edge_i.shape[0])))
        return optimize_pose_graph(prob, **k)

    def recorded_gba(prob, camera, inv_s2, **k):
        out = solve_global_ba(prob, camera, inv_s2, **k)
        c = (camera.fx, camera.fy, camera.cx, camera.cy, camera.bf)
        s2 = jnp.asarray(inv_s2)
        gbas.append(dict(edges=int(prob.edge_cam.shape[0]), cost_before=float(JG._robust_cost(
            prob.cam_Tcw, prob.points, prob, prob.edge_valid, c, s2, True)),
            cost_after=float(JG._robust_cost(jnp.asarray(out[0]), jnp.asarray(out[1]), prob,
                                             prob.edge_valid, c, s2, True))))
        return out

    JL.optimize_pose_graph, JR.solve_global_ba = recorded_graph, recorded_gba
    try:
        closed, _ = chip_smoke.drive_loop_map(lc)
    finally:
        JL.optimize_pose_graph, JR.solve_global_ba = optimize_pose_graph, solve_global_ba
    return dict(closed=[(k, lk, S.round(7).tolist()) for k, lk, S in closed], graphs=graphs,
                err_before=before, err_after=chip_smoke.loop_map_errors(ms, gt, n_lap),
                gba=gbas, keyframes=int(ms.n_keyframes()))


def jax_run_slam(mode, settings, seq, out, perturb=None):
    """The JAX package's own examples/run_slam.py on one sequence (System at
    the settings file's defaults, loop closing on), with the fused path on
    in the exact modes. With `perturb` "noise<seed>" every image the driver
    loads carries seeded uniform noise of +-chip_smoke.PERTURB_GREY grey
    levels. Returns what the port's run_slam is held to: frames tracked (not
    lost in the tracker's log), live keyframes and map points, the exported
    frames and the driver's ground-truth ATE (None without ground truth)."""
    import importlib.util
    import sys
    from pathlib import Path
    from orb_slam2_detailed_comments_tpu import system as JS
    from orb_slam2_detailed_comments_tpu.evaluation.gt_eval import evaluate_against_gt
    from orb_slam2_detailed_comments_tpu.io import datasets as JD
    from orb_slam2_detailed_comments_tpu.io.trajectory import recover_frame_trajectory

    path = Path(__file__).resolve().parents[1] / "examples" / "run_slam.py"
    spec = importlib.util.spec_from_file_location("jax_run_slam", path)
    run_slam = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run_slam)
    made = []
    init, load = JS.System.__init__, JD.load_image_gray
    grey = _chip_smoke().PERTURB_GREY
    rng = np.random.default_rng(int(perturb[len("noise"):]) if perturb else 0)

    def recording_init(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    def noisy_load(p):
        img = load(p)
        return (img + rng.uniform(-grey, grey, img.shape)).astype(np.float32)

    argv = sys.argv
    sys.argv = ["run_slam.py", mode, settings, seq, out]
    JS.System.__init__ = recording_init
    if perturb:
        JD.load_image_gray = noisy_load
    try:
        with _jax_fused_exact():
            run_slam.main()
    finally:
        sys.argv = argv
        JS.System.__init__, JD.load_image_gray = init, load
    slam = made[-1]
    frames = recover_frame_trajectory(slam.tracker.trajectory, slam.map)
    metrics = evaluate_against_gt(mode, seq, frames, mono=mode.endswith("mono"))
    return dict(tracked=sum(1 for e in slam.tracker.trajectory if not e[4]),
                keyframes=int(slam.map.n_keyframes()), map_points=int(slam.map.n_map_points()),
                exported=len(frames), ate_m=None if metrics is None else metrics["ate_rmse_m"])


def jax_run_slam_anchor(name, perturb=None):
    """jax_run_slam on chip_smoke.py's [20] sequence `name` ("kitti-stereo",
    "kitti-mono" or "tum-rgbd"), written to a temporary directory by
    chip_smoke.write_dataset: the source of chip_smoke.py's
    JAX_CPU_RUN_SLAM, and with `perturb` of the spread behind mono's ATE
    limit. About 4-8 min and 3-4 GB a sequence on the CPU."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as root:
        settings, seq, _ = _chip_smoke().write_dataset(name, root)
        return jax_run_slam(name, settings, seq, str(Path(root) / "out"), perturb)


def jax_gba_anchor():
    """The JAX package's grouped global BA (global_bundle_adjustment_grouped,
    its exact-float32 "gather" formulation: the "gemm" one-hot would take
    3.4 GB here) on chip_smoke.py's [14] problem, examples/bench_gba.py's
    default size (chip_smoke.gba_bench_problem), with solve_global_ba's
    schedule (10 LM iterations, 50 CG): the robust cost over all edges
    before and after. The source of chip_smoke.py's JAX_CPU_GBA. About
    5-10 min and 3 GB on the CPU."""
    import jax.numpy as jnp
    from orb_slam2_detailed_comments_tpu.geometry.camera import PinholeCamera
    from orb_slam2_detailed_comments_tpu.optim import global_ba as JG
    from orb_slam2_detailed_comments_tpu.optim.global_ba_grouped import (
        global_bundle_adjustment_grouped)
    from orb_slam2_detailed_comments_tpu.optim.local_ba import BAProblem
    import chip_smoke

    d = chip_smoke.gba_bench_problem(**chip_smoke.GBA_BENCH)
    prob = BAProblem(**{k: jnp.asarray(v) for k, v in d.items()})
    cam = PinholeCamera(**chip_smoke.GBA_CAM)
    inv_s2 = jnp.asarray(chip_smoke.GBA_INV_S2)
    cam_params = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)

    def cost(cams, pts):
        return float(JG._robust_cost(cams, pts, prob, prob.edge_valid, cam_params, inv_s2, True))

    c0 = cost(prob.cam_Tcw, prob.points)
    cams, pts, _ = global_bundle_adjustment_grouped(prob, cam, inv_s2, n_iters=10, cg_iters=50,
                                                    damping=1e-5, backend="gather")
    return dict(edges=int(d["edge_cam"].size), cost_before=c0, cost_after=cost(cams, pts))


def jax_entry_anchor():
    """The JAX package's __graft_entry__.entry() (the fused monocular frame
    on example_tracking_args' noise image and random local map) run once in
    the exact modes: the valid keypoints, the matched map points (a slot
    and an inlier), the two stages' inlier counts, the visible map points
    and the pose, as numpy. The source of chip_smoke.py's JAX_CPU_ENTRY and
    of tests/test_torch_graft_entry.py's reference. About 40 s."""
    import numpy as np
    import __graft_entry__ as G
    from orb_slam2_detailed_comments_tpu.models.slam_step import unpack_host_blob
    with jax_exact_modes():
        fn, args = G.entry()
        blob, desc = fn(*args)
    b, ts, vis = (np.asarray(a) for a in unpack_host_blob(np.asarray(blob), desc.shape[0]))
    return dict(keypoints=int(b[:, 7].sum()), matched=int(((b[:, 8] >= 0) & (b[:, 9] > 0)).sum()),
                n_in=int(ts[16]), n_in1=int(ts[20]), visible=int(vis.sum()),
                Tcw=ts[:16].reshape(4, 4).tolist())


def _xla_levels():
    """Make the port's predict_scale_level take its log from XLA on the CPU
    (the JAX package's), to show which differences its ties make
    (ROADMAP.md C.8). For replay_local_mapper only; never undone."""
    import jax
    import jax.numpy as jnp
    import torch
    from orb_slam2_detailed_comments_tpu_torch.ops import matching as TM

    xla_log = jax.jit(jnp.log)

    def predict_scale_level(dist, max_dist, n_levels, log_scale):
        ratio = torch.clamp(max_dist / torch.clamp(dist, min=1e-9), min=1e-9)
        lg = torch.from_numpy(np.array(xla_log(ratio.cpu().numpy()))).to(ratio.device)
        return torch.clamp(torch.ceil(lg / log_scale).to(torch.int32), 0, n_levels - 1)

    TM.predict_scale_level = predict_scale_level


def _ba_spread(port_ms, jax_ms, tcfg, jm, recent, kf, start, jax_start):
    """How far apart a local BA's results lie: the port's against the JAX
    package's (median point distance, largest keyframe-centre distance);
    then, as the scale of float rounding alone, each package's against its
    own from the same state with every point moved by one float32 ulp, and
    the port's against its own with the window's edges in another order
    (largest and median point distance). `start` and `jax_start` are the
    two packages' states before the stage."""
    import torch
    from orb_slam2_detailed_comments_tpu.backend.local_mapping import LocalMapper as JaxMapper
    from orb_slam2_detailed_comments_tpu_torch.backend.local_mapping import LocalMapper

    def dist(a, b):
        live = a.mp_valid & b.mp_valid
        d = np.linalg.norm(a.mp_pos[live] - b.mp_pos[live], axis=1)
        return f"largest {d.max():.1e}, median {np.median(d):.1e}"

    def nudged(ms):
        ms.mp_pos = np.nextafter(ms.mp_pos, np.float32(np.inf)).astype(np.float32)
        return ms

    def port_ba(ms, permute=False):
        port = LocalMapper(tcfg, ms, monocular=jm.monocular, device="cpu")
        port.recent_points = list(recent)
        build = port._build_local_ba

        def permuted_build(k):
            built = build(k)
            E = built["E"]
            perm = np.random.default_rng(0).permutation(E)
            tp = torch.from_numpy(perm)
            prob = built["prob"]
            built["prob"] = prob._replace(**{
                f: torch.cat([getattr(prob, f)[:E][tp], getattr(prob, f)[E:]])
                for f in ("edge_cam", "edge_point", "edge_obs", "edge_octave", "edge_valid")})
            built["e_cam"], built["e_pt"] = built["e_cam"][perm], built["e_pt"][perm]
            return built
        if permute:
            port._build_local_ba = permuted_build
        port.local_ba(kf)
        return port.map

    jax_nudged = JaxMapper(jm.config, nudged(jax_start), monocular=jm.monocular)
    jax_nudged.recent_points = list(recent)
    jax_nudged.local_ba(kf)
    kfs = np.nonzero(port_ms.kf_valid & jax_ms.kf_valid)[0]

    def centres(ms):
        T = ms.kf_Tcw[kfs].astype(np.float64)
        return -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])
    dc = np.linalg.norm(centres(port_ms) - centres(jax_ms), axis=1)
    return (f"port against JAX: {dist(port_ms, jax_ms)}, keyframe centres {dc.max():.1e}; "
            f"JAX against itself one ulp away: {dist(jax_nudged.map, jax_ms)}; the port "
            f"against itself one ulp away: {dist(port_ba(nudged(copy.deepcopy(start))), port_ms)}"
            f", with its edges permuted: {dist(port_ba(copy.deepcopy(start), True), port_ms)}")


def _replay_mapper(jm, first, last):
    """Make the JAX LocalMapper `jm` replay its on_new_keyframe calls
    first..last stage by stage through the port's LocalMapper on the CPU:
    each port stage starts from the JAX state before that stage and ends
    held against the JAX state after it. Prints, per call and stage, the
    map points live in one package only, the keypoint associations that
    differ and the largest point distance. Returns the count of calls."""
    from orb_slam2_detailed_comments_tpu_torch.backend.local_mapping import LocalMapper
    from orb_slam2_detailed_comments_tpu_torch.interop import (map_store_from_jax,
                                                               slam_config_from_jax)

    tcfg = slam_config_from_jax(jm.config)
    on_new_keyframe, n_call = jm.on_new_keyframe, [0]

    def replay(kf, run_ba=True):
        n_call[0] += 1
        if not first <= n_call[0] <= last:
            return on_new_keyframe(kf, run_ba)
        jm.kf_counter += 1
        fresh = jm.map.kf_mp[kf]
        fresh = fresh[fresh >= 0]
        jm.recent_points.extend(int(m) for m in fresh[jm.map.mp_first_kf[fresh] == kf])
        ba = run_ba and jm.map.n_keyframes() > 2
        stages = [("culling", "_map_point_culling"),
                  ("triangulation", "_create_new_map_points"),
                  ("fusion", "_search_in_neighbors")] + [("local BA", "local_ba")] * ba \
            + [("keyframe culling", "_keyframe_culling")]
        line = []
        for name, method in stages:
            before, recent = map_store_from_jax(jm.map), list(jm.recent_points)
            start = (copy.deepcopy(before), copy.deepcopy(jm.map)) if method == "local_ba" \
                else None
            getattr(jm, method)(kf)
            after = map_store_from_jax(jm.map)
            port = LocalMapper(tcfg, before, monocular=jm.monocular, device="cpu")
            port.recent_points = recent
            getattr(port, method)(kf)
            t = port.map
            live = t.mp_valid & after.mp_valid
            dx = np.linalg.norm(t.mp_pos[live] - after.mp_pos[live], axis=1)
            line.append(f"{name} {int((t.mp_valid != after.mp_valid).sum())}/"
                        f"{int((t.kf_mp != after.kf_mp).sum())}/"
                        f"{dx.max() if dx.size else 0.0:.1e}")
            if method == "local_ba" and dx.size:
                line[-1] += " (" + _ba_spread(t, after, tcfg, jm, recent, kf, *start) + ")"
        print(f"call {n_call[0]} (keyframe {kf}), points live in one package only/"
              f"associations that differ/largest point distance (m): " + "; ".join(line),
              flush=True)
        if jm.loop_closer is not None:
            jm.loop_closer.on_new_keyframe(kf)

    jm.on_new_keyframe = replay
    return n_call


def replay_local_mapper(sensor, first=1, last=12, xla_levels=False):
    """The JAX package's System on chip_smoke.py's System phase for
    `sensor` (as jax_system_anchor), with its LocalMapper calls first..last
    replayed through the port's (_replay_mapper). With `xla_levels` the
    port predicts scale levels with XLA's log (_xla_levels). About 3 min
    and 3 GB on the CPU."""
    from orb_slam2_detailed_comments_tpu.system import System

    if xla_levels:
        _xla_levels()
    chip_smoke, poses, frames, cfg, sensor_enum = _sequence(sensor)
    entry = {"stereo": "track_stereo", "rgbd": "track_rgbd", "mono": "track_monocular"}[sensor]
    with _jax_fused_exact():
        slam = System(cfg, sensor_enum, enable_loop_closing=False)
        n_call = _replay_mapper(slam.local_mapper, first, last)
        for i, args in enumerate(frames):
            getattr(slam, entry)(*args, i / chip_smoke.TRACK_SEQS[sensor]["fps"])
            if n_call[0] >= last:
                break


def _circuit_trace_module():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / "circuit_trace.py"
    spec = importlib.util.spec_from_file_location("circuit_trace", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_circuit_trace(argv):
    """The JAX package's examples/kitti_class_benchmark.py run() on the CPU,
    with the fused path on in the exact modes and the tracker's stage lines
    on (ORB_TRACK_DEBUG), traced frame by frame into `--out` by
    tools/circuit_trace.py's tracer: the JAX side of `circuit_trace.py
    --compare`. Takes circuit_trace.py's run arguments (--frames ...
    --out FILE --stop-after N --noise SEED); every
    DeviceKeyframeStore._grow (ROADMAP.md known fault 1) is an event of
    its frame, with the keyframes whose rows it renumbered. With --replay
    FIRST LAST the mapper's calls FIRST..LAST are replayed stage by stage
    through the port's (_replay_mapper) and the run stops after them;
    with --xla-levels the port predicts scale levels with XLA's log there.
    Returns the run's result dict (None when stopped). Run (a) took 3.4 h
    to frame 816 on a shared 8-core CPU."""
    import argparse
    import importlib.util
    from pathlib import Path
    import jax
    from orb_slam2_detailed_comments_tpu import system as JS
    from orb_slam2_detailed_comments_tpu.backend import device_kf as JDK
    from orb_slam2_detailed_comments_tpu.frontend import tracking as JT

    ct = _circuit_trace_module()
    ap = argparse.ArgumentParser()
    ct.add_run_arguments(ap)
    ap.add_argument("--replay", nargs=2, type=int, metavar=("FIRST", "LAST"),
                    help="replay the mapper's calls FIRST..LAST through the port's "
                         "(_replay_mapper) and stop after them")
    ap.add_argument("--xla-levels", action="store_true",
                    help="the port's replayed stages predict scale levels with XLA's log")
    args = ap.parse_args(argv)
    if args.xla_levels:
        _xla_levels()
    path = Path(__file__).resolve().parents[1] / "examples" / "kitti_class_benchmark.py"
    spec = importlib.util.spec_from_file_location("jax_kitti_class_benchmark", path)
    driver = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(driver)
    meta = dict(vars(args), package="orb_slam2_detailed_comments_tpu", jax=jax.__version__,
                numpy=np.__version__)
    tracer = ct.CircuitTracer(args.out, args.stop_after, args.noise,
                              _chip_smoke().PERTURB_GREY, meta)
    grow = JDK.DeviceKeyframeStore._grow

    def traced_grow(store, ms):
        old, cap = dict(store.kf_row), store.C
        grow(store, ms)
        moved = {k: (r, store.kf_row.get(k, -1)) for k, r in old.items()
                 if store.kf_row.get(k, -1) != r}
        tracer.event(f"_grow: capacity {cap} -> {store.C}, {len(old)} rows -> "
                     f"{len(store.kf_row)}; keyframe: (old row, new row) {moved}")

    dbg, result, init = JT._DBG, None, JS.System.__init__

    def replaying_init(slam, *a, **k):
        init(slam, *a, **k)
        first, last = args.replay
        n_call = _replay_mapper(slam.local_mapper, first, last)
        replay = slam.local_mapper.on_new_keyframe

        def stop_after_last(kf, run_ba=True):
            replay(kf, run_ba)
            if n_call[0] >= last:
                raise ct.StopTrace
        slam.local_mapper.on_new_keyframe = stop_after_last

    JT._DBG, JDK.DeviceKeyframeStore._grow = True, traced_grow
    if args.replay:
        JS.System.__init__ = replaying_init
    try:
        with _jax_fused_exact(), tracer.patch(JS.System):
            result = driver.run(**ct.run_kwargs(args))
    except ct.StopTrace:
        pass
    finally:
        JT._DBG, JDK.DeviceKeyframeStore._grow, JS.System.__init__ = dbg, grow, init
        tracer.close(result)
    return result


def solve_ba_problem(path):
    """A local-BA problem saved by tools/circuit_trace.py --dump-ba, solved
    again by the JAX package's local_bundle_adjustment and by the port's,
    both on the CPU, beside the result the run merged: for the window's
    free keyframes, the largest centre move from the start in each
    solution, the largest centre distance between the solutions, and the
    edges each keeps as inliers."""
    import jax.numpy as jnp
    import torch
    from orb_slam2_detailed_comments_tpu.geometry.camera import PinholeCamera as JaxCamera
    from orb_slam2_detailed_comments_tpu.optim import local_ba as JB
    from orb_slam2_detailed_comments_tpu_torch.geometry.camera import PinholeCamera
    from orb_slam2_detailed_comments_tpu_torch.optim import local_ba as TB

    d = np.load(path)
    fields = {k[len("prob_"):]: d[k] for k in d.files if k.startswith("prob_")}
    fx, fy, cx, cy, bf, w, h = d["camera"]
    cam_kw = dict(fx=fx, fy=fy, cx=cx, cy=cy, bf=bf, width=int(w), height=int(h))
    jax_out = JB.local_bundle_adjustment(
        JB.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()}), JaxCamera(**cam_kw),
        jnp.asarray(d["inv_sigma2"]))
    port_out = TB.local_bundle_adjustment(
        TB.BAProblem(**{k: torch.from_numpy(v) for k, v in fields.items()}),
        PinholeCamera(**cam_kw), torch.from_numpy(d["inv_sigma2"]))
    free = np.nonzero(d["cam_free"][:len(d["cams"])])[0]

    def centres(T):
        T = np.asarray(T, np.float64)[free]
        return -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])
    c0 = centres(fields["cam_Tcw"])
    sols = {"the run": (d["new_cams"], d["inlier"]),
            "JAX (CPU)": tuple(np.asarray(a) for a in (jax_out[0], jax_out[2])),
            "port (CPU)": tuple(a.numpy() for a in (port_out[0], port_out[2]))}
    E = int(d["E"])
    line = [f"{path}: {len(d['cams'])} cameras ({free.size} free), {E} edges"]
    for name, (cams, inl) in sols.items():
        move = np.linalg.norm(centres(cams) - c0, axis=1)
        line.append(f"{name}: largest keyframe move {move.max():.4f} m (keyframe "
                    f"{int(d['cams'][free[np.argmax(move)]])}), inliers {int(inl[:E].sum())}")
    for a, b in (("JAX (CPU)", "the run"), ("JAX (CPU)", "port (CPU)")):
        dist = np.linalg.norm(centres(sols[a][0]) - centres(sols[b][0]), axis=1)
        line.append(f"{a} against {b}: keyframe centres up to {dist.max():.4f} m apart")
    return "\n  ".join(line)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python tests/torch_parity.py [tracker|system] [sensor ...]
    #     [staged|noise<seed> ...]:
    # print the anchors of chip_smoke.py's tracker phases or System phases,
    # or with perturbations (System only) the System phase under each;
    # JAX_PLATFORMS=cpu python tests/torch_parity.py replay SENSOR [FIRST LAST]
    #     [xla-levels]: replay_local_mapper
    # JAX_PLATFORMS=cpu python tests/torch_parity.py gba: jax_gba_anchor
    # JAX_PLATFORMS=cpu python tests/torch_parity.py entry: jax_entry_anchor
    # JAX_PLATFORMS=cpu python tests/torch_parity.py loop [noise<seed>|clean ...]:
    #     jax_loop_anchor (the lap, or the lap under each perturbation)
    # JAX_PLATFORMS=cpu python tests/torch_parity.py loop_map: jax_loop_map_anchor
    # JAX_PLATFORMS=cpu python tests/torch_parity.py run_slam [NAME ...] [noise<seed> ...]:
    #     jax_run_slam_anchor (chip_smoke.py [20]'s sequences, or each under
    #     each perturbation)
    # JAX_PLATFORMS=cpu python tests/torch_parity.py circuit_trace --out FILE [--frames N ...]
    #     [--replay FIRST LAST [--xla-levels]]: jax_circuit_trace; the last line is the
    #     run's result dict
    # JAX_PLATFORMS=cpu python tests/torch_parity.py port_circuit_trace --out FILE [...]:
    #     the port's tools/circuit_trace.py on the CPU with XLA's log levels
    # JAX_PLATFORMS=cpu python tests/torch_parity.py ba_problem FILE ...: solve_ba_problem
    import json
    import sys
    from pathlib import Path
    import jax
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    jax.config.update("jax_platforms", "cpu")
    args = sys.argv[1:]
    if args[:1] == ["circuit_trace"]:
        print(json.dumps(jax_circuit_trace(args[1:])), flush=True)
        sys.exit(0)
    if args[:1] == ["ba_problem"]:
        for path in args[1:]:
            print(solve_ba_problem(path), flush=True)
        sys.exit(0)
    if args[:1] == ["port_circuit_trace"]:
        # the port's circuit_trace.py run on the CPU with its scale levels
        # predicted by XLA's log (_xla_levels, ROADMAP.md known fault 8)
        _xla_levels()
        sys.exit(_circuit_trace_module().main([*args[1:], "--device", "cpu"]))
    if args[:1] == ["run_slam"]:
        perturbs = [a for a in args[1:] if a.startswith("noise")]
        for name in [a for a in args[1:] if a not in perturbs] or ["kitti-stereo", "kitti-mono",
                                                                  "tum-rgbd"]:
            for p in perturbs or [None]:
                print("run_slam", name, *([p] if p else []), jax_run_slam_anchor(name, p),
                      f"jax {jax.__version__}", flush=True)
        sys.exit(0)
    if args[:1] == ["loop"]:
        for p in args[1:] or [None]:
            print("loop", *([p] if p else []), jax_loop_anchor(p), f"jax {jax.__version__}",
                  flush=True)
        sys.exit(0)
    if args[:1] == ["loop_map"]:
        print("loop_map", jax_loop_map_anchor(), f"jax {jax.__version__}", flush=True)
        sys.exit(0)
    if args[:1] == ["entry"]:
        print("entry", jax_entry_anchor(), f"jax {jax.__version__}", flush=True)
        sys.exit(0)
    if args[:1] == ["gba"]:
        print(jax_gba_anchor(), f"jax {jax.__version__}", flush=True)
        sys.exit(0)
    if args[:1] == ["replay"]:
        replay_local_mapper(args[1], *(int(a) for a in args[2:] if a.isdigit()),
                            xla_levels="xla-levels" in args)
        sys.exit(0)
    system = args[:1] == ["system"]
    args = [a for a in args if a not in ("tracker", "system")]
    perturbs = [a for a in args if a == "staged" or a.startswith("noise")]
    sensors = [a for a in args if a not in perturbs] or ["stereo", "rgbd", "mono"]
    for s in sensors:
        for p in perturbs or [None]:
            res = jax_system_anchor(s, p) if system else jax_tracker_anchor(s)
            print(s, *([p] if p else []), res, f"jax {jax.__version__}", flush=True)
