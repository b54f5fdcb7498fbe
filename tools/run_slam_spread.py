#!/usr/bin/env python3
"""chip_smoke.py [20]'s run_slam runs under imperceptible image noise: how
far the driver's counts and ground-truth ATE move when nothing of
substance does.

    python3 tools/run_slam_spread.py [NAME ...] [--seeds 1 2 3 4] [--device cuda]
                                     [--tum-world near|far] [--save DIR]
                                     [--stable-depth-sort]
    python3 tools/run_slam_spread.py --compare DIR_A DIR_B

For each NAME of chip_smoke.DATASET_SEQS (default: all three) it writes the
sequence once (chip_smoke.write_dataset), runs the port's
examples/run_slam.py on it twice as it is (the two must agree) and once per
seed with +-chip_smoke.PERTURB_GREY grey levels of seeded uniform noise on
every image the loader returns, and prints frames tracked, keyframes, map
points, frames exported and the ATE of each run. `python
tests/torch_parity.py run_slam NAME noise<seed> ...` reads the JAX package
under the same noise. About 20 s a run on the card (minutes on a CPU);
on a card it prints the card's name and power limit first.

--tum-world far renders tum-rgbd in [11]'s world (PlanesWorld's planes
6-10 m away, 48 texture px a unit, 5 cm a frame) instead of
chip_smoke.TUM_WORLD, through the same lens. --save DIR keeps each run's
live poses as DIR/<name>_<run>_live.txt: per frame, the tracker's Tcw
(3x4, row-major) just after the frame, then the live keyframes and map
points; and, of the runs as written, DIR/<name>_<run>_stages.npz: per
frame, the frame's keypoints (position, octave, valid), descriptors and
map-point associations after tracking, and the map's live points and
their positions. --compare reads two such directories (say, one run on
the card and one on the CPU) and prints, for each run in both, the
per-frame distance between the two camera centres and the keyframe counts
side by side (a divergence that starts at float rounding and grows is
chaos; one that starts large on one frame is a fault), then, stage by
stage, where the two runs first part: the keypoints (the valid set, their
largest position difference), the descriptors, the associations, the
map's live points and their largest position difference.

--stable-depth-sort makes the tracker's nearest-first order of a
keyframe's new points (frontend/tracking.py::_create_new_keyframe, an
np.argsort over depths that tie when they are quantized) a stable sort,
so that two machines whose numpy builds order ties apart (ROADMAP.md C.23,
known fault 10) break them alike. The port itself keeps numpy's default.
"""
from __future__ import annotations

import argparse
import importlib.util
import sys
import tempfile
import types
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _centres(rows):
    """Camera centres -R^T t of (N, 14) live rows."""
    T = rows[:, :12].reshape(-1, 3, 4)
    return -np.einsum("nji,nj->ni", T[:, :, :3], T[:, :, 3])


def compare(dir_a: str, dir_b: str) -> int:
    names = sorted({p.name for p in Path(dir_a).glob("*_live.txt")}
                   & {p.name for p in Path(dir_b).glob("*_live.txt")})
    for name in names:
        a, b = (np.loadtxt(Path(d) / name, ndmin=2) for d in (dir_a, dir_b))
        n = min(len(a), len(b))
        mm = 1e3 * np.linalg.norm(_centres(a[:n]) - _centres(b[:n]), axis=1)
        print(f"compare {name}: camera centre {dir_a} - {dir_b}, mm per frame:",
              " ".join(f"{v:.6f}" for v in mm))
        print(f"compare {name}: keyframes per frame", a[:n, 12].astype(int).tolist(),
              "against", b[:n, 12].astype(int).tolist())
    for name in sorted({p.name for p in Path(dir_a).glob("*_stages.npz")}
                       & {p.name for p in Path(dir_b).glob("*_stages.npz")}):
        compare_stages(name, *(np.load(Path(d) / name) for d in (dir_a, dir_b)))
    return 0


def compare_stages(name, a, b):
    """Per frame, how the stages of two runs differ (see the docstring)."""
    rows = []
    for f in range(min(len(a["valid"]), len(b["valid"]))):
        va, vb = a["valid"][f], b["valid"][f]
        both = va & vb
        dxy = float(np.abs(a["xy"][f][both] - b["xy"][f][both]).max(initial=0.0))
        same_oct = bool((a["octave"][f][both] == b["octave"][f][both]).all())
        desc = float((a["desc"][f][both] == b["desc"][f][both]).all(axis=1).mean()) \
            if both.any() else 1.0
        mp = int((a["mp"][f][both] != b["mp"][f][both]).sum())
        la, lb = a["mp_valid"][f], b["mp_valid"][f]
        lboth = la & lb
        dpos = float(np.abs(a["mp_pos"][f][lboth] - b["mp_pos"][f][lboth]).max(initial=0.0))
        rows.append((f, int((va != vb).sum()), dxy, same_oct, desc, mp,
                     int((la != lb).sum()), dpos))
        print(f"stages {name} frame {f}: keypoints valid in one only {rows[-1][1]}, largest "
              f"position difference {dxy:.3g} px, octaves equal {same_oct}, descriptors "
              f"equal {desc:.4f}, associations differing {mp}; map points live in one only "
              f"{rows[-1][6]}, largest position difference {1e3 * dpos:.4g} mm")
    firsts = {
        "keypoint set": next((r[0] for r in rows if r[1] or not r[3]), None),
        "descriptors": next((r[0] for r in rows if r[4] < 1.0), None),
        "associations": next((r[0] for r in rows if r[5]), None),
        "live map points": next((r[0] for r in rows if r[6]), None)}
    print(f"stages {name}: first frame where the runs part, by stage: {firsts}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("names", nargs="*")
    ap.add_argument("--seeds", nargs="*", type=int, default=[1, 2, 3, 4])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tum-world", choices=("near", "far"), default="near")
    ap.add_argument("--save", metavar="DIR")
    ap.add_argument("--compare", nargs=2, metavar=("DIR_A", "DIR_B"))
    ap.add_argument("--stable-depth-sort", action="store_true")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    if args.stable_depth_sort:
        from orb_slam2_detailed_comments_tpu_torch.frontend import tracking

        class StableArgsortNumpy(types.ModuleType):
            """numpy, with argsort stable: tracking.py's only argsort is the
            keyframe's depth order."""
            def __getattr__(self, name):
                return getattr(np, name)

            @staticmethod
            def argsort(a, *args, **kw):
                return np.argsort(a, *args, **dict(kw, kind="stable"))

        tracking.np = StableArgsortNumpy("numpy")
    from orb_slam2_detailed_comments_tpu_torch.examples import _driver, run_slam
    from orb_slam2_detailed_comments_tpu_torch.interop import desc_to_numpy
    from orb_slam2_detailed_comments_tpu_torch.io import datasets

    C = _chip_smoke()
    if args.tum_world == "far":
        C.TUM_WORLD = dict(z_near=6.0, z_far=10.0, tex_scale=C.TRACK_SEQS["rgbd"]["tex_scale"],
                           step=C.SEQ_STEP)
    if args.device.startswith("cuda"):
        print(C._smi(), flush=True)     # the card's name and power limit
    if args.save:
        Path(args.save).mkdir(parents=True, exist_ok=True)
    load, track = datasets.load_image_gray, _driver.track
    live, stages = [], []

    def logged_track(slam, sensor, item):
        dt = track(slam, sensor, item)
        fr, ms = slam.tracker.last_frame, slam.map
        Tcw = fr.Tcw
        live.append(np.concatenate([
            np.full(12, np.nan) if Tcw is None else np.asarray(Tcw, np.float64)[:3, :4].ravel(),
            [slam.map.n_keyframes(), slam.map.n_map_points()]]))
        stages.append(dict(xy=fr.xy.copy(), octave=fr.octave.copy(), valid=fr.valid.copy(),
                           desc=fr.desc.copy() if isinstance(fr.desc, np.ndarray)
                           else desc_to_numpy(fr.desc), mp=fr.mp.copy(),
                           mp_valid=ms.mp_valid.copy(), mp_pos=ms.mp_pos.copy()))
        return dt

    with tempfile.TemporaryDirectory() as root:
        for name in args.names or list(C.DATASET_SEQS):
            settings, seq, _ = C.write_dataset(name, root)
            for i, seed in enumerate([None, None] + args.seeds):
                rng = np.random.default_rng(seed)
                tag = f"written{i}" if seed is None else f"noise{seed}"

                def noisy(path, rng=rng):
                    img = load(path)
                    return (img + rng.uniform(-C.PERTURB_GREY, C.PERTURB_GREY,
                                              img.shape)).astype(np.float32)

                datasets.load_image_gray = load if seed is None else noisy
                _driver.track = logged_track
                live.clear()
                stages.clear()
                try:
                    r = run_slam.run([name, settings, seq, str(Path(root) / "out"),
                                      "--device", args.device])
                finally:
                    datasets.load_image_gray, _driver.track = load, track
                if args.save:
                    np.savetxt(Path(args.save) / f"{name}_{tag}_live.txt", np.asarray(live),
                               fmt="%.9e")
                    if seed is None:
                        np.savez_compressed(Path(args.save) / f"{name}_{tag}_stages.npz", **{
                            k: np.stack([st[k] for st in stages]) for k in stages[0]})
                print("spread", name, "as written" if seed is None else tag,
                      {k: r[k] for k in ("tracked", "keyframes", "map_points", "exported")},
                      "ATE", None if r["gt"] is None else r["gt"]["ate_rmse_m"], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
