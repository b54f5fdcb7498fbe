"""The port's example drivers (orb_slam2_detailed_comments_tpu_torch/examples)
on disk sequences, on the CPU (--device cpu), at 320x240.

  * the slice as a whole: the port's run_slam tum-rgbd and the JAX
    package's examples/run_slam.py on one directory (RGB colour PNGs,
    16-bit depth 4 ms after them, ground truth), both with System at the
    settings file's defaults (loop closing on): frames tracked equal, live
    keyframes within KF_TOL, map points within MP_RTOL, the drivers'
    ground-truth ATE within ATE_RTOL or ATE_ATOL_M (System's limits);
  * stereo_kitti and mono_tum once each: exit 0 and their trajectory
    files (stereo tracks every frame);
  * run_slam euroc-stereo rectifies the raw pairs with the settings'
    LEFT./RIGHT. calibration, where the JAX driver feeds them unrectified
    (ROADMAP.md C.20), with a stand-in System recording the frames;
  * train_vocabulary on 3 frames: the DBoW2 text it writes loads back
    through the drivers' vocabulary route with every image's bag unchanged,
    and each image retrieves itself first;
  * every entry point refuses to run without a CUDA device unless given
    --device cpu; importing run_slam loads neither jax nor PIL; the drivers
    run as modules and as script paths.

The torch threads are cut to TORCH_THREADS for these tests (restored
after): beside other test processes, more threads only contend.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from orb_slam2_detailed_comments_tpu.io import datasets as JD

from orb_slam2_detailed_comments_tpu_torch.examples import _driver, run_slam
from orb_slam2_detailed_comments_tpu_torch.io.png import write_png
from orb_slam2_detailed_comments_tpu_torch.ops.rectify import StereoRectifier
from orb_slam2_detailed_comments_tpu_torch.utils.config import load_settings_raw

from synthetic_world import PlanesWorld, smooth_trajectory
from test_rectify import EUROC_SNIPPET
from torch_parity import jax_run_slam

REPO = Path(__file__).resolve().parents[1]
KF_TOL, MP_RTOL, ATE_RTOL, ATE_ATOL_M = 1, 0.05, 0.10, 0.002
N_FRAMES = 4
TORCH_THREADS = 2
SETTINGS = """%YAML:1.0
Camera.fx: 250.0
Camera.fy: 250.0
Camera.cx: 160.0
Camera.cy: 120.0
Camera.width: 320
Camera.height: 240
Camera.fps: 10.0
Camera.bf: 25.0
Camera.RGB: 1
ThDepth: 120.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 500
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, TORCH_THREADS))
    yield
    torch.set_num_threads(n)


def _world(seed):
    return PlanesWorld(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240,
                       texture_seed=seed)


def _u8(img, rng):
    """A render with +-2 grey levels of seeded sensor noise, as uint8."""
    return np.clip(np.rint(img + rng.uniform(-2, 2, img.shape)), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def tum_seq(tmp_path_factory):
    """A TUM RGB-D directory written with the port's PNG writer: colour
    frames as RGB (channels offset, so the grey conversion has work to do),
    16-bit depth x5000 stamped 4 ms later, ground truth stamped 2 ms later."""
    root = tmp_path_factory.mktemp("tum_seq")
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    world, rng = _world(7), np.random.default_rng(0)
    rgb, depth, gt = [], [], []
    for i, T in enumerate(smooth_trajectory(N_FRAMES, step=0.05)):
        ts, td = 10.0 + 0.1 * i, 10.004 + 0.1 * i
        g = _u8(world.render(T), rng).astype(np.int32)[..., None] + np.array([6, 0, -15])
        write_png(str(root / "rgb" / f"{ts:.6f}.png"), np.clip(g, 0, 255).astype(np.uint8))
        write_png(str(root / "depth" / f"{td:.6f}.png"),
                  np.rint(world.render_depth(T) * 5000.0).astype(np.uint16))
        rgb.append(f"{ts:.6f} rgb/{ts:.6f}.png\n")
        depth.append(f"{td:.6f} depth/{td:.6f}.png\n")
        c = np.linalg.inv(T.astype(np.float64))[:3, 3]
        gt.append(f"{ts + 0.002:.6f} {c[0]:.7f} {c[1]:.7f} {c[2]:.7f} 0 0 0 1\n")
    (root / "rgb.txt").write_text("".join(rgb))
    (root / "depth.txt").write_text("".join(depth))
    (root / "groundtruth.txt").write_text("".join(gt))
    (root / "settings.yaml").write_text(SETTINGS)
    return root


def _trajectory_rows(path, n_cols):
    rows = [line.split() for line in Path(path).read_text().splitlines()]
    assert all(len(r) == n_cols for r in rows)
    np.asarray(rows, np.float64)      # every field parses
    return len(rows)


def test_run_slam_tum_rgbd_matches_jax(tum_seq, tmp_path):
    settings = str(tum_seq / "settings.yaml")
    port = run_slam.run(["tum-rgbd", settings, str(tum_seq), str(tmp_path / "port"),
                         "--device", "cpu"])
    ref = jax_run_slam("tum-rgbd", settings, str(tum_seq), str(tmp_path / "jax"))
    got = {k: port[k] for k in ("tracked", "keyframes", "map_points", "exported")}
    got["ate_m"] = port["gt"]["ate_rmse_m"]
    print("port", got, "jax", ref)
    assert got["tracked"] == ref["tracked"] == N_FRAMES
    assert abs(got["keyframes"] - ref["keyframes"]) <= KF_TOL
    assert abs(got["map_points"] - ref["map_points"]) <= MP_RTOL * ref["map_points"]
    assert abs(got["ate_m"] - ref["ate_m"]) <= max(ATE_RTOL * ref["ate_m"], ATE_ATOL_M)
    assert port["gt"]["n_pairs"] == got["exported"] == ref["exported"]
    assert _trajectory_rows(tmp_path / "port_tum.txt", 8) == got["exported"]
    assert _trajectory_rows(tmp_path / "port_kitti.txt", 12) == got["exported"]
    assert _trajectory_rows(tmp_path / "port_kf_tum.txt", 8) == got["keyframes"]


def test_mono_tum_driver(tum_seq, tmp_path, monkeypatch):
    from orb_slam2_detailed_comments_tpu_torch.examples import mono_tum
    monkeypatch.chdir(tmp_path)
    assert mono_tum.main(["-", str(tum_seq / "settings.yaml"), str(tum_seq),
                          "--device", "cpu"]) == 0
    # four frames of 5 cm sideways steps are too few for the two-view
    # initialization here: the files are written, perhaps empty
    for part in ("tum", "kitti", "kf_tum"):
        _trajectory_rows(tmp_path / f"KeyFrameTrajectory_{part}.txt", 12 if part == "kitti" else 8)


def test_stereo_kitti_driver(tmp_path, monkeypatch):
    from orb_slam2_detailed_comments_tpu_torch.examples import stereo_kitti
    seq = tmp_path / "seq"
    world, rng = _world(9), np.random.default_rng(1)
    shift = np.eye(4, dtype=np.float32)
    shift[0, 3] = -0.12
    for i, T in enumerate(smooth_trajectory(8, step=0.05)[:3]):
        for cam, pose in (("image_0", T), ("image_1", shift @ T)):
            (seq / cam).mkdir(parents=True, exist_ok=True)
            write_png(str(seq / cam / f"{i:06d}.png"), _u8(world.render(pose), rng))
    (seq / "times.txt").write_text("".join(f"{0.1 * i:.6e}\n" for i in range(3)))
    (seq / "settings.yaml").write_text(SETTINGS.replace("Camera.bf: 25.0", "Camera.bf: 30.0"))
    monkeypatch.chdir(tmp_path)
    assert stereo_kitti.main(["-", str(seq / "settings.yaml"), str(seq), "--device", "cpu"]) == 0
    assert _trajectory_rows(tmp_path / "CameraTrajectory_kitti.txt", 12) == 3


class _RecordingSystem:
    """A stand-in System that records the frames a driver feeds it."""
    fed = []

    def __init__(self):
        self.tracking_state = type("State", (), {"name": "OK"})()
        self.map = type("Map", (), {"n_keyframes": lambda s: 0, "n_map_points": lambda s: 0})()
        self.tracker = type("Tracker", (), {"trajectory": [], "last_frame": None})()

    @classmethod
    def from_settings_yaml(cls, *a, **k):
        return cls()

    def track_stereo(self, left, right, ts):
        self.fed.append((ts, left, right))

    def shutdown(self):
        pass

    def save_trajectory_tum(self, path):
        pass

    save_trajectory_kitti = save_keyframe_trajectory_tum = save_trajectory_tum


def test_run_slam_euroc_stereo_rectifies(tmp_path, monkeypatch):
    """C.20: the port's run_slam rectifies EuRoC's raw pairs when the settings
    carry the calibration (as stereo_euroc and the reference do); the JAX
    package's run_slam feeds them raw."""
    import importlib.util
    from orb_slam2_detailed_comments_tpu_torch import system as TS
    names = [str(1403636579763555584 + 50000000 * i) for i in range(2)]
    rng = np.random.default_rng(2)
    for cam in ("cam0", "cam1"):
        d = tmp_path / "mav0" / cam / "data"
        d.mkdir(parents=True)
        for n in names:
            write_png(str(d / f"{n}.png"), rng.integers(0, 256, (480, 752), dtype=np.uint8))
    settings = tmp_path / "euroc.yaml"
    settings.write_text(EUROC_SNIPPET)
    raw = [JD.EurocDataset(str(tmp_path), stereo=True)[i] for i in range(2)]
    rectify = StereoRectifier.from_settings(load_settings_raw(str(settings)))

    _RecordingSystem.fed = []
    monkeypatch.setattr(TS, "System", _RecordingSystem)
    run_slam.run(["euroc-stereo", str(settings), str(tmp_path), str(tmp_path / "port"),
                  "--device", "cpu"])
    port = list(_RecordingSystem.fed)

    spec = importlib.util.spec_from_file_location("jax_run_slam", REPO / "examples" / "run_slam.py")
    jax_driver = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_driver)
    _RecordingSystem.fed = []
    monkeypatch.setattr(jax_driver, "System", _RecordingSystem)
    monkeypatch.setattr(sys, "argv", ["run_slam.py", "euroc-stereo", str(settings),
                                      str(tmp_path), str(tmp_path / "jax")])
    jax_driver.main()
    jax = list(_RecordingSystem.fed)

    assert len(port) == len(jax) == 2
    for (ts, left, right), (jts, jl, jr), (rts, rl, rr) in zip(port, jax, raw):
        assert ts == jts == rts
        want = rectify(rl, rr)
        assert np.array_equal(left, want[0]) and np.array_equal(right, want[1])
        assert np.array_equal(jl, rl) and np.array_equal(jr, rr)     # unrectified
        assert not np.array_equal(left, rl)


def test_train_vocabulary_round_trip(tum_seq, tmp_path):
    """Three frames (the first three of four) through extract_orb, a k=10,
    L=2 tree saved as DBoW2 text and loaded back through the drivers'
    route."""
    from orb_slam2_detailed_comments_tpu_torch.examples import train_vocabulary
    from orb_slam2_detailed_comments_tpu_torch.place.vocabulary_tree import TreeVocabulary
    out = str(tmp_path / "voc.txt")
    argv = ["tum-rgbd", str(tum_seq), out, "--stride", "1", "--max-frames", "3",
            "--tree", "10", "2", "--features", "500", "--device", "cpu"]
    assert train_vocabulary.main(argv) == 0
    before, descs = train_vocabulary.run(argv)      # the same, deterministic
    assert len(descs) == 3 and all(len(d) > 100 for d in descs)
    assert np.array_equal(before.node_desc, TreeVocabulary.train(np.concatenate(descs), k=10,
                                                                 L=2).node_desc)
    after = _driver.load_vocabulary(out)
    assert isinstance(after, TreeVocabulary) and after.n_words == before.n_words
    bags = []
    for d in descs:
        valid = np.ones(len(d), bool)
        (w0, b0), (w1, b1) = before.transform(d, valid), after.transform(d, valid)
        # the same words; the text keeps 6 decimals of each word's weight
        assert np.array_equal(w0, w1) and np.allclose(b0, b1, rtol=1e-5, atol=1e-7)
        bags.append(b1)
    for i, b in enumerate(bags):
        scores = [after.score(b, other) for other in bags]
        assert int(np.argmax(scores)) == i


ENTRY_ARGS = {
    "run_slam": ["tum-rgbd", "s.yaml", "seq"], "mono_tum": ["-", "s.yaml", "seq"],
    "rgbd_tum": ["-", "s.yaml", "seq", "-"], "mono_kitti": ["-", "s.yaml", "seq"],
    "stereo_kitti": ["-", "s.yaml", "seq"], "mono_euroc": ["-", "s.yaml", "img", "t.txt"],
    "stereo_euroc": ["-", "s.yaml", "c0", "c1", "t.txt"], "ros_mono": ["-", "s.yaml"],
    "ros_rgbd": ["-", "s.yaml"], "ros_stereo": ["-", "s.yaml", "false"],
    "ros_mono_ar": ["-", "s.yaml", "ar"], "train_vocabulary": ["tum-rgbd", "seq", "v.npz"]}


@pytest.mark.parametrize("name", sorted(ENTRY_ARGS))
def test_entry_points_need_a_cuda_device(name, monkeypatch, tmp_path):
    import importlib
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    monkeypatch.chdir(tmp_path)
    main = importlib.import_module(f"orb_slam2_detailed_comments_tpu_torch.examples.{name}").main
    with pytest.raises(SystemExit, match="--device cpu"):
        main(ENTRY_ARGS[name])


def test_run_slam_imports_no_jax_and_runs_as_module_or_script():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    code = ("import sys, orb_slam2_detailed_comments_tpu_torch.examples.run_slam; "
            "print([m for m in ('jax', 'PIL', 'matplotlib', 'orb_slam2_detailed_comments_tpu') "
            "if m in sys.modules])")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"
    # as a module from the repository root; as a script path from elsewhere
    for cwd, cmd in ((REPO, ["-m", "orb_slam2_detailed_comments_tpu_torch.examples.run_slam"]),
                     (REPO.parent, [str(REPO / "orb_slam2_detailed_comments_tpu_torch"
                                        / "examples" / "train_vocabulary.py")])):
        out = subprocess.run([sys.executable, *cmd, "--help"], cwd=str(cwd), capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0 and "--device" in out.stdout, out.stderr
