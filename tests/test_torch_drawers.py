"""The port's map and trajectory drawers (viz/drawers.py) draw in numpy and
write through io/png.py, with no plotting library: a divergence on purpose
from the JAX package, whose MapDrawer and TrajectoryPlotter draw with
matplotlib (a card's host may have none). The pictures differ from the
JAX package's; what is pinned here is what they show.

With matplotlib blocked in sys.modules (an import of it raises):
  * MapDrawer.render on a seeded map (keyframes on an arc, points around
    them, a spanning tree and one loop edge) writes a PNG that io/png.py
    reads back equal to the picture render returns; every keyframe centre
    is a keyframe-blue pixel at its projected pixel (MapDrawer.projector,
    matplotlib's view at elev -75, azim -90 over the unit-cube box), the
    points are drawn grey at theirs, and the tree and loop edges green and
    red;
  * TrajectoryPlotter.plot of an estimate and a ground truth writes a PNG
    read back equal, the estimate blue at its projected x-z pixels;
  * the streaming viewer writes map.png.
"""
import sys

import numpy as np
import pytest

from orb_slam2_detailed_comments_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_detailed_comments_tpu_torch.io.png import read_png
from orb_slam2_detailed_comments_tpu_torch.state.map_store import MapStore
from orb_slam2_detailed_comments_tpu_torch.utils.config import OrbConfig, SlamConfig
from orb_slam2_detailed_comments_tpu_torch.viz import drawers as D

N_KFS, N_PTS = 9, 400


@pytest.fixture(autouse=True)
def no_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(ImportError):
        import matplotlib  # noqa: F401


def _cfg():
    return SlamConfig(camera=PinholeCamera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320,
                                           height=240),
                      orb=OrbConfig(n_features=100, max_keypoints=128), fps=10.0,
                      max_keyframes=32, max_map_points=1000)


def _map():
    ms = MapStore(_cfg())
    rng = np.random.default_rng(0)
    for k in range(N_KFS):
        a = 0.25 * k
        C = np.array([4 * np.sin(a), 0.1 * k, 4 * (1 - np.cos(a))])
        R = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]])
        T = np.eye(4, dtype=np.float32)
        T[:3, :3], T[:3, 3] = R, -R @ C
        k_ = ms.n_kf
        ms.n_kf += 1
        ms.kf_valid[k_] = True
        ms.kf_Tcw[k_] = T
        if k:
            ms.parent[k_] = k_ - 1
    for p in rng.uniform([-6, -2, -2], [6, 2, 10], (N_PTS, 3)):
        ms.add_map_point(p.astype(np.float32), 0)
    ms.add_loop_edge(0, N_KFS - 1)
    return ms


def _colour_at(rgb, px):
    x, y = np.rint(px).astype(int)
    return tuple(int(c) for c in rgb[y, x])


def test_map_drawer_writes_png_with_keyframes_at_their_pixels(tmp_path):
    ms = _map()
    drawer = D.MapDrawer(ms)
    path = drawer.render(str(tmp_path / "map.png"))
    rgb = read_png(path)
    assert rgb.shape == (D.MAP_SIZE[1], D.MAP_SIZE[0], 3)
    assert np.array_equal(rgb, drawer.render())
    proj = drawer.projector()
    centres = proj(np.stack([ms.kf_camera_center(k) for k in ms.keyframe_ids()]))
    assert (centres >= D.MARGIN - 1).all() and (centres[:, 0] <= D.MAP_SIZE[0] - D.MARGIN + 1).all()
    assert all(_colour_at(rgb, c) == D.KF_RGB for c in centres)
    colours = {tuple(c) for c in rgb.reshape(-1, 3)}
    assert {D.POINT_RGB, D.TREE_RGB, D.LOOP_RGB, D.KF_RGB} <= colours
    pts = proj(ms.mp_pos[ms.mp_valid])
    hit = [_colour_at(rgb, p) in (D.POINT_RGB, D.KF_RGB, D.TREE_RGB, D.LOOP_RGB) for p in pts]
    assert np.mean(hit) > 0.95
    # another view moves the keyframes
    other = drawer.projector(elev=20.0, azim=30.0)(np.stack(
        [ms.kf_camera_center(k) for k in ms.keyframe_ids()]))
    assert np.abs(other - centres).max() > 10


def test_trajectory_plotter_writes_png(tmp_path):
    t = np.linspace(0, 2 * np.pi, 60)
    gt = np.stack([5 * np.sin(t), np.zeros_like(t), 5 * (1 - np.cos(t))], -1)
    est = gt + np.random.default_rng(1).normal(0, 0.05, gt.shape)
    path = D.TrajectoryPlotter.plot(est, gt, path=str(tmp_path / "traj.png"))
    rgb = read_png(path)
    assert rgb.shape == (D.PLOT_SIZE[1], D.PLOT_SIZE[0], 3)
    assert np.array_equal(rgb, D.TrajectoryPlotter.plot(est, gt))
    proj = D.TrajectoryPlotter.projector(est, gt)
    assert all(_colour_at(rgb, p) == D.EST_RGB for p in proj(est))
    assert (rgb == np.array(D.GT_RGB, np.uint8)).all(-1).sum() > 100


def test_streaming_viewer_writes_the_map_without_matplotlib(tmp_path):
    from orb_slam2_detailed_comments_tpu_torch.frontend.tracking import Sensor
    from orb_slam2_detailed_comments_tpu_torch.system import System
    from orb_slam2_detailed_comments_tpu_torch.viz.stream import StreamingViewer
    slam = System(_cfg(), Sensor.MONOCULAR, enable_loop_closing=False, device="cpu")
    slam.map = _map()
    viewer = StreamingViewer(slam, str(tmp_path), period_s=1000.0)
    img = np.random.default_rng(2).uniform(0, 255, (240, 320)).astype(np.float32)
    assert viewer.update(img, None, force=True)
    assert read_png(str(tmp_path / "map.png")).shape == (D.MAP_SIZE[1], D.MAP_SIZE[0], 3)
