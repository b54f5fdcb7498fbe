"""The port's headless viewer and ROS layer against the JAX package's, on
the CPU.

  * viz/bitmap_font.py: the same pixels for the same text, clipped the
    same way at the borders.
  * viz/drawers.FrameDrawer: the same annotated image from the same
    keypoints; the port's FrameData as the tracker leaves it after a fused
    frame (descriptors a tensor) and with tensor fields, which it pulls.
  * viz/stream.StreamingViewer over both packages' System: the same
    frame.png pixels (the JAX package writes RGBA through matplotlib, the
    port RGB through io/png.py), the same status.json, a map.png from each
    (matplotlib), the same control-channel commands.
  * integrations/ros.py: message conversion (every encoding, padded rows,
    depth) equal to the JAX package's bit for bit; ApproximateTimeSynchronizer
    pairing the same messages on a jittered stream with drops;
    detect_plane and cube_vertices equal; the mono, stereo (rectifying),
    RGB-D and AR nodes over the port's System(device="cpu") with a fake
    rospy, as tests/test_ros_nodes.py drives the JAX package's.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
from PIL import Image

from orb_slam2_detailed_comments_tpu.integrations import ros as JR
from orb_slam2_detailed_comments_tpu.state.frame import FrameData as JFrame
from orb_slam2_detailed_comments_tpu.viz import bitmap_font as JF
from orb_slam2_detailed_comments_tpu.viz.drawers import FrameDrawer as JDrawer

from orb_slam2_detailed_comments_tpu_torch.frontend.tracking import Sensor, TrackingState
from orb_slam2_detailed_comments_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_detailed_comments_tpu_torch.integrations import ros as TR
from orb_slam2_detailed_comments_tpu_torch.io.png import read_png
from orb_slam2_detailed_comments_tpu_torch.state.frame import FrameData as TFrame
from orb_slam2_detailed_comments_tpu_torch.system import System
from orb_slam2_detailed_comments_tpu_torch.utils.config import OrbConfig, SlamConfig
from orb_slam2_detailed_comments_tpu_torch.viz import bitmap_font as TF
from orb_slam2_detailed_comments_tpu_torch.viz.drawers import FrameDrawer as TDrawer

from synthetic_world import PlanesWorld, smooth_trajectory
from test_ros_nodes import FakeRos, ImageMsg
from test_rectify import EUROC_SNIPPET

H, W = 240, 320
TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The nodes' System runs with TORCH_THREADS torch threads (restored
    after): beside other test processes, more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, TORCH_THREADS))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("text,x,y,scale", [("TRACKING KFS: 12 MPS: 3456", 2, 3, 1),
                                            ("lost (=_=) 99%", 250, 230, 2),
                                            ("~@[é", -4, -2, 1)])
def test_bitmap_font_matches_jax(text, x, y, scale):
    a, b = np.zeros((H, W, 3), np.uint8), np.zeros((H, W, 3), np.uint8)
    TF.draw_text(a, x, y, text, color=(10, 200, 30), scale=scale)
    JF.draw_text(b, x, y, text, color=(10, 200, 30), scale=scale)
    assert np.array_equal(a, b) and (a > 0).any()
    assert TF.text_width(text, scale) == JF.text_width(text, scale)


def _frame_arrays(seed, n=300):
    rng = np.random.default_rng(seed)
    valid = rng.random(n) < 0.8
    return dict(frame_id=3, timestamp=0.3,
                xy=rng.uniform(-5, [W + 5, H + 5], (n, 2)).astype(np.float32),
                response=rng.random(n).astype(np.float32),
                octave=rng.integers(0, 8, n).astype(np.int32),
                angle=rng.random(n).astype(np.float32),
                desc=rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32), valid=valid,
                ur=np.full(n, -1, np.float32), depth=np.full(n, -1, np.float32),
                mp=np.where(rng.random(n) < 0.5, rng.integers(0, 999, n), -1).astype(np.int32),
                is_outlier=rng.random(n) < 0.1)


def test_frame_drawer_matches_jax():
    img = np.random.default_rng(0).uniform(0, 255, (H, W)).astype(np.float32)
    arrays = _frame_arrays(1)
    want = JDrawer(None).draw(img, JFrame(**arrays), state_text="")
    for frame in (TFrame(**arrays),
                  # as a fused frame leaves it: descriptors (and here every
                  # array) still tensors
                  TFrame(**{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                            for k, v in arrays.items()})):
        got = TDrawer(None).draw(img, frame, state_text="")
        assert np.array_equal(got, want)
    assert np.array_equal(TDrawer(None).draw(img, None, "OK KFS: 1"),
                          JDrawer(None).draw(img, None, "OK KFS: 1"))


def _cfg():
    return SlamConfig(camera=PinholeCamera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=W,
                                           height=H, bf=250.0 * 0.1),
                      orb=OrbConfig(n_features=600, max_keypoints=1024), fps=10.0,
                      max_keyframes=100, max_map_points=30000, th_depth=40.0)


def _jax_cfg():
    from orb_slam2_detailed_comments_tpu.geometry.camera import PinholeCamera as JCam
    from orb_slam2_detailed_comments_tpu.utils.config import OrbConfig as JOrb
    from orb_slam2_detailed_comments_tpu.utils.config import SlamConfig as JSlam
    c = _cfg()
    return JSlam(camera=JCam(**c.camera._asdict()), orb=JOrb(**dataclasses.asdict(c.orb)),
                 fps=c.fps, max_keyframes=c.max_keyframes, max_map_points=c.max_map_points,
                 th_depth=c.th_depth)


def test_streaming_viewer_matches_jax(tmp_path):
    from orb_slam2_detailed_comments_tpu.frontend.tracking import Sensor as JSensor
    from orb_slam2_detailed_comments_tpu.system import System as JSystem
    from orb_slam2_detailed_comments_tpu.viz.stream import StreamingViewer as JViewer
    from orb_slam2_detailed_comments_tpu_torch.viz.stream import StreamingViewer as TViewer

    img = np.random.default_rng(2).uniform(0, 255, (H, W)).astype(np.float32)
    arrays = _frame_arrays(3)
    runs = {}
    for name, viewer_cls, slam, frame in (
            ("jax", JViewer, JSystem(_jax_cfg(), JSensor.MONOCULAR, enable_loop_closing=False),
             JFrame(**arrays)),
            ("torch", TViewer, System(_cfg(), Sensor.MONOCULAR, enable_loop_closing=False,
                                      device="cpu"), TFrame(**arrays))):
        out = tmp_path / name
        viewer = viewer_cls(slam, str(out), period_s=1000.0)
        (out / "control").write_text("localization_on\nbogus_cmd\n")
        assert viewer.update(img, frame, force=True)
        assert not viewer.update(img, frame)          # rate-limited
        runs[name] = (out, slam)
    (jo, js), (to, ts) = runs["jax"], runs["torch"]
    jax_rgb = np.asarray(Image.open(jo / "frame.png"))[..., :3]   # RGBA from matplotlib
    port_rgb = read_png(str(to / "frame.png"))
    assert port_rgb.shape == (H + 15, W, 3) and np.array_equal(port_rgb, jax_rgb)
    assert json.loads((to / "status.json").read_text()) == \
        json.loads((jo / "status.json").read_text())
    assert (to / "control.log").read_text() == (jo / "control.log").read_text()
    assert ts.tracker.localization_only and js.tracker.localization_only
    assert (to / "map.png").stat().st_size > 0 and (jo / "map.png").exists()


# ---------------------------------------------------------------------------
# ROS: message conversion, pairing and the AR geometry against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("enc,shape,dtype", [
    ("mono8", (7, 9), np.uint8), ("8UC1", (7, 9), np.uint8), ("mono16", (7, 9), np.uint16),
    ("16UC1", (7, 9), np.uint16), ("32FC1", (7, 9), np.float32), ("rgb8", (7, 9, 3), np.uint8),
    ("bgr8", (7, 9, 3), np.uint8), ("rgba8", (7, 9, 4), np.uint8),
    ("bgra8", (7, 9, 4), np.uint8)])
def test_message_conversion_matches_jax(enc, shape, dtype):
    rng = np.random.default_rng(4)
    a = (rng.uniform(0, 9, shape).astype(dtype) if dtype == np.float32
         else rng.integers(0, np.iinfo(dtype).max, shape, dtype=dtype, endpoint=True))
    for pad in (0, 6):
        msg = ImageMsg(a, enc, t=1.5, pad_step=pad * a.dtype.itemsize)
        assert np.array_equal(TR.image_msg_to_array(msg), JR.image_msg_to_array(msg))
        for rgb in (True, False):
            g = TR.image_msg_to_gray(msg, rgb=rgb)
            assert g.dtype == np.float32 or g.dtype == JR.image_msg_to_gray(msg, rgb=rgb).dtype
            assert np.array_equal(g, JR.image_msg_to_gray(msg, rgb=rgb))
        if a.ndim == 2:
            for f in (1.0, 5000.0):
                assert np.array_equal(TR.depth_msg_to_meters(msg, f), JR.depth_msg_to_meters(msg, f))
    with pytest.raises(ValueError):
        TR.image_msg_to_gray(ImageMsg(a, "yuv422"))


def test_synchronizer_matches_jax():
    """A left/right stream with jitter, a dropped message on each side and
    late arrivals: the same pairs, in the same order."""
    rng = np.random.default_rng(5)
    events = []
    for i in range(40):
        t = 0.1 * i
        if i != 7:
            events.append((0, t + rng.uniform(-0.004, 0.004)))
        if i != 19:
            events.append((1, t + rng.uniform(-0.03, 0.03)))
    # arrival order: stamp plus up to 60 ms of transport delay
    order = np.argsort([t + rng.uniform(0, 0.06) for _, t in events], kind="stable")
    pairs = {}
    for name, mod in (("torch", TR), ("jax", JR)):
        got = pairs[name] = []
        sync = mod.ApproximateTimeSynchronizer(
            lambda a, b: got.append((a.header.stamp.t, b.header.stamp.t)), queue_size=5,
            slop=0.02)
        for k in order:
            side, t = events[k]
            (sync.add0 if side == 0 else sync.add1)(ImageMsg(np.zeros((1, 1), np.uint8),
                                                             "mono8", t=t))
    assert pairs["torch"] == pairs["jax"] and len(pairs["torch"]) > 25


def test_plane_and_cube_match_jax():
    rng = np.random.default_rng(6)
    n = np.array([0.1, 1.0, 0.3]) / np.linalg.norm([0.1, 1.0, 0.3])
    u = np.cross(n, [1.0, 0, 0])
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    pts = (np.array([0.5, 0.0, 4.0]) + rng.uniform(-2, 2, (150, 1)) * u
           + rng.uniform(-2, 2, (150, 1)) * v + rng.normal(0, 0.003, (150, 1)) * n)
    pts = np.concatenate([pts, rng.uniform(-3, 6, (30, 3))])
    for seed in (0, 3):
        a, b = TR.detect_plane(pts, seed=seed), JR.detect_plane(pts, seed=seed)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        assert abs(abs(a[0] @ n) - 1) < 5e-3
    assert TR.detect_plane(pts[:5]) is None and JR.detect_plane(pts[:5]) is None
    assert np.array_equal(TR.cube_vertices(a[1], a[0], 0.3), JR.cube_vertices(a[1], a[0], 0.3))
    assert TR.CUBE_EDGES == JR.CUBE_EDGES


# ---------------------------------------------------------------------------
# the nodes over the port's System on the CPU, with a fake rospy
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stream():
    """tests/test_ros_nodes.py's stream: a PlanesWorld at 320x240, 5 cm a
    frame, left and right (10 cm baseline) and depth."""
    world = PlanesWorld(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=W, height=H)
    poses = smooth_trajectory(10, step=0.05)
    shift = np.eye(4, dtype=np.float32)
    shift[0, 3] = -0.1
    return [dict(t=0.1 * i, left=world.render(T).astype(np.uint8),
                 right=world.render(shift @ T).astype(np.uint8), depth=world.render_depth(T))
            for i, T in enumerate(poses)]


def _system(sensor):
    return System(_cfg(), sensor, enable_loop_closing=False, device="cpu")


def test_mono_and_ar_nodes_track(stream):
    """MonoNode initializes and tracks; a MonoARNode on the same System
    anchors a cube on the tracked points and draws it on the next frames."""
    slam = _system(Sensor.MONOCULAR)
    poses_out, frames = [], []
    msgs = [("/camera/image_raw", ImageMsg(s["left"], "mono8", t=s["t"])) for s in stream]
    node = TR.MonoNode(slam, on_pose=lambda T, t: poses_out.append(t))
    ros = FakeRos(msgs[:8])
    node.run(ros=ros)
    assert ros.node_name == "Mono" and node.n_frames == 8
    assert slam.tracking_state == TrackingState.OK
    assert poses_out == sorted(poses_out) and len(poses_out) >= 3
    ar = TR.MonoARNode(slam, cube_size=0.3, on_frame=lambda f, t: frames.append(f))
    assert ar.insert_cube(), "plane detection failed on tracked points"
    ar.run(ros=FakeRos(msgs[8:]))
    assert ar.n_frames == 2 and len(frames) == 2
    green = (ar.last_ar_frame[..., 1] == 255) & (ar.last_ar_frame[..., 0] == 0)
    assert green.sum() > 50, "the cube wireframe is not drawn"


def test_ar_node_matches_jax():
    """insert_cube and render_ar of both packages on one tracked state (a
    stand-in System: the camera, the last frame and the map's points)."""
    rng = np.random.default_rng(7)
    n = 400
    pts = np.concatenate([np.c_[rng.uniform(-2, 2, (n, 2)), 5 + 0.2 * rng.uniform(-1, 1, n)],
                          rng.uniform(-2, 2, (40, 3)) + [0, 0, 6]])
    Tcw = np.eye(4, dtype=np.float32)
    Tcw[:3, 3] = [0.1, -0.3, 0.5]
    mp = np.arange(n + 40, dtype=np.int32)
    mp[::7] = -1
    frame = type("Frame", (), dict(mp=mp, is_outlier=rng.random(n + 40) < 0.05,
                                   valid=np.ones(n + 40, bool), Tcw=Tcw))()
    slam = type("Slam", (), dict(
        config=_cfg(), tracker=type("Trk", (), dict(last_frame=frame))(),
        map=type("Map", (), dict(mp_pos=pts.astype(np.float32)))()))()
    gray = rng.uniform(0, 255, (H, W)).astype(np.float32)
    nodes = [mod.MonoARNode(slam, cube_size=0.5) for mod in (TR, JR)]
    assert all(node.insert_cube() for node in nodes)
    assert np.array_equal(nodes[0].cube, nodes[1].cube)
    a, b = (node.render_ar(gray, Tcw) for node in nodes)
    assert np.array_equal(a, b) and ((a[..., 1] == 255) & (a[..., 0] == 0)).sum() > 50


def test_stereo_node_rectifies_and_tracks(stream, tmp_path):
    """StereoNode.from_settings_yaml with do_rectify builds the rectifier of
    the LEFT./RIGHT. calibration; here an identity calibration at the
    stream's camera, so the pairs it tracks are the stream's own."""
    K = "[250.0, 0.0, 160.0, 0.0, 250.0, 120.0, 0.0, 0.0, 1.0]"

    def mat(rows, cols, data):
        return f"!!opencv-matrix\n   rows: {rows}\n   cols: {cols}\n   dt: d\n   data: {data}\n"

    text = "%YAML:1.0\n" + "".join(
        f"{s}.height: {H}\n{s}.width: {W}\n{s}.D: " + mat(1, 5, "[0.0, 0.0, 0.0, 0.0, 0.0]")
        + f"{s}.K: " + mat(3, 3, K) + f"{s}.R: " + mat(3, 3, "[1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0]")
        + f"{s}.P: " + mat(3, 4, f"[250.0, 0, 160.0, {p}, 0, 250.0, 120.0, 0, 0, 0, 1, 0]")
        for s, p in (("LEFT", 0.0), ("RIGHT", -25.0)))
    (tmp_path / "stereo.yaml").write_text(text)
    slam = _system(Sensor.STEREO)
    node = TR.StereoNode.from_settings_yaml(slam, str(tmp_path / "stereo.yaml"), do_rectify=True)
    assert node.rectifier is not None
    left, right = node.rectifier(stream[0]["left"], stream[0]["right"])
    assert np.array_equal(left[1:-1, 1:-1], stream[0]["left"][1:-1, 1:-1].astype(np.float32))
    msgs = []
    for s in stream[:5]:
        msgs.append(("/camera/left/image_raw", ImageMsg(s["left"], "mono8", t=s["t"])))
        msgs.append(("/camera/right/image_raw", ImageMsg(s["right"], "mono8", t=s["t"] + 0.003)))
    ros = FakeRos(msgs)
    node.run(ros=ros)
    assert ros.node_name == "Stereo" and node.n_frames == 5
    assert slam.tracking_state == TrackingState.OK
    assert TR.StereoNode.from_settings_yaml(slam, str(tmp_path / "stereo.yaml"),
                                            do_rectify=False).rectifier is None


def test_rgbd_node_tracks(stream):
    slam = _system(Sensor.RGBD)
    slam.config = dataclasses.replace(slam.config, depth_map_factor=1.0)   # 32FC1 metres
    msgs = []
    for s in stream[:5]:
        msgs.append(("/camera/rgb/image_raw", ImageMsg(s["left"], "mono8", t=s["t"])))
        msgs.append(("/camera/depth_registered/image_raw",
                     ImageMsg(s["depth"], "32FC1", t=s["t"] + 0.004)))
    ros = FakeRos(msgs)
    node = TR.RgbdNode(slam)
    node.run(ros=ros)
    assert ros.node_name == "RGBD" and node.n_frames == 5
    assert slam.tracking_state == TrackingState.OK and slam.map.n_map_points() > 100


def test_euroc_calibration_builds_the_node_rectifier(tmp_path):
    (tmp_path / "euroc.yaml").write_text(EUROC_SNIPPET)
    node = TR.StereoNode(None, rectifier=None)
    assert node.rectifier is None
    slam = type("S", (), {})()
    node = TR.StereoNode.from_settings_yaml(slam, str(tmp_path / "euroc.yaml"), do_rectify=True)
    assert node.rectifier.maps_l[0].shape == (480, 752)
