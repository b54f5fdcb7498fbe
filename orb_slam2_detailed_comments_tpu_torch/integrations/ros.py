"""ROS nodes: live camera-stream front-ends for the SLAM system.

Equivalents of the reference's ROS examples
(reference: Examples/ROS/ORB_SLAM2/src/ros_mono.cc, ros_stereo.cc,
ros_rgbd.cc, AR/ros_mono_ar.cc + AR/ViewerAR.cc): each node subscribes to
sensor_msgs/Image topics, converts messages to grayscale float arrays (the
cv_bridge + cvtColor step, ros_mono.cc:105-118), and feeds
System.track_{monocular,stereo,rgbd}.

Design notes:
 * The node classes are middleware-agnostic: they take any rospy-compatible
   module object (``ros=``), defaulting to ``import rospy`` at ``run()``.
   This keeps the logic fully unit-testable without a ROS install and
   portable to rospy/rclpy shims.
 * ``ApproximateTimeSynchronizer`` re-implements message_filters'
   ApproximateTime pairing used by the stereo/RGB-D nodes
   (ros_stereo.cc:113-116, ros_rgbd.cc:103-106) in pure Python.
 * Stereo rectification (ros_stereo.cc:71-110,158-162) reuses
   ops/rectify.StereoRectifier built from the same LEFT.*/RIGHT.* YAML.
 * The AR node is headless: ViewerAR's RANSAC plane detection + virtual
   cube (AR/ViewerAR.cc DetectPlane/DrawCube) become ``detect_plane`` and a
   wireframe-overlay renderer returning annotated numpy images.

A copy of orb_slam2_detailed_comments_tpu/integrations/ros.py over this
package's System.
"""
from __future__ import annotations

import collections
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..frontend.tracking import Sensor
from ..system import System


# ---------------------------------------------------------------------------
# message conversion (cv_bridge equivalent)
# ---------------------------------------------------------------------------

def _stamp_seconds(msg) -> float:
    """Extract a float timestamp from a sensor_msgs/Image-like message."""
    st = getattr(getattr(msg, "header", None), "stamp", None)
    if st is None:
        return 0.0
    if hasattr(st, "to_sec"):
        return float(st.to_sec())
    if hasattr(st, "sec"):  # rclpy builtin_interfaces/Time
        return float(st.sec) + float(getattr(st, "nanosec", 0)) * 1e-9
    return float(st)


def image_msg_to_array(msg) -> np.ndarray:
    """sensor_msgs/Image -> numpy array in the message's native encoding."""
    enc = msg.encoding.lower()
    h, w = int(msg.height), int(msg.width)
    buf = msg.data if isinstance(msg.data, (bytes, bytearray, memoryview)) else bytes(msg.data)
    channels = {"mono8": 1, "mono16": 1, "8uc1": 1, "16uc1": 1, "32fc1": 1,
                "rgb8": 3, "bgr8": 3, "rgba8": 4, "bgra8": 4}.get(enc)
    if channels is None:
        raise ValueError(f"unsupported image encoding: {msg.encoding}")
    dtype = {"mono16": np.uint16, "16uc1": np.uint16, "32fc1": np.float32}.get(enc, np.uint8)
    itemsize = np.dtype(dtype).itemsize
    step = int(getattr(msg, "step", w * channels * itemsize)) or w * channels * itemsize
    rows = np.frombuffer(buf, np.uint8).reshape(h, step)
    rows = rows[:, : w * channels * itemsize]
    img = rows.view(dtype).reshape(h, w, channels) if channels > 1 else rows.view(dtype).reshape(h, w)
    return img


def image_msg_to_gray(msg, rgb: bool = True) -> np.ndarray:
    """sensor_msgs/Image -> (H, W) float32 grayscale in [0, 255].

    Replicates the reference's cvtColor(...,COLOR_RGB2GRAY/COLOR_BGR2GRAY)
    dispatch on the Camera.RGB flag (reference: Tracking.cc:372-385 via
    GrabImageMonocular; the ROS nodes feed it the raw message image).
    """
    img = image_msg_to_array(msg)
    if img.ndim == 2:
        out = img.astype(np.float32)
        if img.dtype == np.uint16:
            out = out / 257.0  # 16-bit mono -> [0,255]
        return out
    enc = msg.encoding.lower()
    chans = img[..., :3].astype(np.float32)
    if enc.startswith("bgr") or (not rgb and not enc.startswith(("rgb", "bgr"))):
        b, g, r = chans[..., 0], chans[..., 1], chans[..., 2]
    else:
        r, g, b = chans[..., 0], chans[..., 1], chans[..., 2]
    return 0.299 * r + 0.587 * g + 0.114 * b


def depth_msg_to_meters(msg, depth_map_factor: float = 1.0) -> np.ndarray:
    """sensor_msgs/Image depth (32FC1 meters or 16UC1 scaled) -> meters
    (reference: Tracking.cc:204-211 DepthMapFactor handling)."""
    img = image_msg_to_array(msg)
    d = img.astype(np.float32)
    if img.dtype == np.uint16 or abs(depth_map_factor - 1.0) > 1e-5:
        d = d / depth_map_factor
    return d


# ---------------------------------------------------------------------------
# approximate-time pairing (message_filters equivalent)
# ---------------------------------------------------------------------------

class ApproximateTimeSynchronizer:
    """Pair messages from two streams by nearest timestamp.

    Pure-Python equivalent of message_filters::sync_policies::ApproximateTime
    with queue_size as used by the stereo/RGB-D nodes
    (reference: ros_stereo.cc:113-116). Call ``add0``/``add1`` per stream;
    the registered callback fires with a (msg0, msg1) pair whose stamps
    differ by at most ``slop`` seconds, each message used at most once.
    """

    def __init__(self, callback: Callable, queue_size: int = 10, slop: float = 0.02):
        self.callback = callback
        self.slop = slop
        self.q0: collections.deque = collections.deque(maxlen=queue_size)
        self.q1: collections.deque = collections.deque(maxlen=queue_size)

    def add0(self, msg):
        self.q0.append((_stamp_seconds(msg), msg))
        self._try_match()

    def add1(self, msg):
        self.q1.append((_stamp_seconds(msg), msg))
        self._try_match()

    def _try_match(self):
        while self.q0 and self.q1:
            t0, m0 = self.q0[0]
            # best q1 candidate for the head of q0
            best_i, best_dt = -1, None
            for i, (t1, _) in enumerate(self.q1):
                dt = abs(t1 - t0)
                if best_dt is None or dt < best_dt:
                    best_i, best_dt = i, dt
            if best_dt is not None and best_dt <= self.slop:
                _, m1 = self.q1[best_i]
                for _ in range(best_i + 1):
                    self.q1.popleft()
                self.q0.popleft()
                self.callback(m0, m1)
            elif self.q1[-1][0] > t0 + self.slop:
                self.q0.popleft()  # no future q1 message can match this q0 head
            else:
                break  # wait for more q1 messages


def _image_msg_type():
    try:
        from sensor_msgs.msg import Image  # type: ignore
        return Image
    except ImportError:
        return None


# ---------------------------------------------------------------------------
# nodes
# ---------------------------------------------------------------------------

class _NodeBase:
    def __init__(self, slam: System, on_pose: Optional[Callable] = None):
        self.slam = slam
        self.on_pose = on_pose
        self.n_frames = 0
        self.last_pose: Optional[np.ndarray] = None

    def _finish(self, Tcw, ts):
        self.n_frames += 1
        self.last_pose = Tcw
        if Tcw is not None and self.on_pose is not None:
            self.on_pose(Tcw, ts)


class MonoNode(_NodeBase):
    """Monocular stream node (reference: ros_mono.cc ImageGrabber)."""

    topic = "/camera/image_raw"

    def grab_image(self, msg):
        gray = image_msg_to_gray(msg, rgb=self.slam.config.rgb)
        self._finish(self.slam.track_monocular(gray, _stamp_seconds(msg)),
                     _stamp_seconds(msg))

    def run(self, ros=None):
        ros = ros or __import__("rospy")
        ros.init_node("Mono")
        ros.Subscriber(self.topic, _image_msg_type(), self.grab_image, queue_size=1)
        ros.spin()
        self.slam.shutdown()


class StereoNode(_NodeBase):
    """Synchronized stereo node with optional rectification
    (reference: ros_stereo.cc ImageGrabber::GrabStereo)."""

    topic_left = "/camera/left/image_raw"
    topic_right = "/camera/right/image_raw"

    def __init__(self, slam: System, rectifier=None, on_pose=None,
                 queue_size: int = 10, slop: float = 0.02):
        super().__init__(slam, on_pose)
        self.rectifier = rectifier
        self.sync = ApproximateTimeSynchronizer(self.grab_stereo, queue_size, slop)

    @classmethod
    def from_settings_yaml(cls, slam: System, settings_path: str, do_rectify: bool,
                           **kw) -> "StereoNode":
        rectifier = None
        if do_rectify:
            from ..ops.rectify import StereoRectifier
            rectifier = StereoRectifier.from_settings_yaml(settings_path)
        return cls(slam, rectifier=rectifier, **kw)

    def grab_stereo(self, msg_left, msg_right):
        left = image_msg_to_gray(msg_left, rgb=self.slam.config.rgb)
        right = image_msg_to_gray(msg_right, rgb=self.slam.config.rgb)
        if self.rectifier is not None:
            left, right = self.rectifier(left, right)
        ts = _stamp_seconds(msg_left)
        self._finish(self.slam.track_stereo(left, right, ts), ts)

    def run(self, ros=None):
        ros = ros or __import__("rospy")
        ros.init_node("Stereo")
        ros.Subscriber(self.topic_left, _image_msg_type(), self.sync.add0, queue_size=1)
        ros.Subscriber(self.topic_right, _image_msg_type(), self.sync.add1, queue_size=1)
        ros.spin()
        self.slam.shutdown()


class RgbdNode(_NodeBase):
    """Synchronized RGB + depth node (reference: ros_rgbd.cc GrabRGBD)."""

    topic_rgb = "/camera/rgb/image_raw"
    topic_depth = "/camera/depth_registered/image_raw"

    def __init__(self, slam: System, on_pose=None, queue_size: int = 10,
                 slop: float = 0.02):
        super().__init__(slam, on_pose)
        self.sync = ApproximateTimeSynchronizer(self.grab_rgbd, queue_size, slop)

    def grab_rgbd(self, msg_rgb, msg_depth):
        gray = image_msg_to_gray(msg_rgb, rgb=self.slam.config.rgb)
        depth = depth_msg_to_meters(msg_depth, self.slam.config.depth_map_factor)
        ts = _stamp_seconds(msg_rgb)
        self._finish(self.slam.track_rgbd(gray, depth, ts), ts)

    def run(self, ros=None):
        ros = ros or __import__("rospy")
        ros.init_node("RGBD")
        ros.Subscriber(self.topic_rgb, _image_msg_type(), self.sync.add0, queue_size=1)
        ros.Subscriber(self.topic_depth, _image_msg_type(), self.sync.add1, queue_size=1)
        ros.spin()
        self.slam.shutdown()


# ---------------------------------------------------------------------------
# AR (reference: AR/ViewerAR.cc)
# ---------------------------------------------------------------------------

def detect_plane(points_w: np.ndarray, iterations: int = 50, seed: int = 0
                 ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """RANSAC-fit a plane to tracked map points; returns (normal, origin)
    in world coordinates or None (reference: ViewerAR::DetectPlane — 3-point
    hypotheses scored by a robust distance threshold from the residual
    distribution)."""
    pts = np.asarray(points_w, np.float64)
    if len(pts) < 12:
        return None
    rng = np.random.default_rng(seed)
    # one fixed inlier threshold for all hypotheses, set by scene scale
    # (the reference scores hypotheses by a distance-distribution statistic,
    # ViewerAR.cc DetectPlane; a per-hypothesis threshold would make inlier
    # counts incomparable across hypotheses)
    scene_scale = float(np.median(np.linalg.norm(pts - pts.mean(0), axis=1)))
    th = max(0.02 * scene_scale, 1e-6)
    best_inl, best = -1, None
    for _ in range(iterations):
        tri = pts[rng.choice(len(pts), 3, replace=False)]
        n = np.cross(tri[1] - tri[0], tri[2] - tri[0])
        nn = np.linalg.norm(n)
        if nn < 1e-12:
            continue
        n = n / nn
        d = np.abs((pts - tri[0]) @ n)
        inl = int((d < th).sum())
        if inl > best_inl:
            best_inl, best = inl, (n, tri[0])
    if best is None:
        return None
    n, p0 = best
    sel = np.abs((pts - p0) @ n) < th
    if sel.sum() < 6:
        return None
    # least-squares refit on inliers
    c = pts[sel].mean(axis=0)
    A = pts[sel] - c
    _, _, Vt = np.linalg.svd(A, full_matrices=False)
    n = Vt[-1]
    return n / np.linalg.norm(n), c


def cube_vertices(origin: np.ndarray, normal: np.ndarray, size: float) -> np.ndarray:
    """8 world-frame corners of a cube of edge ``size`` resting on the plane
    (reference: ViewerAR::DrawCube draws a size-cube at the plane pose)."""
    n = normal / np.linalg.norm(normal)
    a = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0, 1.0, 0])
    u = np.cross(n, a)
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    h = size / 2.0
    corners = []
    for k in (0.0, 1.0):
        for (su, sv) in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
            corners.append(origin + su * h * u + sv * h * v + k * size * n)
    return np.asarray(corners)


CUBE_EDGES: Sequence[Tuple[int, int]] = (
    (0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7))


class MonoARNode(MonoNode):
    """Monocular AR node: tracks the camera and overlays a virtual cube
    anchored to a detected scene plane (reference: AR/ros_mono_ar.cc +
    AR/ViewerAR.cc, headless — returns annotated frames instead of a GUI)."""

    def __init__(self, slam: System, cube_size: float = 0.2, on_frame=None,
                 **kw):
        super().__init__(slam, **kw)
        self.cube_size = cube_size
        self.cube: Optional[np.ndarray] = None  # (8, 3) world corners
        self.on_frame = on_frame
        self.last_ar_frame: Optional[np.ndarray] = None

    def insert_cube(self) -> bool:
        """Anchor a cube on a plane fitted to currently tracked points
        (the reference triggers this from the GUI 'Insert Cube' button)."""
        fr = self.slam.tracker.last_frame
        if fr is None or fr.mp is None:
            return False
        ids = fr.mp[(fr.mp >= 0) & ~fr.is_outlier & fr.valid]
        pts = self.slam.map.mp_pos[ids]
        plane = detect_plane(pts)
        if plane is None:
            return False
        n, c = plane
        # orient the normal towards the camera so the cube sits on top
        Rcw, tcw = fr.Tcw[:3, :3], fr.Tcw[:3, 3]
        cam_center = -Rcw.T @ tcw
        if np.dot(cam_center - c, n) < 0:
            n = -n
        self.cube = cube_vertices(c, n, self.cube_size)
        return True

    def grab_image(self, msg):
        gray = image_msg_to_gray(msg, rgb=self.slam.config.rgb)
        ts = _stamp_seconds(msg)
        Tcw = self.slam.track_monocular(gray, ts)
        self._finish(Tcw, ts)
        self.last_ar_frame = self.render_ar(gray, Tcw)
        if self.on_frame is not None:
            self.on_frame(self.last_ar_frame, ts)

    def render_ar(self, gray: np.ndarray, Tcw: Optional[np.ndarray]) -> np.ndarray:
        """Overlay the cube wireframe on the frame (ViewerAR render loop)."""
        rgb = np.stack([gray, gray, gray], axis=-1).astype(np.uint8)
        if Tcw is None or self.cube is None:
            return rgb
        cam = self.slam.config.camera
        R, t = Tcw[:3, :3], Tcw[:3, 3]
        pc = self.cube @ R.T + t
        if np.any(pc[:, 2] <= 0.05):
            return rgb
        us = cam.fx * pc[:, 0] / pc[:, 2] + cam.cx
        vs = cam.fy * pc[:, 1] / pc[:, 2] + cam.cy
        H, W = gray.shape
        for (a, b) in CUBE_EDGES:
            self._line(rgb, us[a], vs[a], us[b], vs[b], (0, 255, 0))
        return rgb

    @staticmethod
    def _line(rgb, x0, y0, x1, y1, color):
        n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
        xs = np.linspace(x0, x1, n).round().astype(int)
        ys = np.linspace(y0, y1, n).round().astype(int)
        H, W = rgb.shape[:2]
        ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
        rgb[ys[ok], xs[ok]] = color
