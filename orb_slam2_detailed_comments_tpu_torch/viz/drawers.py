"""Headless visualization (frame annotation, map rendering, trajectory plots).

Replaces the reference's Pangolin/OpenCV GUI stack (reference:
src/Viewer.cc, src/FrameDrawer.cc:54-226, src/MapDrawer.cc:57-290) with
headless renderers that produce numpy RGB images / PNG files — suitable for
remote hosts with no display. The same information is drawn: keypoints
and tracked matches with state text, map points (local set highlighted),
keyframe frusta, covisibility graph, spanning tree and loop edges.

A copy of orb_slam2_detailed_comments_tpu/viz/drawers.py. FrameDrawer
takes this package's FrameData as the tracker leaves it, pulling any field
still on the device first. MapDrawer and TrajectoryPlotter draw in numpy
and write through io/png.py, with no plotting library (the JAX package
draws them with matplotlib, which a card's host may lack): the same
content, a different picture. MapDrawer projects the map orthographically
in matplotlib's 3-D view (elev, azim), each axis first scaled to a unit
cube as set_box_aspect([1, 1, 1]) does; TrajectoryPlotter plots x against
z at equal scale.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..state.map_store import MapStore


def _host(a) -> np.ndarray:
    """A FrameData field as a host array (a torch tensor is pulled)."""
    return a if isinstance(a, np.ndarray) else a.detach().cpu().numpy()


class FrameDrawer:
    """Annotate the current frame (reference: FrameDrawer::DrawFrame)."""

    def __init__(self, config):
        self.config = config

    def draw(self, img: np.ndarray, frame, state_text: str = "") -> np.ndarray:
        """img: (H, W) grayscale; frame: FrameData. Returns (H+banner, W, 3)
        uint8: annotated keypoints plus a status banner rasterized below
        the image (reference: FrameDrawer::DrawTextInfo appends a text
        strip under the frame, FrameDrawer.cc:168-226)."""
        rgb = np.stack([img, img, img], axis=-1).astype(np.uint8)
        n_matched = 0
        if frame is not None and frame.mp is not None:
            xy, valid, mp, outlier = (_host(a) for a in (frame.xy, frame.valid, frame.mp,
                                                          frame.is_outlier))
            matched = (mp >= 0) & ~outlier & valid
            n_matched = int(matched.sum())
            for i in np.nonzero(valid)[0]:
                x, y = int(xy[i, 0]), int(xy[i, 1])
                if not (0 <= x < img.shape[1] and 0 <= y < img.shape[0]):
                    continue
                color = (0, 255, 0) if matched[i] else (70, 70, 255)
                self._cross(rgb, x, y, color)
        if not state_text:
            state_text = f"MATCHES: {n_matched}"
        return self._with_banner(rgb, state_text)

    @staticmethod
    def status_text(system) -> str:
        """Reference banner content (FrameDrawer.cc:168-226): tracking
        state + map statistics + current matches."""
        st = system.tracking_state.name.replace("_", " ")
        loc = " + LOC" if system.tracker.localization_only else ""
        vo = " VO" if getattr(system.tracker, "vo_mode", False) else ""
        return (f"{st}{loc}{vo}  KFS: {system.map.n_keyframes()}  "
                f"MPS: {system.map.n_map_points()}  "
                f"MATCHES: {system.n_tracked_points()}")

    @staticmethod
    def _with_banner(rgb: np.ndarray, text: str) -> np.ndarray:
        from .bitmap_font import draw_text
        h, w = rgb.shape[:2]
        banner = np.zeros((15, w, 3), np.uint8)
        draw_text(banner, 4, 4, text, color=(255, 255, 255))
        return np.concatenate([rgb, banner], axis=0)

    @staticmethod
    def _cross(rgb, x, y, color, r=2):
        h, w = rgb.shape[:2]
        for d in range(-r, r + 1):
            if 0 <= x + d < w:
                rgb[y, x + d] = color
            if 0 <= y + d < h:
                rgb[y + d, x] = color


MAP_SIZE = (800, 640)          # MapDrawer's picture, width x height (px)
PLOT_SIZE = (640, 480)         # TrajectoryPlotter's
MARGIN = 24                    # px kept clear around the drawing
POINT_RGB = (110, 110, 110)
KF_RGB = (0, 0, 255)
COVIS_RGB = (205, 205, 205)
TREE_RGB = (0, 160, 0)
LOOP_RGB = (230, 0, 0)
EST_RGB = (0, 0, 255)
GT_RGB = (0, 0, 0)


def _fit(uv: np.ndarray, size):
    """The map from 2-D drawing coordinates to pixels that fits `uv`'s
    bounding box into a picture of `size` (w, h) less MARGIN, at one scale
    for both axes, centred, y up."""
    w, h = size
    lo = uv.min(axis=0) if len(uv) else np.zeros(2)
    hi = uv.max(axis=0) if len(uv) else np.ones(2)
    span = np.maximum(hi - lo, 1e-9)
    scale = min((w - 2 * MARGIN) / span[0], (h - 2 * MARGIN) / span[1])
    mid = (lo + hi) / 2

    def to_px(p):
        p = np.asarray(p, np.float64).reshape(-1, 2)
        x = w / 2 + scale * (p[:, 0] - mid[0])
        y = h / 2 - scale * (p[:, 1] - mid[1])
        return np.stack([x, y], -1)
    return to_px


def _dots(rgb: np.ndarray, px: np.ndarray, color, r: int = 0) -> None:
    """Squares of half-width r at the pixels px (n, 2), clipped."""
    h, w = rgb.shape[:2]
    xy = np.rint(px).astype(np.int64)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            x, y = xy[:, 0] + dx, xy[:, 1] + dy
            ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
            rgb[y[ok], x[ok]] = color


def _line(rgb: np.ndarray, a, b, color, dash: int = 0) -> None:
    """The segment from pixel a to pixel b, one sample a pixel step;
    with dash > 0, `dash` pixels drawn then `dash` skipped."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    n = int(np.ceil(np.abs(b - a).max())) + 1
    t = np.linspace(0.0, 1.0, n)[:, None]
    pts = a + t * (b - a)
    if dash:
        pts = pts[(np.arange(n) // dash) % 2 == 0]
    _dots(rgb, pts, color)


def _polyline(rgb: np.ndarray, px: np.ndarray, color, dash: int = 0) -> None:
    for a, b in zip(px[:-1], px[1:]):
        _line(rgb, a, b, color, dash)


def _finish(rgb: np.ndarray, path: Optional[str]):
    """Write rgb as a PNG at path and return the path, or return rgb."""
    if path:
        from ..io.png import write_png
        write_png(path, rgb)
        return path
    return rgb


class MapDrawer:
    """Render the sparse map + keyframe graph to a PNG
    (reference: MapDrawer::DrawMapPoints/DrawKeyFrames, MapDrawer.cc:57-290):
    map points grey, keyframe centres as blue squares, covisibility edges
    light grey, the spanning tree green, loop edges red."""

    def __init__(self, map_store: MapStore):
        self.map = map_store

    def projector(self, elev: float = -75.0, azim: float = -90.0):
        """The map from world points (n, 3) to pixels (n, 2) of the picture
        render draws: each axis scaled by the span of the map points and
        keyframe centres to a unit cube, projected on the screen's right
        and up directions of matplotlib's 3-D view at elevation `elev` and
        azimuth `azim` (degrees), fitted into the picture."""
        ms = self.map
        kfs = ms.keyframe_ids()
        xyz = np.concatenate([ms.mp_pos[ms.mp_valid].reshape(-1, 3),
                              np.asarray([ms.kf_camera_center(k) for k in kfs]).reshape(-1, 3)])
        lo = xyz.min(axis=0) if len(xyz) else np.zeros(3)
        span = np.maximum(xyz.max(axis=0) - lo, 1e-9) if len(xyz) else np.ones(3)
        e, a = np.radians(elev), np.radians(azim)
        axes = np.array([[-np.sin(a), np.cos(a), 0.0],
                         [-np.sin(e) * np.cos(a), -np.sin(e) * np.sin(a), np.cos(e)]])

        def screen(p):
            return ((np.asarray(p, np.float64).reshape(-1, 3) - lo) / span) @ axes.T
        to_px = _fit(screen(xyz), MAP_SIZE)
        return lambda p: to_px(screen(p))

    def render(self, path: Optional[str] = None, show_graph: bool = True,
               elev: float = -75.0, azim: float = -90.0):
        """The map as an (H, W, 3) uint8 picture, or written as a PNG at
        `path` (then the path is returned)."""
        ms = self.map
        w, h = MAP_SIZE
        rgb = np.full((h, w, 3), 255, np.uint8)
        proj = self.projector(elev, azim)
        kfs = ms.keyframe_ids()
        centers = (proj(np.stack([ms.kf_camera_center(k) for k in kfs])) if kfs.size
                   else np.zeros((0, 2)))
        pts = ms.mp_pos[ms.mp_valid]
        if len(pts):
            _dots(rgb, proj(pts), POINT_RGB)
        if show_graph and kfs.size:
            idx_of = {int(k): i for i, k in enumerate(kfs)}
            tree = []
            for a_i, a in enumerate(kfs):
                for b in ms.get_covisible(int(a), 10):
                    if int(b) in idx_of and b > a:
                        _line(rgb, centers[a_i], centers[idx_of[int(b)]], COVIS_RGB)
                p = int(ms.parent[a])
                if p in idx_of:
                    tree.append((a_i, idx_of[p]))
            for a_i, b_i in tree:          # over the covisibility edges
                _line(rgb, centers[a_i], centers[b_i], TREE_RGB)
            for (a, b) in ms.loop_edges:
                if a in idx_of and b in idx_of:
                    _line(rgb, centers[idx_of[a]], centers[idx_of[b]], LOOP_RGB)
        _dots(rgb, centers, KF_RGB, r=2)
        return _finish(rgb, path)


class TrajectoryPlotter:
    @staticmethod
    def projector(est_xyz: np.ndarray, gt_xyz: Optional[np.ndarray] = None):
        """The map from trajectory points (n, 3) to pixels (n, 2) of the
        plot: x to the right, z up, one scale, fitted to both curves."""
        xz = np.concatenate([np.asarray(est_xyz)[:, [0, 2]]]
                            + ([np.asarray(gt_xyz)[:, [0, 2]]] if gt_xyz is not None else []))
        to_px = _fit(xz, PLOT_SIZE)
        return lambda p: to_px(np.asarray(p, np.float64).reshape(-1, 3)[:, [0, 2]])

    @staticmethod
    def plot(est_xyz: np.ndarray, gt_xyz: Optional[np.ndarray] = None,
             path: Optional[str] = None):
        """x against z of the estimate (blue) and the ground truth (black,
        dashed), at equal scale, with a legend and the axes' extents in
        metres; an (H, W, 3) uint8 picture, or written as a PNG at `path`."""
        from .bitmap_font import draw_text
        w, h = PLOT_SIZE
        rgb = np.full((h, w, 3), 255, np.uint8)
        proj = TrajectoryPlotter.projector(est_xyz, gt_xyz)
        if gt_xyz is not None and len(gt_xyz):
            _polyline(rgb, proj(gt_xyz), GT_RGB, dash=4)
        if len(est_xyz):
            _polyline(rgb, proj(est_xyz), EST_RGB)
        both = np.concatenate([np.asarray(est_xyz)]
                              + ([np.asarray(gt_xyz)] if gt_xyz is not None else []))
        lo, hi = both.min(axis=0), both.max(axis=0)
        draw_text(rgb, 4, h - 10, f"X (M) {lo[0]:.2f} TO {hi[0]:.2f}", GT_RGB)
        draw_text(rgb, 4, 4, f"Z (M) {lo[2]:.2f} TO {hi[2]:.2f}", GT_RGB)
        draw_text(rgb, w - 100, 4, "ESTIMATE", EST_RGB)
        if gt_xyz is not None:
            draw_text(rgb, w - 100, 14, "GROUND TRUTH", GT_RGB)
        return _finish(rgb, path)
