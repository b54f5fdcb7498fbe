"""Headless visualization (frame annotation, map rendering, trajectory plots).

Replaces the reference's Pangolin/OpenCV GUI stack (reference:
src/Viewer.cc, src/FrameDrawer.cc:54-226, src/MapDrawer.cc:57-290) with
headless renderers that produce numpy RGB images / PNG files — suitable for
remote hosts with no display. The same information is drawn: keypoints
and tracked matches with state text, map points (local set highlighted),
keyframe frusta, covisibility graph, spanning tree and loop edges.

A copy of orb_slam2_detailed_comments_tpu/viz/drawers.py. FrameDrawer
takes this package's FrameData as the tracker leaves it, pulling any field
still on the device first; MapDrawer and TrajectoryPlotter import
matplotlib when called (the frame half needs only numpy).
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


class MapDrawer:
    """Render the sparse map + keyframe graph to a PNG
    (reference: MapDrawer::DrawMapPoints/DrawKeyFrames, MapDrawer.cc:57-290)."""

    def __init__(self, map_store: MapStore):
        self.map = map_store

    def render(self, path: Optional[str] = None, show_graph: bool = True,
               elev: float = -75.0, azim: float = -90.0):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        ms = self.map
        fig = plt.figure(figsize=(10, 8))
        ax = fig.add_subplot(111, projection="3d")
        pts = ms.mp_pos[ms.mp_valid]
        if len(pts):
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.5, c="k", alpha=0.4)
        kfs = ms.keyframe_ids()
        centers = np.stack([ms.kf_camera_center(k) for k in kfs]) if kfs.size else np.zeros((0, 3))
        if len(centers):
            ax.scatter(centers[:, 0], centers[:, 1], centers[:, 2], s=12, c="b", marker="s")
        if show_graph and kfs.size:
            idx_of = {int(k): i for i, k in enumerate(kfs)}
            for a_i, a in enumerate(kfs):
                # covisibility (light), spanning tree (green), loop (red)
                for b in ms.get_covisible(int(a), 10):
                    if int(b) in idx_of and b > a:
                        b_i = idx_of[int(b)]
                        ax.plot(*zip(centers[a_i], centers[b_i]), c="0.8", lw=0.4)
                p = int(ms.parent[a])
                if p in idx_of:
                    ax.plot(*zip(centers[a_i], centers[idx_of[p]]), c="g", lw=1.0)
            for (a, b) in ms.loop_edges:
                if a in idx_of and b in idx_of:
                    ax.plot(*zip(centers[idx_of[a]], centers[idx_of[b]]), c="r", lw=1.5)
        ax.view_init(elev=elev, azim=azim)
        ax.set_box_aspect([1, 1, 1])
        if path:
            fig.savefig(path, dpi=110, bbox_inches="tight")
            plt.close(fig)
            return path
        return fig


class TrajectoryPlotter:
    @staticmethod
    def plot(est_xyz: np.ndarray, gt_xyz: Optional[np.ndarray] = None,
             path: Optional[str] = None):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 6))
        ax.plot(est_xyz[:, 0], est_xyz[:, 2], "b-", label="estimate")
        if gt_xyz is not None:
            ax.plot(gt_xyz[:, 0], gt_xyz[:, 2], "k--", label="ground truth")
        ax.set_xlabel("x [m]")
        ax.set_ylabel("z [m]")
        ax.axis("equal")
        ax.legend()
        if path:
            fig.savefig(path, dpi=110, bbox_inches="tight")
            plt.close(fig)
            return path
        return fig
