"""Streaming observability for long headless runs.

The headless equivalent of the reference's live viewer thread (reference:
src/Viewer.cc:76-236 renders the map + annotated frame at a fixed period):
instead of an OpenGL window, a StreamingViewer periodically writes the
annotated current frame (with the DrawTextInfo status banner) and the map
render (points, frusta, covisibility/spanning-tree/loop edges) as PNGs to
a directory — tail them with any image viewer / web server to watch a run
live on a host without a display — and a small status.json for dashboards.

A copy of orb_slam2_detailed_comments_tpu/viz/stream.py, but for the frame
image: it is written as an RGB PNG through this package's own codec
(io/png.py), never through matplotlib and never as the JAX package's PPM
fallback, and the map render is drawn in numpy (viz/drawers.MapDrawer), so
it needs no imaging or plotting library.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np

from ..io.png import write_png
from .drawers import FrameDrawer, MapDrawer


def _write_png(path: str, rgb: np.ndarray) -> None:
    write_png(path, np.ascontiguousarray(rgb, np.uint8))


class StreamingViewer:
    """Periodic frame/map emission during a run.

    Wire with `viewer = StreamingViewer(system, out_dir, period_s=2.0)`
    and call `viewer.update(img, frame)` once per tracked frame (the
    drivers do this behind --viz); emission is rate-limited to period_s so
    per-frame cost is a timestamp check."""

    def __init__(self, system, out_dir: str, period_s: float = 2.0,
                 keep_history: bool = False, map_every: int = 5):
        self.system = system
        self.out_dir = out_dir
        self.period_s = period_s
        self.keep_history = keep_history
        self.map_every = map_every      # map render every N emissions
        self.frame_drawer = FrameDrawer(system.config)
        self.map_drawer = MapDrawer(system.map)
        self._last_emit = 0.0
        self._n_emitted = 0
        os.makedirs(out_dir, exist_ok=True)

    # ------------------------------------------------------------------
    # inbound control channel (reference: the Pangolin menu toggles
    # localization mode / reset live, Viewer.cc:76-236; headless hosts get
    # a command FILE instead: write one command per line to
    # <out_dir>/control, the viewer consumes + truncates it each poll)
    COMMANDS = ("localization_on", "localization_off", "reset",
                "save_map", "save_trajectory_tum", "save_trajectory_kitti")

    def poll_control(self) -> list:
        """Consume pending commands from <out_dir>/control. Returns the
        list of commands executed. Lines: `localization_on`,
        `localization_off`, `reset`, `save_map <path>`,
        `save_trajectory_tum <path>`, `save_trajectory_kitti <path>`."""
        path = os.path.join(self.out_dir, "control")
        if not os.path.exists(path):
            return []
        # Atomic claim: rename the file out from under concurrent
        # appenders before reading. A writer that raced the rename either
        # completed its append first (we read it) or creates a fresh
        # control file (next poll reads it); read+truncate-in-place
        # destroyed commands appended in between.
        claimed = path + ".consuming"
        try:
            os.replace(path, claimed)
            with open(claimed) as f:
                lines = [ln.strip() for ln in f.readlines() if ln.strip()]
            os.remove(claimed)
        except OSError:
            return []
        done = []
        for ln in lines:
            parts = ln.split(None, 1)
            cmd = parts[0]
            arg = parts[1] if len(parts) > 1 else None
            try:
                if cmd == "localization_on":
                    self.system.activate_localization_mode()
                elif cmd == "localization_off":
                    self.system.deactivate_localization_mode()
                elif cmd == "reset":
                    self.system.reset()
                elif cmd == "save_map" and arg:
                    self.system.save_map(arg)
                elif cmd == "save_trajectory_tum" and arg:
                    self.system.save_trajectory_tum(arg)
                elif cmd == "save_trajectory_kitti" and arg:
                    self.system.save_trajectory_kitti(arg)
                else:
                    continue
                done.append(ln)
            except Exception as e:  # surface, never kill the run
                done.append(f"{ln} !error {e}")
        if done:
            with open(os.path.join(self.out_dir, "control.log"), "a") as f:
                for ln in done:
                    f.write(ln + "\n")
        return done

    def update(self, img: np.ndarray, frame=None, force: bool = False) -> bool:
        """Rate-limited emission; returns True if something was written.
        Also consumes the inbound control file each emission."""
        now = time.monotonic()
        if not force and now - self._last_emit < self.period_s:
            return False
        self.poll_control()
        self._last_emit = now
        self._n_emitted += 1
        text = FrameDrawer.status_text(self.system)
        rgb = self.frame_drawer.draw(np.asarray(img), frame, state_text=text)
        tag = f"{self._n_emitted:06d}_" if self.keep_history else ""
        _write_png(os.path.join(self.out_dir, f"{tag}frame.png"), rgb)
        self.map_drawer.map = self.system.map   # System.load_map may swap it
        if self._n_emitted % self.map_every == 1:
            self.map_drawer.render(os.path.join(self.out_dir, f"{tag}map.png"))
        status = {
            "state": self.system.tracking_state.name,
            "keyframes": int(self.system.map.n_keyframes()),
            "map_points": int(self.system.map.n_map_points()),
            "tracked": int(self.system.n_tracked_points()),
            "localization_only": bool(self.system.tracker.localization_only),
            "vo_mode": bool(getattr(self.system.tracker, "vo_mode", False)),
            "emission": self._n_emitted,
        }
        with open(os.path.join(self.out_dir, "status.json"), "w") as f:
            json.dump(status, f)
        return True
