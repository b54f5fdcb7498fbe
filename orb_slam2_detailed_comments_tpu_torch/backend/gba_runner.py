"""Global bundle adjustment after a loop, with staged merge.

Counterpart of orb_slam2_detailed_comments_tpu/backend/gba_runner.py, the
replacement of the reference's transient GBA thread (reference:
src/LoopClosing.cc:962-965 spawns RunGlobalBundleAdjustment, :699-712 stops
a running one when a new loop arrives, :1064-1234 merges the result into
the live map). A snapshot of the whole-map BA problem is taken, solved
(backend/local_mapping.solve_global_ba, on `device`), and merged:

  * keyframes in the snapshot        -> the solved pose
  * keyframes created meanwhile      -> propagated through the spanning
    tree: Tcw_GBA(child) = Tcw_cur(child) * Tcw_cur(parent)^-1 *
    Tcw_GBA(parent)  (reference: LoopClosing.cc:1128-1185, mTcwBefGBA)
  * map points in the snapshot       -> the solved position, guarded by a
    first-keyframe identity check (point slots are recycled, so a snapshot
    id may name another point by merge time)
  * map points created meanwhile     -> re-anchored through their reference
    keyframe: x_new = Twc_GBA(ref) * Tcw_befGBA(ref) * x_old
    (reference: LoopClosing.cc:1189-1223)

Only the JAX package's default, inline mode is ported: launch() takes the
snapshot, solves and merges in the caller's thread, and nothing can run
between the three, so no map lock is taken. The threaded mode
(async_mode=True) is ROADMAP.md A.11c and raises. The generation counter
and the stop event are kept as the JAX package has them: a stop or a
launch bumps the generation, and a solve merges only for the current one.
"""
from __future__ import annotations

import threading
from typing import Dict

import numpy as np

from ..state.map_store import MapStore
from ..utils.config import SlamConfig
from .local_mapping import build_global_ba_problem, solve_global_ba


class GlobalBARunner:
    def __init__(self, config: SlamConfig, map_store: MapStore, async_mode: bool = False,
                 device="cuda"):
        if async_mode:
            raise NotImplementedError(
                "the threaded global BA runner (async_mode=True) is not ported: ROADMAP.md A.11c")
        self.config = config
        self.map = map_store
        self.device = device
        sf = config.orb.scale_factor
        self.inv_sigma2 = np.array([1.0 / sf ** (2 * i) for i in range(config.orb.n_levels)],
                                   np.float32)
        self._stop = threading.Event()
        self._gen = 0
        self.n_completed = 0
        self.n_aborted = 0
        self.last_edges = 0    # edges of the last snapshot's problem

    # ------------------------------------------------------------------

    def request_stop(self):
        """Stop a running solve (reference: LoopClosing.cc:699-712). Inline,
        none runs between calls; the generation still moves on."""
        self._gen += 1
        self._stop.set()

    def wait(self):
        """Nothing runs in the background in the inline mode."""

    def launch(self, n_iters: int = 10):
        """Snapshot, solve and merge a whole-map BA."""
        self._gen += 1
        self._stop.set()
        stop = threading.Event()
        self._stop = stop
        gen = self._gen
        snap = self._snapshot()
        if snap is None:
            return
        self._solve_and_merge(snap, n_iters, stop, gen)

    # ------------------------------------------------------------------

    def _snapshot(self):
        built = build_global_ba_problem(self.map, self.device)
        if built is None:
            return None
        prob, kfs, pts = built
        self.last_edges = int(prob.edge_cam.shape[0])
        return {
            "prob": prob,
            "kfs": np.asarray(kfs).copy(),
            "pts": np.asarray(pts).copy(),
            # identity guard: map-point slots are recycled by the free list
            "pt_first_kf": self.map.mp_first_kf[pts].copy(),
        }

    def _solve_and_merge(self, snap, n_iters: int, stop: threading.Event, gen: int):
        cam_new, pts_new = solve_global_ba(snap["prob"], self.config.camera, self.inv_sigma2,
                                           n_iters=n_iters)
        if stop.is_set() or gen != self._gen:
            self.n_aborted += 1
            return
        self._merge(snap, cam_new, pts_new)
        self.n_completed += 1

    # ------------------------------------------------------------------

    def _merge(self, snap, cam_new: np.ndarray, pts_new: np.ndarray):
        """Apply the solved poses and points, with spanning-tree
        propagation (reference: LoopClosing.cc:1124-1234)."""
        mp = self.map
        kfs = snap["kfs"]
        cam_free = snap["prob"].cam_free.cpu().numpy()

        # corrected pose per keyframe; poses before correction (mTcwBefGBA)
        corrected: Dict[int, np.ndarray] = {}
        before: Dict[int, np.ndarray] = {}
        for i, k in enumerate(kfs):
            k = int(k)
            if not mp.kf_valid[k]:
                continue
            before[k] = mp.kf_Tcw[k].copy()
            corrected[k] = cam_new[i] if cam_free[i] else mp.kf_Tcw[k].copy()

        # spanning-tree propagation to keyframes created during the solve
        # (or re-parented ones): a child's pose rides its parent's correction
        pending = [int(k) for k in np.nonzero(mp.kf_valid)[0] if int(k) not in corrected]
        progress = True
        while pending and progress:
            progress = False
            still = []
            for k in pending:
                p = int(mp.parent[k])
                if p >= 0 and p in corrected:
                    before[k] = mp.kf_Tcw[k].copy()
                    T_child_parent = mp.kf_Tcw[k] @ np.linalg.inv(before[p])
                    corrected[k] = (T_child_parent @ corrected[p]).astype(np.float32)
                    progress = True
                else:
                    still.append(k)
            pending = still
        # orphans whose chain never reaches the snapshot keep their poses

        for k, T in corrected.items():
            mp.kf_Tcw[k] = T

        # --- map points ---
        applied = np.zeros(mp.MP_CAP, bool)
        pts = snap["pts"]
        same = mp.mp_valid[pts] & (mp.mp_first_kf[pts] == snap["pt_first_kf"])
        mp.mp_pos[pts[same]] = pts_new[same]
        applied[pts[same]] = True

        # points created meanwhile: re-anchor through their reference keyframe
        rest = np.nonzero(mp.mp_valid & ~applied)[0]
        if rest.size:
            refs = mp.mp_ref_kf[rest]
            for r in np.unique(refs):
                r = int(r)
                if r not in corrected or r not in before:
                    continue
                sel = rest[refs == r]
                x = mp.mp_pos[sel]
                Tb = before[r]
                xc = x @ Tb[:3, :3].T + Tb[:3, 3]
                Twc = np.linalg.inv(corrected[r]).astype(np.float32)
                mp.mp_pos[sel] = xc @ Twc[:3, :3].T + Twc[:3, 3]

        all_pts = np.nonzero(mp.mp_valid)[0]
        mp.update_normal_and_depth(all_pts)
        mp.pose_epoch += 1
