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

In the default, inline mode launch() takes the snapshot, solves and merges
in the caller's thread. With async_mode=True, the reference's topology,
the solve runs on a daemon thread with its own CUDA stream and never holds
the map lock: the snapshot is taken under the lock as host arrays and
uploaded on the solving thread's stream, the solve polls a stop event
between chunks of LM iterations (the reference's mbStopGBA), and the
merge takes the lock again. A stop or a launch bumps the generation and
sets the running solve's event (each launch has an event of its own); a
solve merges only if, under the lock, its event is clear and its
generation current, so a thread that waited at the lock while a loop
correction held it cannot merge a stale result. The first exception of a
solving thread is kept and raised on the caller's thread by check(),
wait(), request_stop() and the next launch().
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..optim.local_ba import BAProblem
from ..state.map_store import MapStore
from ..utils.config import SlamConfig
from .local_mapping import build_global_ba_problem, solve_global_ba

JOIN_TIMEOUT_S = 120.0   # the longest wait for a solving thread


class GlobalBARunner:
    def __init__(self, config: SlamConfig, map_store: MapStore, async_mode: bool = False,
                 device="cuda", map_lock=None):
        if async_mode and map_lock is None:
            raise ValueError("the threaded global BA (async_mode=True) needs the map lock")
        self.config = config
        self.map = map_store
        self.async_mode = async_mode
        self.device = torch.device(device)
        self.lock = map_lock if map_lock is not None else contextlib.nullcontext()
        sf = config.orb.scale_factor
        self.inv_sigma2 = np.array([1.0 / sf ** (2 * i) for i in range(config.orb.n_levels)],
                                   np.float32)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._gen = 0
        self._meta_lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self.n_completed = 0
        self.n_aborted = 0
        self.last_edges = 0    # edges of the last snapshot's problem
        # called between solver chunks, after the stop poll: lets a test slow
        # a running solve down deterministically
        self._chunk_hook = None

    # ------------------------------------------------------------------

    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def check(self):
        """Raise the first exception of a solving thread, if one failed."""
        if self._error is not None:
            raise RuntimeError("the global BA thread failed") from self._error

    def request_stop(self, join: bool = True, timeout: float = JOIN_TIMEOUT_S):
        """Stop a running solve (reference: LoopClosing.cc:699-712). The
        generation moves on, so a pending merge is void even when the join
        times out (the caller may hold the lock the merging thread waits
        for; the loop closer, which does, passes join=False)."""
        with self._meta_lock:
            self._gen += 1
            self._stop.set()
            th = self._thread
        if join and th is not None and th is not threading.current_thread():
            th.join(timeout)
        self.check()

    def wait(self, timeout: float = JOIN_TIMEOUT_S):
        """Join a running solve; raise if it does not end within `timeout`
        or if it failed."""
        th = self._thread
        if th is not None and th is not threading.current_thread():
            th.join(timeout)
            if th.is_alive():
                raise TimeoutError(f"the global BA thread still runs after {timeout} s")
        self.check()

    def launch(self, n_iters: int = 10):
        """Snapshot, solve and merge a whole-map BA. A running solve is
        stopped first, without a join: it ends at its next poll or is voided
        at its merge, so a launch under the map lock never waits for it."""
        self.check()
        with self._meta_lock:
            self._gen += 1
            self._stop.set()
            stop = threading.Event()
            self._stop = stop
            gen = self._gen
        with self.lock:
            snap = self._snapshot()
        if snap is None:
            return
        if not self.async_mode:
            self._solve_and_merge(snap, n_iters, stop, gen)
            return
        self._thread = threading.Thread(target=self._run, args=(snap, n_iters, stop, gen),
                                        name="global-ba", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------

    def _snapshot(self):
        # host tensors: the solve uploads them on its own thread's stream
        built = build_global_ba_problem(self.map, "cpu")
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

    def _run(self, snap, n_iters: int, stop: threading.Event, gen: int):
        """The solving thread. It launches on a stream of its own, drained
        before the thread ends: an interrupted solve leaves work queued on
        tensors the thread is about to free."""
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        try:
            with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                try:
                    self._solve_and_merge(snap, n_iters, stop, gen)
                finally:
                    if stream is not None:
                        stream.synchronize()
        except BaseException as e:   # kept for the caller's thread: check()
            with self._meta_lock:
                if self._error is None:
                    self._error = e

    def _solve_and_merge(self, snap, n_iters: int, stop: threading.Event, gen: int):
        def stop_check():
            if self._chunk_hook is not None:
                self._chunk_hook()
            return stop.is_set()

        prob = BAProblem(*(t.to(self.device) for t in snap["prob"]))
        result = solve_global_ba(prob, self.config.camera, self.inv_sigma2, n_iters=n_iters,
                                 stop_check=stop_check if self.async_mode else None)
        if result is None:       # interrupted: discarded, as the reference's
            with self._meta_lock:
                self.n_aborted += 1
            return
        cam_new, pts_new = result
        with self.lock:
            # a newer launch or stop voided this solve while it ran or while
            # it waited for the lock
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
        cam_free = snap["prob"].cam_free.numpy()

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
