"""Asynchronous mapping pipeline.

Counterpart of orb_slam2_detailed_comments_tpu/backend/async_pipeline.py.
It keeps the reference's thread topology: tracking in the caller's thread,
local mapping and loop closing on a worker that consumes a keyframe queue
with back-pressure (reference: System.cc:133-152, LocalMapping.cc:176-190,
mlNewKeyFrames and SetAcceptKeyFrames): the tracker inserts keyframes
freely only while the worker is idle, so it keeps to the worker's pace.
The default pipeline is synchronous and deterministic; this one overlaps
the tracking thread's frames with the worker's mapping.

One reentrant map lock guards the map, coarser than the reference's ten
mutexes. The worker holds it to prepare a keyframe (culling,
triangulation, fusion and the local-BA window's snapshot), releases it for
the local-BA solve, and takes it again to merge the solve and finish the
keyframe (keyframe culling, loop closing); the merge discards a solve the
map moved under (backend/local_mapping.py). While keyframes wait, the
mapper defers a keyframe's fusion, local BA and culling, as the
reference's does, and a running local BA skips its second phase. The
tracking thread extracts its frame outside the lock and re-poses its last
frame when the map moved under it (frontend/tracking.py).

The worker launches its CUDA work on a stream of its own. The keyframes
reach it as host arrays in the map store, what it hands back is host
arrays too, and the vocabularies keep their words on the host (each call
uploads them on its caller's stream), so no device tensor crosses between
the two threads.

The tracker resets the map inside a frame's call, under the map lock
(LOST with a tiny map, a rejected monocular initialization). reset()
then drops the queued keyframes and voids the one in process instead of
waiting for the worker, which needs that lock for its next step.

No failure ends the worker silently: its first exception is kept, the
worker drops the keyframes queued after it, and the exception is raised on
the caller's thread by the next on_new_keyframe, wait_idle, shutdown or
check(). Every wait has a timeout and raises when it runs out.
"""
from __future__ import annotations

import contextlib
import queue
import threading
from typing import Optional

import torch

WAIT_TIMEOUT_S = 600.0   # the longest wait for the worker to drain its queue


class AsyncLocalMapper:
    """Wraps a LocalMapper and runs its keyframes on a worker thread."""

    def __init__(self, mapper, map_lock):
        self.mapper = mapper
        self.lock = map_lock
        self.queue: "queue.Queue" = queue.Queue()
        self._cv = threading.Condition()
        self._pending = 0          # keyframes queued or in process
        self._error: Optional[BaseException] = None
        self._gen = 0              # moved by reset(): older queued keyframes are void
        # "another keyframe waits" (reference: InsertKeyFrame sets mbAbortBA,
        # LocalMapping.cc:954-957; CheckNewKeyFrames): a running local BA
        # skips its second phase, and the mapper defers the fusion, local BA
        # and culling of the keyframe it prepares
        mapper.abort_ba_check = lambda: not self.queue.empty()
        self.n_processed = 0       # keyframes the worker finished
        dev = mapper.device
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self._thread = threading.Thread(target=self._run, name="local-mapping", daemon=True)
        self._thread.start()

    # ---- the LocalMapper surface ---------------------------------------

    @property
    def loop_closer(self):
        return self.mapper.loop_closer

    @loop_closer.setter
    def loop_closer(self, lc):
        self.mapper.loop_closer = lc

    @property
    def map(self):
        return self.mapper.map

    @map.setter
    def map(self, m):
        self.mapper.map = m

    def __getattr__(self, name):
        # the rest of the LocalMapper surface: the loop closer calls back into
        # the mapper (_fuse in loop fusion) and holds this wrapper in async
        # mode (in the JAX package a missing _fuse once crashed loop
        # correction on the worker)
        return getattr(object.__getattribute__(self, "mapper"), name)

    def on_new_keyframe(self, kf: int, run_ba: bool = True):
        """Queue a keyframe (the tracker calls this under the map lock)."""
        self.check()
        with self._cv:
            self._pending += 1
        with self.lock:
            self.mapper.pending.add(kf)
            gen = self._gen
        self.queue.put((kf, run_ba, gen))

    def global_ba(self, n_iters: int = 10):
        with self.lock:
            self.mapper.global_ba(n_iters)

    def reset(self):
        """Drop the queued keyframes and void the one in process, then reset
        the mapper (reference: LocalMapping::ResetIfRequested clears its
        queue). The tracker resets inside a frame's call, under the map
        lock that the worker needs for its next step, so nothing here waits
        for the worker: it skips whatever was queued before the reset."""
        with self.lock:
            self._gen += 1
            self.mapper.pending.clear()
            self.mapper.reset()

    # ---- the queue -----------------------------------------------------

    def queue_len(self) -> int:
        """Keyframes waiting (reference: KeyframesInQueue)."""
        return self.queue.qsize()

    def accept_keyframes(self) -> bool:
        """The back-pressure signal: the worker is idle, no keyframe queued
        or in process (reference: LocalMapping::AcceptKeyFrames is false
        while the mapper works on a keyframe, Tracking.cc:1703-1737). While
        it is busy the tracker inserts only a keyframe it needs (c1a, c1c),
        and stereo and RGB-D only while fewer than three wait
        (Tracking.cc:1744-1760). The JAX package's "fewer than three
        queued" kept the tracker at its synchronous keyframe rate and the
        worker a keyframe or two behind it (ROADMAP.md C.18)."""
        return self._pending == 0

    def check(self):
        """Raise the worker's first exception, if it failed."""
        if self._error is not None:
            raise RuntimeError("the local-mapping worker failed") from self._error

    def wait_idle(self, timeout: float = WAIT_TIMEOUT_S):
        """Wait until every queued keyframe is processed; raise if that takes
        longer than `timeout` or if the worker failed."""
        with self._cv:
            done = self._cv.wait_for(lambda: self._pending == 0, timeout)
        self.check()
        if not done:
            raise TimeoutError(f"the local-mapping worker is still busy after {timeout} s")

    def shutdown(self, timeout: float = WAIT_TIMEOUT_S):
        """Drain the queue, stop the worker and join it."""
        if self._thread.is_alive():
            try:
                self.wait_idle(timeout)
            finally:
                self.queue.put(None)
                self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(f"the local-mapping worker did not stop within {timeout} s")
        self.check()

    # ---- the worker ----------------------------------------------------

    def _run(self):
        with torch.cuda.stream(self._stream) if self._stream is not None \
                else contextlib.nullcontext():
            while True:
                item = self.queue.get()
                if item is None:
                    return
                try:
                    if self._error is None:
                        self._process(*item)
                except BaseException as e:   # kept for the caller's thread: check()
                    self._error = e
                finally:
                    with self._cv:
                        self._pending -= 1
                        self._cv.notify_all()

    def _process(self, kf: int, run_ba: bool, gen: int):
        m = self.mapper
        with self.lock:
            if gen != self._gen:      # queued before a reset
                return
            m.pending.discard(kf)
            built = m.prepare_keyframe(kf, run_ba=run_ba)
        # the local-BA solve reads only the snapshot: outside the lock
        result = m._solve_local_ba(built) if built is not None else None
        with self.lock:
            if gen != self._gen:      # the map was reset during the solve
                return
            if result is not None:
                m._merge_local_ba(built, result)
            m.finish_keyframe(kf)
        self.n_processed += 1
