"""Top-level System API.

Counterpart of orb_slam2_detailed_comments_tpu/system.py, the replacement
of ORB_SLAM2::System (reference: src/System.h:70-160, src/System.cc): it
builds the map, vocabulary, keyframe database and the pipeline stages,
dispatches frames per sensor, and supports localization-only mode, reset,
map checkpoints and trajectory export.

By default the stages run synchronously per keyframe, as in the JAX
package's default: the Tracker, then on each new keyframe the LocalMapper
(culling, triangulation, fusion, local BA, keyframe culling) and the
LoopCloser (loop detection, Sim3, loop correction and the global BA after
a loop, through the inline GlobalBARunner), and the Relocalizer on LOST.
With enable_loop_closing=False a keyframe indexer takes the loop closer's
place and keeps the keyframe database fed.

async_mapping=True is the reference's thread topology (System.cc:133-152):
the LocalMapper and the LoopCloser run on the worker of
backend/async_pipeline.AsyncLocalMapper and the global BA after a loop on
a thread of its own (GlobalBARunner(async_mode=True)), all three sharing
one reentrant map lock with the Tracker. A failure on either thread is
raised by the next track_* call, and shutdown() joins both with timeouts.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional

import numpy as np

from .backend.async_pipeline import AsyncLocalMapper
from .backend.gba_runner import GlobalBARunner
from .backend.local_mapping import LocalMapper
from .backend.loop_closing import LoopCloser
from .backend.relocalization import Relocalizer
from .frontend.tracking import Sensor, Tracker, TrackingState
from .io.trajectory import (save_keyframe_trajectory_tum, save_trajectory_kitti,
                            save_trajectory_tum)
from .place.kf_database import KeyFrameDatabase
from .place.vocabulary import BinaryVocabulary
from .state.map_store import MapStore
from .utils.config import SlamConfig, load_settings_yaml

# The shipped vocabulary (the reference always loads a pre-trained
# ORBvoc.txt, System.cc:78-94): a byte copy of the JAX package's
# data/default_vocab.npz, loaded once per process.
DEFAULT_VOCAB_PATH = os.path.join(os.path.dirname(__file__), "data", "default_vocab.npz")
_default_vocab_cache = None


def load_default_vocabulary():
    """The shipped k-ary tree vocabulary, or None if the package data file
    is absent (then System falls back to online self-training)."""
    global _default_vocab_cache
    if _default_vocab_cache is None and os.path.exists(DEFAULT_VOCAB_PATH):
        from .place.vocabulary_tree import TreeVocabulary
        _default_vocab_cache = TreeVocabulary.load(DEFAULT_VOCAB_PATH)
    return _default_vocab_cache


class _KeyFrameIndexer:
    """Indexes every new keyframe into the KeyFrameDatabase when loop
    closing is disabled. In the reference the LoopClosing thread does this
    add unconditionally (LoopClosing.cc:378-380); relocalization depends on
    the inverted index whether or not loops are closed."""

    def __init__(self, map_store, voc, kfdb):
        self.map = map_store
        self.voc = voc
        self.kfdb = kfdb

    def on_new_keyframe(self, kf: int):
        _, bow = self.voc.transform(self.map.kf_desc[kf], self.map.kf_kp_valid[kf])
        self.kfdb.add(int(kf), bow)


class System:
    def __init__(self, config: SlamConfig, sensor: Sensor,
                 vocabulary: Optional[BinaryVocabulary] = None,
                 enable_loop_closing: bool = True,
                 enable_global_ba_on_loop: bool = True,
                 async_mapping: bool = False, device="cuda"):
        self.config = config
        self.sensor = sensor
        self.device = device
        self.map = MapStore(config)
        self.async_mapping = async_mapping
        self._map_lock = threading.RLock() if async_mapping else contextlib.nullcontext()

        # Vocabulary resolution order (the reference loads a pre-trained
        # ORBvoc.txt unconditionally, System.cc:78-94):
        #   1. an explicit instance passed by the caller
        #   2. the shipped default tree vocabulary (package data)
        #   3. vocabulary="online": self-train from the first keyframes'
        #      descriptors (also the fallback when the data file is absent)
        if vocabulary is None:
            vocabulary = load_default_vocabulary()
        elif vocabulary == "online":
            vocabulary = None
        self.voc = vocabulary
        self.kfdb: Optional[KeyFrameDatabase] = None
        self.loop_closer: Optional[LoopCloser] = None
        self.relocalizer = None
        self._enable_loop = enable_loop_closing
        self._enable_gba = enable_global_ba_on_loop
        self._pending_voc_train = vocabulary is None
        self._voc_min_kfs = 3

        self.local_mapper = LocalMapper(config, self.map,
                                        monocular=(sensor == Sensor.MONOCULAR), device=device)
        if async_mapping:
            self.local_mapper = AsyncLocalMapper(self.local_mapper, self._map_lock)
        # the global BA after a loop (reference: LoopClosing.cc:962-965):
        # inline, snapshot, solve and merge in the loop closer's call; async,
        # the solve on a thread of its own
        self.gba_runner = GlobalBARunner(
            config, self.map, async_mode=async_mapping, device=device,
            map_lock=self._map_lock if async_mapping else None)
        if self.voc is not None:
            self._wire_place_recognition()
        # _wire_place_recognition runs before the tracker exists (a
        # pre-trained vocabulary) or after it (online self-training): the
        # relocalizer is handed over on both paths
        self.tracker = Tracker(config, self.map, sensor, local_mapper=self.local_mapper,
                               relocalizer=self.relocalizer, device=device)
        self.tracker.map_lock = self._map_lock
        self.tracker.gba_runner = self.gba_runner

    # ------------------------------------------------------------------

    @classmethod
    def from_settings_yaml(cls, path: str, sensor: Sensor, **kwargs) -> "System":
        return cls(load_settings_yaml(path), sensor, **kwargs)

    def _wire_place_recognition(self):
        self.kfdb = KeyFrameDatabase(self.voc, self.config.max_keyframes)
        self.relocalizer = Relocalizer(self.config, self.map, self.voc, self.kfdb,
                                       device=self.device)
        if self._enable_loop:
            self.loop_closer = LoopCloser(
                self.config, self.map, self.voc, self.kfdb,
                fix_scale=(self.sensor != Sensor.MONOCULAR), local_mapper=self.local_mapper,
                run_global_ba=self._enable_gba, gba_runner=self.gba_runner, device=self.device)
            self.local_mapper.loop_closer = self.loop_closer
        else:
            # keep the relocalization inverted index fed without a loop closer
            self.local_mapper.loop_closer = _KeyFrameIndexer(self.map, self.voc, self.kfdb)
        # index the keyframes that already exist (online training wires up
        # after the first keyframes); the loop closer keeps their bags sparse
        for k in self.map.keyframe_ids():
            k = int(k)
            _, bow = self.voc.transform(self.map.kf_desc[k], self.map.kf_kp_valid[k])
            self.kfdb.add(k, bow)
            if self.loop_closer is not None:
                ids = np.nonzero(bow > 0)[0]
                self.loop_closer.kf_bow[k] = (ids, bow[ids])
        if hasattr(self, "tracker"):
            self.tracker.relocalizer = self.relocalizer

    def _maybe_train_vocabulary(self):
        """Self-train the BoW vocabulary once enough map data exists."""
        # count allocated (not surviving) keyframes: culling may keep the
        # live set small while plenty of descriptors exist for training
        if not self._pending_voc_train or self.map.n_kf < self._voc_min_kfs:
            return
        with self._map_lock:      # the worker may be changing the map
            train = np.concatenate([self.map.kf_desc[k][self.map.kf_kp_valid[k]]
                                    for k in self.map.keyframe_ids()], axis=0)
            n_words = int(min(2048, max(256, len(train) // 8)))
            self.voc = BinaryVocabulary.train(train, n_words=n_words, n_iters=3,
                                              device=self.device)
            self._pending_voc_train = False
            self._wire_place_recognition()

    def _check_threads(self):
        """Raise a failure of the mapping worker or the global-BA thread."""
        if self.async_mapping:
            self.local_mapper.check()
        self.gba_runner.check()

    # ------------------------------------------------------------------
    # frame dispatch (reference: System::TrackMonocular/Stereo/RGBD)
    # ------------------------------------------------------------------

    def track_monocular(self, img: np.ndarray, timestamp: float):
        self._check_threads()
        out = self.tracker.track_monocular(img, timestamp)
        self._maybe_train_vocabulary()
        return out

    def track_stereo(self, left: np.ndarray, right: np.ndarray, timestamp: float):
        self._check_threads()
        out = self.tracker.track_stereo(left, right, timestamp)
        self._maybe_train_vocabulary()
        return out

    def track_rgbd(self, img: np.ndarray, depth: np.ndarray, timestamp: float):
        self._check_threads()
        out = self.tracker.track_rgbd(img, depth, timestamp)
        self._maybe_train_vocabulary()
        return out

    # ------------------------------------------------------------------
    # mode switches (reference: System.cc:287-334)
    # ------------------------------------------------------------------

    def activate_localization_mode(self):
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self.tracker.localization_only = False
        self.tracker.vo_mode = False

    def _quiesce(self):
        """Let the worker finish its queue and stop a running global BA."""
        if self.async_mapping:
            self.local_mapper.wait_idle()
        self.gba_runner.request_stop(join=True)

    def reset(self):
        self._quiesce()
        with self._map_lock:
            self.tracker.reset()
            if self.loop_closer is not None:
                self.loop_closer.reset()
            elif self.kfdb is not None:
                self.kfdb.clear()

    def shutdown(self):
        """Join the mapping worker, then a running global BA (reference:
        System::Shutdown, System.cc:444-473), each with a timeout; raise a
        failure of either thread."""
        try:
            if self.async_mapping:
                self.local_mapper.shutdown()
        finally:
            self.gba_runner.wait()

    # ------------------------------------------------------------------
    # introspection (reference: GetTrackingState/GetTrackedMapPoints)
    # ------------------------------------------------------------------

    @property
    def tracking_state(self) -> TrackingState:
        return self.tracker.state

    def n_tracked_points(self) -> int:
        fr = self.tracker.last_frame
        if fr is None or fr.mp is None:
            return 0
        return int(((fr.mp >= 0) & ~fr.is_outlier).sum())

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    def save_trajectory_tum(self, path: str):
        save_trajectory_tum(path, self.tracker.trajectory, self.map)

    def save_trajectory_kitti(self, path: str):
        save_trajectory_kitti(path, self.tracker.trajectory, self.map)

    def save_keyframe_trajectory_tum(self, path: str):
        save_keyframe_trajectory_tum(path, self.map)

    def save_map(self, path: str):
        """Full-map checkpoint (the reference left SaveMap as a TODO,
        System.h:149-152)."""
        np.savez_compressed(path, **self.map.checkpoint())

    def load_map(self, path: str):
        """Restore a checkpoint, after the worker has drained its queue and a
        running global BA has stopped. The device mirrors of the old map (the
        mapper's keyframe store, the tracker's local map) are dropped, so
        no keyframe id keeps the old map's keypoints."""
        data = dict(np.load(path, allow_pickle=False))
        self._quiesce()
        with self._map_lock:
            self.map = MapStore.restore(self.config, data)
            self.local_mapper.map = self.map
            self.local_mapper.reset()
            self.gba_runner.map = self.map
            self.tracker.map = self.map
            if self.tracker._dev_map is not None:
                self.tracker._dev_map.invalidate()
            if self.relocalizer is not None:
                self.relocalizer.map = self.map
            if self.kfdb is not None:
                self.local_mapper.loop_closer.map = self.map
