"""Per-frame tracking front end.

Counterpart of orb_slam2_detailed_comments_tpu/frontend/tracking.py (the
replacement of the reference Tracking thread, src/Tracking.cc). The state
machine, decision rules and thresholds follow the JAX package line for
line; the compute runs as torch ops and the port's CUDA kernels on
`device`:

  Track (reference Tracking.cc:428-790)
  ├─ [uninit] monocular / stereo initialization  (:797, :903)
  ├─ TrackWithMotionModel / TrackReferenceKeyFrame (:1399, :1196)
  │    (projection search / brute-force descriptor matching + pose-only GN)
  ├─ Relocalization on LOST (:2245) — delegated to the `relocalizer` hook
  ├─ TrackLocalMap (:1514): covisibility local map -> frustum cull ->
  │    projection search -> pose-only GN
  └─ NeedNewKeyFrame / CreateNewKeyFrame (:1600, :1753)

Host numpy orchestrates, as in the JAX package: every numpy array handed
to a device op becomes a tensor on `device`, and every result comes back
with `.cpu().numpy()` (descriptors through interop.desc_to_numpy: the map
store keeps uint32 words, the tensors their int32 bit-view). The JAX
package's environment switches are constructor arguments here:
`use_fused` (ORB_FUSED_TRACK, on by default, as on the TPU) and `debug`
(ORB_TRACK_DEBUG). `local_mapper` and `relocalizer` are optional hooks.
"""
from __future__ import annotations

import contextlib
import enum
from typing import Optional

import numpy as np
import torch

from ..geometry.se3 import se3_inverse_np, se3_renormalize_np
from ..interop import desc_to_numpy, desc_to_torch
from ..io.trajectory import resolve_ref
from ..models.slam_step import (Extracted, extract_mono, extract_rgbd, extract_stereo,
                                track_extracted, unpack_host_blob)
from ..ops import matching as M
from ..optim.pose_gn import pose_optimization
from ..solvers.initializer import initialize_two_view
from ..state.frame import FrameData
from ..state.map_store import MapStore
from ..utils import counters
from ..utils.config import SlamConfig
from ..utils.timing import StageTimer
from .device_map import DeviceLocalMap

LOCAL_MP_CAP = 8192  # fixed device capacity for the tracking local map


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


class Tracker:
    def __init__(self, config: SlamConfig, map_store: MapStore, sensor: Sensor,
                 local_mapper=None, relocalizer=None, use_fused: bool = True,
                 debug: bool = False, device="cuda"):
        self.config = config
        self.map = map_store
        self.sensor = sensor
        self.local_mapper = local_mapper      # a local mapper or None
        self.relocalizer = relocalizer        # callable(frame) -> bool, or None
        self.device = torch.device(device)
        self.debug = debug
        self.state = TrackingState.NO_IMAGES_YET
        self.timer = StageTimer()
        self.map_lock = contextlib.nullcontext()  # an async caller sets a real lock
        self.gba_runner = None    # a GlobalBARunner whose running solve a reset stops
        # the last logged frame's id, reference keyframe, that keyframe's pose
        # (resolved through culled ones) and the map's pose_epoch at its log
        self._last_ref = None

        orb = config.orb
        self.scale_factors = np.array([orb.scale_factor ** i for i in range(orb.n_levels)], np.float32)
        self.inv_sigma2 = (1.0 / self.scale_factors ** 2).astype(np.float32)
        self.log_scale = float(np.log(orb.scale_factor))
        self._scale_factors_t = self._t(self.scale_factors)
        self._inv_sigma2_t = self._t(self.inv_sigma2)

        self.frame_id = 0
        self.last_frame: Optional[FrameData] = None
        self.init_frame: Optional[FrameData] = None   # mono init reference
        self.velocity: Optional[np.ndarray] = None    # Tcl: last->current
        self.last_kf_id = -1
        self.last_kf_frame_id = -1
        self.last_reloc_frame_id = -1000000
        self._lost_streak = 0
        # per-frame relative pose log for trajectory export
        # (reference: Tracking.cc:763-788 mlRelativeFramePoses)
        self.trajectory: list = []   # (frame_id, ts, Tcr, ref_kf, lost)
        self.localization_only = False
        # localization-only degraded "visual odometry" state (reference:
        # mbVO, Tracking.cc:520-624)
        self.vo_mode = False

        # depth threshold for close/far stereo points
        self.th_depth = config.th_depth * config.camera.baseline if config.camera.bf > 0 else np.inf

        # fused frame path: one frame program per steady-state frame against
        # the device-resident local map. The staged path remains for every
        # non-steady state (init, LOST/reloc, localization/VO mode, post-
        # reloc grace) and as the in-frame fallback when the fused gate fails.
        self.use_fused = use_fused
        self._dev_map: Optional[DeviceLocalMap] = None
        self.fused_frames = 0
        self.staged_frames = 0

    # ------------------------------------------------------------------
    # host <-> device
    # ------------------------------------------------------------------

    def _t(self, a, dtype=None) -> torch.Tensor:
        """numpy (or a tensor: a caller may stage its images on the device a
        frame ahead) -> tensor on the tracker's device."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device, dtype)
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def _desc(self, a) -> torch.Tensor:
        """uint32 descriptor words -> int32 bit-view tensor on the device."""
        return desc_to_torch(a, self.device)

    def _dbg(self, msg: str):
        if self.debug:
            print(f"  [trk] {msg}", flush=True)

    # ------------------------------------------------------------------
    # frame construction
    # ------------------------------------------------------------------

    def _extract(self, img, n_features=0, img_right=None, depth=None) -> Extracted:
        """The frame's features on the device (the Frame constructor's
        extraction, Frame.cc:53-430). It reads no map: in async mode the
        tracking thread runs it outside the map lock, as the reference
        builds its Frame before Track takes the map lock (Tracking.cc:273)."""
        orb, cam = self.config.orb, self.config.camera
        # images go to the device in their native dtype (uint8 stays uint8);
        # the extraction casts to float32 there
        if img_right is not None:
            # L/R as one leading-axis batch (the reference runs two
            # extraction threads, Frame.cc:158-164)
            return extract_stereo(torch.stack([self._t(img), self._t(img_right)]), orb, cam,
                                  n_features)
        if depth is not None:
            return extract_rgbd(self._t(img), self._t(depth, torch.float32), orb, cam)
        return extract_mono(self._t(img), orb, cam, n_features)

    def _build_frame(self, img, timestamp, n_features=0, img_right=None, depth=None) -> FrameData:
        """Frame constructor (reference: Frame.cc:53-430)."""
        return self._frame_from_extracted(self._extract(img, n_features, img_right, depth),
                                          timestamp)

    def _frame_from_extracted(self, e: Extracted, timestamp) -> FrameData:
        f = FrameData(
            frame_id=self.frame_id,
            timestamp=timestamp,
            xy=e.xy_und.cpu().numpy(),
            response=e.kp.response.cpu().numpy(),
            octave=e.kp.octave.cpu().numpy(),
            angle=e.kp.angle.cpu().numpy(),
            desc=desc_to_numpy(e.kp.desc),
            valid=e.kp.valid.cpu().numpy(),
            ur=e.ur.cpu().numpy(),
            depth=e.depth.cpu().numpy(),
        )
        self.frame_id += 1
        return f

    # ------------------------------------------------------------------
    # public entry points (reference: GrabImageMonocular/Stereo/RGBD)
    # ------------------------------------------------------------------

    def track_monocular(self, img, timestamp) -> Optional[np.ndarray]:
        if self._fused_eligible():
            return self._track_fused(timestamp, img=img)
        n_feat = 0
        if self.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
            n_feat = 2 * self.config.orb.n_features  # reference: Tracking.cc:180-182
        with self.timer.stage("frame_build"):
            frame = self._build_frame(img, timestamp, n_feat)
        return self._track(frame)

    def track_stereo(self, img_left, img_right, timestamp) -> Optional[np.ndarray]:
        if self._fused_eligible():
            return self._track_fused(timestamp, img=img_left, img_right=img_right)
        with self.timer.stage("frame_build"):
            frame = self._build_frame(img_left, timestamp, 0, img_right=img_right)
        return self._track(frame)

    def track_rgbd(self, img, depth, timestamp) -> Optional[np.ndarray]:
        if self._fused_eligible():
            return self._track_fused(timestamp, img=img, depth=depth)
        with self.timer.stage("frame_build"):
            frame = self._build_frame(img, timestamp, 0, depth=depth)
        return self._track(frame)

    # ------------------------------------------------------------------
    # fused steady-state frame path
    # ------------------------------------------------------------------

    def _fused_eligible(self) -> bool:
        return (self.use_fused
                and self.state == TrackingState.OK
                and not self.localization_only
                and self.velocity is not None
                and self.last_frame is not None
                and self.frame_id >= self.last_reloc_frame_id + 2)

    def _track_fused(self, timestamp, img=None, img_right=None, depth=None):
        """One frame program: two-stage tracking against the device-resident
        local map (models/slam_step.fused_*_frame + DeviceLocalMap). Falls
        back to the staged state machine, on the same extracted frame,
        whenever the local map is too thin or the inlier gate fails. The
        extraction half runs first, outside the map lock."""
        with self.timer.stage("extract"):
            feats = self._extract(img, 0, img_right, depth)
        with self.map_lock:
            self._update_last_frame()
            # local-map set from the last frame's final associations
            kf_ids, ref_kf = self.map.local_keyframes(self.last_frame.mp)
            mp_ids = (self.map.points_of_keyframes(kf_ids)
                      if kf_ids.size else np.empty(0, np.int64))
            if mp_ids.size < 50:
                self.staged_frames += 1
                return self._track(self._frame_from_extracted(feats, timestamp))
            self.fused_frames += 1
            mp_ids = counters.keep_best_observed(
                mp_ids, self.map.mp_n_obs, LOCAL_MP_CAP, "tracking.local_map")
            if self._dev_map is None:
                self._dev_map = DeviceLocalMap(LOCAL_MP_CAP, self.device)
            with self.timer.stage("map_refresh"):
                self._dev_map.refresh(self.map, mp_ids)

            Tcw_pred = self._t(se3_renormalize_np(
                (self.velocity @ self.last_frame.Tcw).astype(np.float32)))
            dm = self._dev_map
            cam, orb = self.config.camera, self.config.orb
            mono = self.sensor == Sensor.MONOCULAR
            with self.timer.stage("fused_frame"):
                # the tight search radius: 3 for RGB-D, 1 otherwise
                # (Tracking.cc:1943-1944)
                blob, desc_dev = track_extracted(
                    feats, Tcw_pred, dm.d_packed, dm.d_desc, dm.d_valid, orb, cam,
                    float("inf") if mono else float(self.th_depth),
                    3.0 if depth is not None else 1.0, check_stereo=not mono)
                # one blocking pull for the whole host bundle
                b, ts_, vis = unpack_host_blob(blob.cpu().numpy(), orb.max_keypoints)

            frame = self._frame_from_fused(timestamp, b, desc_dev, ts_)
            stats = ts_[16:21].astype(np.int64)
            n_in = int(stats[0])
            frame.ref_kf = int(ref_kf)

            # visibility/found bookkeeping (reference: Tracking.cc
            # 1880-1930 IncreaseVisible on in-frustum points)
            seen = vis & (dm.slot_mp >= 0)
            self.map.increase_visible(dm.slot_mp[seen])

            min_inliers = 50 if frame.frame_id < self.last_reloc_frame_id + int(self.config.fps) else 30
            self._dbg(f"fused: mps={mp_ids.size} up={dm.last_rows_uploaded} "
                      f"in1={int(stats[4])} inliers={n_in} (need {min_inliers})")
            if n_in < min_inliers:
                # fused gate failed: run the staged cascade on this frame
                frame.ensure_desc()
                frame.mp[:] = -1
                frame.is_outlier[:] = False
                return self._track_locked(frame)

            return self._finish_tracked_frame(frame)

    def _frame_from_fused(self, timestamp, b, desc_dev, ts_) -> FrameData:
        """Decode the packed host bundle into a FrameData. Columns:
        [x, y, ur, depth, response, angle, octave, valid, slot, inlier]."""
        slot = b[:, 8].astype(np.int32)
        has = slot >= 0
        mp = np.where(has, self._dev_map.slot_mp[np.maximum(slot, 0)], -1).astype(np.int32)
        inl = b[:, 9] > 0.5
        f = FrameData(
            frame_id=self.frame_id,
            timestamp=timestamp,
            xy=np.ascontiguousarray(b[:, 0:2]),
            response=np.ascontiguousarray(b[:, 4]),
            octave=b[:, 6].astype(np.int32),
            angle=np.ascontiguousarray(b[:, 5]),
            desc=desc_dev,          # device tensor; ensure_desc() pulls it lazily
            valid=b[:, 7] > 0.5,
            ur=np.ascontiguousarray(b[:, 2]),
            depth=np.ascontiguousarray(b[:, 3]),
            Tcw=np.ascontiguousarray(ts_[:16].reshape(4, 4)),
            mp=mp,
        )
        f.is_outlier = (mp >= 0) & ~inl
        self.frame_id += 1
        return f

    def _finish_tracked_frame(self, frame: FrameData):
        """Post-success bookkeeping shared with the staged path's tail
        (velocity update, keyframe decision, outlier drop, trajectory)."""
        self.state = TrackingState.OK
        self._lost_streak = 0
        matched = (frame.mp >= 0) & ~frame.is_outlier
        self.map.increase_found(frame.mp[matched])
        if self.last_frame is not None and self.last_frame.Tcw is not None:
            Twc_last = se3_inverse_np(self.last_frame.Tcw)
            self.velocity = se3_renormalize_np(frame.Tcw @ Twc_last)
        if not self.localization_only and self._need_new_keyframe(frame):
            with self.timer.stage("create_keyframe"):
                frame.ensure_desc()
                self._create_new_keyframe(frame)
        frame.mp[frame.is_outlier] = -1
        frame.is_outlier[:] = False
        self._log_trajectory(frame, lost=False)
        self.last_frame = frame
        return frame.Tcw

    # ------------------------------------------------------------------
    # main state machine (reference: Tracking::Track, Tracking.cc:428-790)
    # ------------------------------------------------------------------

    def _track(self, frame: FrameData) -> Optional[np.ndarray]:
        with self.map_lock:
            return self._track_locked(frame)

    def _update_last_frame(self):
        """Re-pose the last frame on its reference keyframe when the whole map
        moved (a loop correction or a global-BA merge: pose_epoch) after the
        frame was logged (reference: Tracking::UpdateLastFrame,
        Tracking.cc:1277-1397, re-poses it every frame). In the asynchronous
        pipeline such a move lands between two frames; without this the
        motion model predicts from the old map, and the last frame's close
        points, placed from its old pose, pull the pose back into it. In the
        synchronous pipeline the map moves only inside a frame's own call,
        before its log, so the JAX package's behaviour, which lacks the
        step, is kept bit for bit (ROADMAP.md C.15)."""
        lf = self.last_frame
        if lf is None or lf.Tcw is None or self._last_ref is None:
            return
        frame_id, ref, T_logged, epoch = self._last_ref
        if frame_id != lf.frame_id or epoch == self.map.pose_epoch:
            return
        Tcorr, live = resolve_ref(self.map, ref)
        if live < 0:
            return
        T_now = Tcorr @ self.map.kf_Tcw[live]
        lf.Tcw = (lf.Tcw @ se3_inverse_np(T_logged) @ T_now).astype(np.float32)
        self._last_ref = (frame_id, ref, T_now, self.map.pose_epoch)

    def _track_locked(self, frame: FrameData) -> Optional[np.ndarray]:
        self._update_last_frame()
        if self.state == TrackingState.NO_IMAGES_YET:
            self.state = TrackingState.NOT_INITIALIZED

        if self.state == TrackingState.NOT_INITIALIZED:
            if self.sensor == Sensor.MONOCULAR:
                self._monocular_initialization(frame)
            else:
                self._stereo_initialization(frame)
            self.last_frame = frame
            if self.state != TrackingState.OK:
                return None
            self._log_trajectory(frame, lost=False)
            return frame.Tcw

        ok = False
        with self.timer.stage("track_frame"):
            if self.state == TrackingState.OK:
                self._check_replaced_last_frame()
                if self.localization_only:
                    ok = self._track_localization(frame)
                elif self.velocity is None or frame.frame_id < self.last_reloc_frame_id + 2:
                    ok = self._track_reference_keyframe(frame)
                else:
                    ok = self._track_with_motion_model(frame)
                    if not ok:
                        ok = self._track_reference_keyframe(frame)
            else:  # LOST
                ok = self._relocalize(frame)

        # refine against the local map, in localization mode too whenever
        # not in degraded VO (reference: Tracking.cc:640-649)
        if ok and (not self.localization_only or not self.vo_mode):
            with self.timer.stage("track_local_map"):
                if self.localization_only:
                    # a local map too thin to refine against degrades to VO
                    # on the unrefined pose instead of going LOST
                    saved = (frame.Tcw.copy(), frame.mp.copy(), frame.is_outlier.copy())
                    if not self._track_local_map(frame):
                        frame.Tcw, frame.mp, frame.is_outlier = saved
                        self.vo_mode = True
                else:
                    ok = self._track_local_map(frame)

        if ok:
            self.state = TrackingState.OK
            self._lost_streak = 0
            # motion model: velocity = Tcw_cur * Twc_last, renormalized
            if self.last_frame is not None and self.last_frame.Tcw is not None:
                Twc_last = se3_inverse_np(self.last_frame.Tcw)
                self.velocity = se3_renormalize_np(frame.Tcw @ Twc_last)
            if not self.localization_only and self._need_new_keyframe(frame):
                with self.timer.stage("create_keyframe"):
                    self._create_new_keyframe(frame)
            # drop outlier associations (reference: Tracking.cc:691-719)
            frame.mp[frame.is_outlier] = -1
            frame.is_outlier[:] = False
        else:
            self.state = TrackingState.LOST
            self.velocity = None
            self._lost_streak += 1
            # reset when lost with a tiny map (reference: Tracking.cc:744-753),
            # after a one-second relocalization window (fps frames)
            if (self.map.n_keyframes() <= 5 and not self.localization_only
                    and self._lost_streak > int(self.config.fps)):
                self._dbg(f"auto-reset: LOST {self._lost_streak} frames with "
                          f"{self.map.n_keyframes()} live keyframes")
                self.reset()
                return None

        self._log_trajectory(frame, lost=not ok)
        self.last_frame = frame
        return frame.Tcw if ok else None

    def _log_trajectory(self, frame, lost: bool):
        ref = frame.ref_kf if frame.ref_kf >= 0 else self.last_kf_id
        if frame.Tcw is not None and ref >= 0:
            Trw = self.map.kf_Tcw[ref]
            Tcr = frame.Tcw @ se3_inverse_np(Trw)
        else:
            Tcr = np.eye(4, dtype=np.float32)
        self.trajectory.append((frame.frame_id, frame.timestamp, Tcr, ref, lost))
        self._last_ref = None
        if frame.Tcw is not None and ref >= 0 and not lost:
            Tcorr, live = resolve_ref(self.map, ref)
            if live >= 0:
                self._last_ref = (frame.frame_id, ref, Tcorr @ self.map.kf_Tcw[live],
                                  self.map.pose_epoch)

    def reset(self):
        """reference: Tracking::Reset (Tracking.cc:2506-2563). A global BA
        still solving is stopped first, without a join: the tracker's
        auto-resets run under the map lock, which a merging solve waits
        for, and the stop voids its merge by generation
        (GlobalBARunner.request_stop). The keyframe database and the loop
        closer keep their entries, as in the JAX package (ROADMAP.md,
        known fault 9); System.reset clears them."""
        if self.gba_runner is not None:
            self.gba_runner.request_stop(join=False)
        self.map.__init__(self.config)
        self.state = TrackingState.NOT_INITIALIZED
        self._lost_streak = 0
        self.last_frame = None
        self.init_frame = None
        self.velocity = None
        self.vo_mode = False
        self.last_kf_id = -1
        self.last_kf_frame_id = -1
        self.trajectory.clear()
        if self._dev_map is not None:
            self._dev_map.invalidate()
        if self.local_mapper is not None:
            self.local_mapper.reset()

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------

    def _stereo_initialization(self, frame: FrameData):
        """reference: Tracking::StereoInitialization (Tracking.cc:797-897)."""
        if frame.n_valid < 500:
            return
        frame.Tcw = np.eye(4, dtype=np.float32)
        kf = self.map.add_keyframe(frame)
        cam = self.config.camera
        good = frame.valid & (frame.depth > 0)
        idxs = np.nonzero(good)[0]
        z = frame.depth[idxs]
        x = (frame.xy[idxs, 0] - cam.cx) / cam.fx * z
        y = (frame.xy[idxs, 1] - cam.cy) / cam.fy * z
        ids = self.map.add_map_points_batch(
            np.stack([x, y, z], -1).astype(np.float32), kf, idxs)
        frame.mp[idxs] = ids
        mp_ids = self.map.kf_mp[kf][self.map.kf_mp[kf] >= 0]
        self.map.update_point_descriptors(mp_ids)
        self.map.update_normal_and_depth(mp_ids)
        self.map.update_connections(kf)
        frame.ref_kf = kf
        self.last_kf_id = kf
        self.last_kf_frame_id = frame.frame_id
        if self.local_mapper is not None:
            self.local_mapper.on_new_keyframe(kf, run_ba=False)
        self.state = TrackingState.OK

    def _monocular_initialization(self, frame: FrameData):
        """reference: Tracking::MonocularInitialization (Tracking.cc:903-1011)."""
        if self.init_frame is None:
            if frame.n_valid > 100:
                self.init_frame = frame
            return
        if frame.n_valid <= 100:
            self.init_frame = None
            return

        f0 = self.init_frame
        m = M.search_for_initialization(
            self._t(f0.xy), self._desc(f0.desc), self._t(f0.valid),
            self._t(f0.octave), self._t(f0.angle),
            self._t(frame.xy), self._desc(frame.desc), self._t(frame.valid),
            self._t(frame.octave), self._t(frame.angle))
        ok = m.ok.cpu().numpy()
        idx = m.idx.cpu().numpy()
        if ok.sum() < 100:
            self.init_frame = None  # the reference discards the initializer
            return

        res = initialize_two_view(
            f0.xy, frame.xy[idx], ok, self.config.camera.K("cpu").numpy(),
            seed=frame.frame_id, device=self.device)
        if res is None:
            return

        self._create_initial_map_monocular(f0, frame, idx, res)

    def _create_initial_map_monocular(self, f0, f1, match_idx, res):
        """reference: Tracking::CreateInitialMapMonocular (Tracking.cc:1017-1155)."""
        f0.Tcw = np.eye(4, dtype=np.float32)
        T1 = np.eye(4, dtype=np.float32)
        T1[:3, :3] = res.R
        T1[:3, 3] = res.t
        f1.Tcw = T1

        kf0 = self.map.add_keyframe(f0)
        kf1 = self.map.add_keyframe(f1)

        tri = np.nonzero(res.is_triangulated)[0]
        ids = self.map.add_map_points_batch(res.points3d[tri], kf0, tri, first_kf=kf0)
        self.map.add_observations_batch(ids, kf1, match_idx[tri])
        self.map.mp_ref_kf[ids] = kf1
        f1.mp[match_idx[tri]] = ids
        mp_ids = self.map.kf_mp[kf1][self.map.kf_mp[kf1] >= 0]
        self.map.update_point_descriptors(mp_ids)
        self.map.update_normal_and_depth(mp_ids)
        self.map.update_connections(kf0)
        self.map.update_connections(kf1)

        # global BA on the 2-view map (reference: Tracking.cc:1089)
        if self.local_mapper is not None:
            self.local_mapper.global_ba(n_iters=20)

        # median-depth normalization (reference: Tracking.cc:1094-1123); the
        # reference resets when fewer than 100 points track in the new KF
        pos = self.map.mp_pos[mp_ids]
        Tcw0 = self.map.kf_Tcw[kf0]
        z = (pos @ Tcw0[:3, :3].T + Tcw0[:3, 3])[:, 2]
        med = float(np.median(z))
        if med <= 0 or len(mp_ids) < 100:
            self._dbg(f"init rejected post-BA: med={med:.3f} pts={len(mp_ids)} (<100)")
            self.reset()
            return
        inv = 1.0 / med
        self.map.kf_Tcw[kf1][:3, 3] *= inv
        self.map.mp_pos[mp_ids] *= inv
        self.map.update_normal_and_depth(mp_ids)

        f1.Tcw = self.map.kf_Tcw[kf1].copy()
        f0.Tcw = self.map.kf_Tcw[kf0].copy()
        f1.ref_kf = kf1
        self.last_kf_id = kf1
        self.last_kf_frame_id = f1.frame_id
        self.init_frame = None
        if self.local_mapper is not None:
            self.local_mapper.on_new_keyframe(kf0, run_ba=False)
            self.local_mapper.on_new_keyframe(kf1, run_ba=False)
        self.state = TrackingState.OK

    # ------------------------------------------------------------------
    # per-frame tracking
    # ------------------------------------------------------------------

    def _check_replaced_last_frame(self):
        """reference: Tracking::CheckReplacedInLastFrame (Tracking.cc:1161-1190).
        Replace() rewrites ids immediately, so only validity needs a refresh."""
        lf = self.last_frame
        if lf is None or lf.mp is None:
            return
        has = lf.mp >= 0
        bad = has & ~self.map.mp_valid[np.where(has, lf.mp, 0)]
        lf.mp[bad] = -1

    def _solve_pose(self, Tcw, pts, obs, octave, has):
        """Pose-only GN on device; returns (Tcw, inlier mask) as numpy."""
        Tcw, inliers, _ = pose_optimization(
            self._t(Tcw), self._t(pts), self._t(obs), self._t(octave), self._t(has),
            self.config.camera, self._inv_sigma2_t)
        return Tcw.cpu().numpy(), inliers.cpu().numpy()

    def _pose_opt(self, frame: FrameData) -> int:
        """Run motion-only GN on the frame's current associations and flag
        outliers. Returns the inlier count."""
        mp = frame.mp
        has = (mp >= 0) & frame.valid
        mp_safe = np.where(has, mp, 0)
        pts = self.map.mp_pos[mp_safe]
        obs = np.concatenate([frame.xy, frame.ur[:, None]], axis=1).astype(np.float32)
        frame.Tcw, inl = self._solve_pose(frame.Tcw, pts, obs, frame.octave, has)
        frame.is_outlier = has & ~inl
        return int(inl.sum())

    def _track_localization(self, frame: FrameData) -> bool:
        """Localization-only tracking with the reference's degraded VO state
        machine (reference: Tracking.cc:520-624). Healthy: motion-model /
        reference-KF tracking on the frozen map. Degraded (the last
        motion-model track held on < 10 real map matches): motion-model
        tracking AND relocalization on the same frame, the relocalization
        preferred, else the VO estimate with its tracked points credited."""
        if not self.vo_mode:
            if self.velocity is not None and frame.frame_id >= self.last_reloc_frame_id + 2:
                ok = self._track_with_motion_model(frame)
                if not ok:
                    ok = self._track_reference_keyframe(frame)
                return ok
            return self._track_reference_keyframe(frame)

        ok_mm = False
        mm_Tcw = mm_mp = mm_outlier = None
        if self.velocity is not None:
            ok_mm = self._track_with_motion_model(frame)
            if ok_mm:
                mm_Tcw = frame.Tcw.copy()
                mm_mp = frame.mp.copy()
                mm_outlier = frame.is_outlier.copy()
        ok_reloc = self._relocalize(frame)

        if ok_reloc:
            self.vo_mode = False          # re-attached to the map
        elif ok_mm:
            frame.Tcw = mm_Tcw
            frame.mp = mm_mp
            frame.is_outlier = mm_outlier
            matched = (frame.mp >= 0) & ~frame.is_outlier
            self.map.increase_found(frame.mp[matched])
        return ok_reloc or ok_mm

    def _track_reference_keyframe(self, frame: FrameData) -> bool:
        """reference: Tracking::TrackReferenceKeyFrame (Tracking.cc:1196-1270):
        BoW-restricted matching becomes a full descriptor match against the
        reference KF, then pose-only GN from the last pose."""
        kf = frame.ref_kf if frame.ref_kf >= 0 else self.last_kf_id
        if kf < 0:
            return False
        kf_has_mp = self.map.kf_mp[kf] >= 0
        m = M.match_descriptors(
            self._desc(frame.desc), self._t(frame.valid),
            self._desc(self.map.kf_desc[kf]), self._t(self.map.kf_kp_valid[kf] & kf_has_mp),
            angle_a=self._t(frame.angle), angle_b=self._t(self.map.kf_angle[kf]),
            max_dist=M.TH_LOW, ratio=0.7)
        ok = m.ok.cpu().numpy()
        idx = m.idx.cpu().numpy()
        self._dbg(f"refkf: kf={kf} matches={int(ok.sum())}")
        if ok.sum() < 15:
            return False
        frame.mp[:] = -1
        frame.mp[ok] = self.map.kf_mp[kf][idx[ok]]
        frame.Tcw = self.last_frame.Tcw.copy()
        n_in = self._pose_opt(frame)
        frame.mp[frame.is_outlier] = -1
        self._dbg(f"refkf: inliers={n_in}")
        return n_in >= 10

    def _last_frame_point_set(self, lf: FrameData):
        """Matching set for motion-model tracking: the last frame's real map
        points, augmented with temporal 'visual odometry' points
        backprojected from close stereo/RGB-D depths of unmatched keypoints
        (reference: Tracking::UpdateLastFrame, Tracking.cc:1277-1397; all
        close ones are included, and discarded after pose estimation).

        Returns (pos (N,3), normal, min_d, max_d, desc, valid, real_mp_id)
        where real_mp_id < 0 marks a temporal point.
        """
        has = (lf.mp >= 0) & lf.valid & ~lf.is_outlier
        mp_ids = np.where(has, lf.mp, 0)
        has = has & self.map.mp_valid[mp_ids]

        pos = self.map.mp_pos[mp_ids].copy()
        normal = self.map.mp_normal[mp_ids].copy()
        min_d = self.map.mp_min_dist[mp_ids].copy()
        max_d = self.map.mp_max_dist[mp_ids].copy()
        desc = self.map.mp_desc[mp_ids].copy()
        real_id = np.where(has, mp_ids, -1).astype(np.int64)

        if self.sensor != Sensor.MONOCULAR and lf.Tcw is not None:
            vo = lf.valid & ~has & (lf.depth > 0) & (lf.depth < self.th_depth)
            if vo.any():
                # a fused last frame keeps its descriptors on the device
                lf.ensure_desc()
                cam = self.config.camera
                z = lf.depth
                x = (lf.xy[:, 0] - cam.cx) / cam.fx * z
                y = (lf.xy[:, 1] - cam.cy) / cam.fy * z
                pc = np.stack([x, y, z], -1)
                Twc = np.linalg.inv(lf.Tcw).astype(np.float32)
                pw = pc @ Twc[:3, :3].T + Twc[:3, 3]
                C = Twc[:3, 3]
                d = np.linalg.norm(pw - C, axis=-1)
                n = pw - C
                n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
                sf = self.config.orb.scale_factor
                maxd = d * (sf ** lf.octave)
                pos = np.where(vo[:, None], pw, pos)
                normal = np.where(vo[:, None], n, normal)
                min_d = np.where(vo, maxd / (sf ** (self.config.orb.n_levels - 1)), min_d)
                max_d = np.where(vo, maxd, max_d)
                desc = np.where(vo[:, None], lf.desc, desc)
                has = has | vo
        return pos, normal, min_d, max_d, desc, has, real_id

    def _track_with_motion_model(self, frame: FrameData) -> bool:
        """reference: Tracking::TrackWithMotionModel (Tracking.cc:1399-1509)."""
        lf = self.last_frame
        frame.Tcw = (self.velocity @ lf.Tcw).astype(np.float32)

        pos, normal, min_d, max_d, desc, has, real_id = self._last_frame_point_set(lf)
        th = 7.0 if self.sensor == Sensor.STEREO else 15.0
        pos_t, has_t, normal_t = self._t(pos), self._t(has), self._t(normal)
        min_t, max_t, desc_t = self._t(min_d), self._t(max_d), self._desc(desc)
        kp_xy, kp_ur = self._t(frame.xy), self._t(frame.ur)
        kp_desc, kp_valid, kp_oct = self._desc(frame.desc), self._t(frame.valid), self._t(frame.octave)

        for radius_mult in (th, 2 * th):
            proj = M.project_and_cull(
                pos_t, has_t, normal_t, min_t, max_t, self._t(frame.Tcw), self.config.camera,
                self.config.orb.n_levels, self.log_scale,
                view_cos_limit=-1.0)  # the last-frame search has no view-angle gate
            m = M.search_by_projection(
                proj, desc_t, kp_xy, kp_ur, kp_desc, kp_valid, kp_oct, self._scale_factors_t,
                th=radius_mult / 4.0, max_dist=M.TH_HIGH, ratio=0.9,
                check_stereo=self.sensor != Sensor.MONOCULAR)
            ok = m.ok.cpu().numpy()
            self._dbg(f"mm: search th={radius_mult} -> {int(ok.sum())} matches "
                      f"(set={int(has.sum())})")
            if ok.sum() >= 20:
                break
        if ok.sum() < 20:
            return False
        idx = m.idx.cpu().numpy()

        # pose optimization over real + temporal points
        src = np.nonzero(ok)[0]
        kp_of_src = idx[src]
        obs = np.concatenate([frame.xy, frame.ur[:, None]], axis=1).astype(np.float32)
        E = frame.capacity
        pts_e = np.zeros((E, 3), np.float32)
        valid_e = np.zeros(E, bool)
        pts_e[kp_of_src] = pos[src]
        valid_e[kp_of_src] = True
        frame.Tcw, inl = self._solve_pose(frame.Tcw, pts_e, obs, frame.octave, valid_e)

        # keep only REAL map point associations (temporal points are
        # discarded, reference: Tracking.cc:691-719)
        frame.mp[:] = -1
        real_src = src[real_id[src] >= 0]
        keep = inl[idx[real_src]]
        frame.mp[idx[real_src[keep]]] = real_id[real_src[keep]]
        frame.is_outlier[:] = False
        n_real = int((frame.mp >= 0).sum())
        self._dbg(f"mm: inliers={int(inl.sum())} real={n_real}")
        if self.localization_only:
            # reference: Tracking.cc:1494-1508 — < 10 REAL map matches flips
            # the degraded VO state; success needs > 20 inliers in all
            self.vo_mode = n_real < 10
            return int(inl.sum()) > 20
        return int(inl.sum()) >= 10 and n_real >= 5

    def _track_local_map(self, frame: FrameData) -> bool:
        """reference: Tracking::TrackLocalMap (Tracking.cc:1514-1595) +
        UpdateLocalKeyFrames/Points + SearchLocalPoints (:1875-2042)."""
        kf_ids, ref_kf = self.map.local_keyframes(frame.mp)
        if ref_kf >= 0:
            frame.ref_kf = ref_kf
        if kf_ids.size == 0:
            return False
        mp_ids = self.map.points_of_keyframes(kf_ids)
        if mp_ids.size == 0:
            return False
        mp_ids = counters.keep_best_observed(
            mp_ids, self.map.mp_n_obs, LOCAL_MP_CAP, "tracking.local_map")
        pad = LOCAL_MP_CAP - mp_ids.size
        mp_pad = np.pad(mp_ids, (0, pad))
        pvalid = np.pad(np.ones(mp_ids.size, bool), (0, pad))

        # points already matched in this frame are not searched again
        already = np.isin(mp_pad, frame.mp[frame.mp >= 0])

        proj = M.project_and_cull(
            self._t(self.map.mp_pos[mp_pad]), self._t(pvalid & ~already),
            self._t(self.map.mp_normal[mp_pad]),
            self._t(self.map.mp_min_dist[mp_pad]), self._t(self.map.mp_max_dist[mp_pad]),
            self._t(frame.Tcw), self.config.camera,
            self.config.orb.n_levels, self.log_scale, view_cos_limit=0.5)

        visible = proj.visible.cpu().numpy()
        self.map.increase_visible(mp_pad[visible])

        # keypoints without a match yet are fair targets
        kp_free = frame.valid & (frame.mp < 0)
        # RGB-D searches a wider window (reference: Tracking.cc:1943-1944
        # th=3 for RGBD, else 1); wider still right after relocalization (:1929)
        th = 3.0 if self.sensor == Sensor.RGBD else 1.0
        if frame.frame_id < self.last_reloc_frame_id + 2:
            th = 5.0
        m = M.search_by_projection(
            proj, self._desc(self.map.mp_desc[mp_pad]),
            self._t(frame.xy), self._t(frame.ur), self._desc(frame.desc), self._t(kp_free),
            self._t(frame.octave), self._scale_factors_t,
            th=th, max_dist=M.TH_HIGH, ratio=0.8,
            check_stereo=self.sensor != Sensor.MONOCULAR)
        ok = m.ok.cpu().numpy()
        idx = m.idx.cpu().numpy()
        frame.mp[idx[ok]] = mp_pad[ok]

        n_in = self._pose_opt(frame)
        matched = (frame.mp >= 0) & ~frame.is_outlier
        self.map.increase_found(frame.mp[matched])

        min_inliers = 50 if frame.frame_id < self.last_reloc_frame_id + int(self.config.fps) else 30
        self._dbg(f"lmap: kfs={kf_ids.size} mps={mp_ids.size} "
                  f"visible={int(visible.sum())} new_matches={int(ok.sum())} "
                  f"inliers={n_in} (need {min_inliers})")
        return n_in >= min_inliers

    def _relocalize(self, frame: FrameData) -> bool:
        if self.relocalizer is None:
            return False
        ok = self.relocalizer(frame)
        if ok:
            self.last_reloc_frame_id = frame.frame_id
        return ok

    # ------------------------------------------------------------------
    # keyframe decision / creation
    # ------------------------------------------------------------------

    def _need_new_keyframe(self, frame: FrameData) -> bool:
        """reference: Tracking::NeedNewKeyFrame (Tracking.cc:1600-1745), with
        the JAX package's departures (each explained there): minObs=1 while
        the map has <= 2 KFs, the mono young-map guard, and the 0.75 ratio
        from the first keyframe on."""
        n_kfs = self.map.n_keyframes()
        if frame.frame_id < self.last_reloc_frame_id + self.config.max_frames and n_kfs > self.config.max_frames:
            return False

        min_obs = 3 if n_kfs > 2 else 1
        ref = frame.ref_kf if frame.ref_kf >= 0 else self.last_kf_id
        ref_mps = self.map.kf_mp[ref]
        ref_mps = ref_mps[ref_mps >= 0]
        ref_mps = ref_mps[self.map.mp_valid[ref_mps]]
        # TrackedMapPoints compares the weighted count (stereo obs = 2)
        # against minObs (KeyFrame.cc:163-187)
        ref_tracked = int((self.map.mp_wobs[ref_mps] >= min_obs).sum())
        # young-map guard (monocular only): count all valid reference
        # points while almost none are mature
        if min_obs == 3 and ref_tracked < 30 and self.sensor == Sensor.MONOCULAR:
            ref_tracked = int(ref_mps.size)

        matched = (frame.mp >= 0) & ~frame.is_outlier
        n_matches = int(matched.sum())

        # close-point bookkeeping for stereo/RGBD (reference :1671-1692)
        need_close = False
        tracked_close = untracked_close = -1
        if self.sensor != Sensor.MONOCULAR:
            close = frame.valid & (frame.depth > 0) & (frame.depth < self.th_depth)
            tracked_close = int((close & matched).sum())
            untracked_close = int((close & ~matched).sum())
            need_close = tracked_close < 100 and untracked_close > 70

        th_ratio = 0.9 if self.sensor == Sensor.MONOCULAR else 0.75

        # reference decision: (c1a || c1b || c1c) && c2 (:1729-1740); "idle"
        # is the mapping queue's back-pressure signal (AcceptKeyFrames)
        idle = getattr(self.local_mapper, "accept_keyframes", lambda: True)()
        c1a = frame.frame_id >= self.last_kf_frame_id + self.config.max_frames
        c1b = (frame.frame_id >= self.last_kf_frame_id + self.config.min_frames) and idle
        c1c = self.sensor != Sensor.MONOCULAR and (
            n_matches < ref_tracked * 0.25 or need_close)
        c2 = (n_matches < ref_tracked * th_ratio or need_close) and n_matches > 15
        self._dbg(f"NNKf f={frame.frame_id} ref={ref} n_m={n_matches} "
                  f"ref_trk={ref_tracked} close(t/u)=({tracked_close}/{untracked_close}) "
                  f"need_close={need_close} c1a={c1a} c1c={c1c} c2={c2}")
        if not ((c1a or c1b or c1c) and c2):
            return False
        if idle:
            return True
        # mapping busy: mono never queues; stereo/RGBD queue only while the
        # backlog is short (reference Tracking.cc:1744-1760)
        qlen = getattr(self.local_mapper, "queue_len", lambda: 0)()
        return self.sensor != Sensor.MONOCULAR and qlen < 3

    def _create_new_keyframe(self, frame: FrameData):
        """reference: Tracking::CreateNewKeyFrame (Tracking.cc:1753-1870)."""
        kf = self.map.add_keyframe(frame)
        frame.ref_kf = kf
        # register existing observations (batched; the reference loops per
        # point, Tracking.cc:1782-1798)
        reg = np.nonzero((frame.mp >= 0) & ~frame.is_outlier)[0]
        self.map.add_observations_batch(frame.mp[reg], kf, reg)
        # stereo/RGBD: spawn close points for unmatched keypoints, nearest
        # first, at least 100 (reference :1800-1860)
        if self.sensor != Sensor.MONOCULAR:
            cam = self.config.camera
            cand = np.nonzero(frame.valid & (frame.depth > 0) & (frame.mp < 0))[0]
            order = cand[np.argsort(frame.depth[cand])]
            z_sorted = frame.depth[order]
            n_close = int((z_sorted <= self.th_depth).sum())
            take = order[:max(n_close, min(100, order.size))]
            z = frame.depth[take]
            x = (frame.xy[take, 0] - cam.cx) / cam.fx * z
            y = (frame.xy[take, 1] - cam.cy) / cam.fy * z
            pw = self.map.kf_Tcw[kf]
            Rwc = pw[:3, :3].T
            Ow = -Rwc @ pw[:3, 3]
            pos = np.stack([x, y, z], -1).astype(np.float32) @ Rwc.T + Ow
            ids = self.map.add_map_points_batch(pos.astype(np.float32), kf, take)
            frame.mp[take] = ids
        mp_ids = self.map.kf_mp[kf][self.map.kf_mp[kf] >= 0]
        self.map.update_point_descriptors(mp_ids)
        self.map.update_normal_and_depth(mp_ids)
        self.map.update_connections(kf)
        self.last_kf_id = kf
        self.last_kf_frame_id = frame.frame_id
        if self.local_mapper is not None:
            self.local_mapper.on_new_keyframe(kf)
