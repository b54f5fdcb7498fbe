"""Relocalization: BoW candidates -> RANSAC PnP -> guided refinement.

Counterpart of orb_slam2_detailed_comments_tpu/backend/relocalization.py,
the replacement of Tracking::Relocalization (reference:
src/Tracking.cc:2245-2499): per candidate keyframe a full descriptor match
replaces SearchByBoW, the batched RANSAC PnP replaces EPnP iterate(5), and
the widening projection-search + re-optimize cascade (50-inlier
acceptance) is kept. The matchers and pose solves run on `device`; the
bookkeeping stays host numpy, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..interop import desc_to_torch
from ..ops import matching as M
from ..optim.pose_gn import pose_optimization
from ..place.kf_database import KeyFrameDatabase
from ..solvers.pnp import solve_pnp_ransac
from ..state.frame import FrameData
from ..state.map_store import MapStore
from ..utils.config import SlamConfig
from ..utils import counters


class Relocalizer:
    def __init__(self, config: SlamConfig, map_store: MapStore, voc,
                 kfdb: KeyFrameDatabase, device="cuda"):
        self.config = config
        self.map = map_store
        self.voc = voc
        self.kfdb = kfdb
        self.device = torch.device(device)
        sf = config.orb.scale_factor
        self.scale_factors = np.array([sf ** i for i in range(config.orb.n_levels)], np.float32)
        self.inv_sigma2 = (1.0 / self.scale_factors ** 2).astype(np.float32)
        self.log_scale = float(np.log(sf))

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def _desc(self, a) -> torch.Tensor:
        return desc_to_torch(a, self.device)

    def __call__(self, frame: FrameData) -> bool:
        frame.ensure_desc()
        _, bow = self.voc.transform(frame.desc, frame.valid)
        candidates = self.kfdb.detect_relocalization_candidates(bow, self.map)
        if not candidates:
            return False

        mp = self.map
        desc_f, valid_f, angle_f = self._desc(frame.desc), self._t(frame.valid), self._t(frame.angle)
        for kf in candidates:
            if not mp.kf_valid[kf]:
                continue
            kf_has_mp = mp.kf_mp[kf] >= 0
            m = M.match_descriptors(
                desc_f, valid_f, self._desc(mp.kf_desc[kf]),
                self._t(mp.kf_kp_valid[kf] & kf_has_mp),
                angle_a=angle_f, angle_b=self._t(mp.kf_angle[kf]),
                max_dist=M.TH_LOW, ratio=0.75)
            ok = m.ok.cpu().numpy()
            idx = m.idx.cpu().numpy()
            if ok.sum() < 15:  # reference: Tracking.cc:2295
                continue

            cand_mp = np.where(ok, mp.kf_mp[kf][idx], -1)
            cand_mp = np.where((cand_mp >= 0) & mp.mp_valid[np.maximum(cand_mp, 0)], cand_mp, -1)
            has = cand_mp >= 0
            pts3d = mp.mp_pos[np.maximum(cand_mp, 0)]
            res = solve_pnp_ransac(
                pts3d, frame.xy, has, frame.octave,
                self.config.camera.K("cpu").numpy(), self.inv_sigma2,
                min_inliers=10, seed=frame.frame_id, device=self.device)
            if res is None:
                continue

            frame.Tcw = res.Tcw
            frame.mp[:] = -1
            frame.mp[res.inliers] = cand_mp[res.inliers]
            n_in = self._pose_opt(frame)
            if n_in < 10:
                continue
            if n_in < 50:
                n_in = self._search_more(frame, window_th=10.0, max_dist=100)
                if 30 < n_in < 50:
                    # narrow second pass from the now-refined pose
                    # (reference: Tracking.cc:2448-2482 — window 3,
                    # ORBdist 64, outlier associations dropped first)
                    frame.mp[frame.is_outlier] = -1
                    frame.is_outlier[:] = False
                    n_in = self._search_more(frame, window_th=3.0, max_dist=64)
            if n_in >= 50:
                frame.mp[frame.is_outlier] = -1
                frame.is_outlier[:] = False
                return True
        return False

    # ------------------------------------------------------------------

    def _pose_opt(self, frame: FrameData) -> int:
        mp = self.map
        has = (frame.mp >= 0) & frame.valid
        mp_safe = np.where(has, frame.mp, 0)
        pts = mp.mp_pos[mp_safe]
        obs = np.concatenate([frame.xy, frame.ur[:, None]], axis=1).astype(np.float32)
        Tcw, inliers, _ = pose_optimization(
            self._t(frame.Tcw), self._t(pts), self._t(obs), self._t(frame.octave),
            self._t(has), self.config.camera, self._t(self.inv_sigma2))
        frame.Tcw = Tcw.cpu().numpy()
        inl = inliers.cpu().numpy()
        frame.is_outlier = has & ~inl
        return int(inl.sum())

    def _search_more(self, frame: FrameData, window_th: float, max_dist: int) -> int:
        """Widen with projection search against all local points of the
        matched area (reference: Tracking.cc:2416-2482)."""
        mp = self.map
        kf_ids, _ = mp.local_keyframes(frame.mp)
        if kf_ids.size == 0:
            return int(((frame.mp >= 0) & ~frame.is_outlier).sum())
        mp_ids = mp.points_of_keyframes(kf_ids)
        cap = 8192
        mp_ids = counters.keep_best_observed(mp_ids, mp.mp_n_obs, cap,
                                             "relocalization.search_more")
        pad = cap - mp_ids.size
        ids = np.pad(mp_ids, (0, pad))
        pvalid = np.pad(np.ones(mp_ids.size, bool), (0, pad))
        proj = M.project_and_cull(
            self._t(mp.mp_pos[ids]), self._t(pvalid), self._t(mp.mp_normal[ids]),
            self._t(mp.mp_min_dist[ids]), self._t(mp.mp_max_dist[ids]), self._t(frame.Tcw),
            self.config.camera, self.config.orb.n_levels, self.log_scale,
            view_cos_limit=-1.0)
        kp_free = frame.valid & (frame.mp < 0)
        m = M.search_by_projection(
            proj, self._desc(mp.mp_desc[ids]), self._t(frame.xy), self._t(frame.ur),
            self._desc(frame.desc), self._t(kp_free), self._t(frame.octave),
            self._t(self.scale_factors), th=window_th / 4.0, max_dist=max_dist, ratio=0.0)
        ok = m.ok.cpu().numpy()
        idx = m.idx.cpu().numpy()
        frame.mp[idx[ok]] = ids[ok]
        return self._pose_opt(frame)
