"""Local mapping stage.

Counterpart of orb_slam2_detailed_comments_tpu/backend/local_mapping.py,
the replacement of the LocalMapping thread (reference:
src/LocalMapping.cc). It runs per new keyframe, in the caller's thread
or, under backend/async_pipeline.py, on a worker:

  on_new_keyframe
  ├─ prepare_keyframe (changes the map)
  │  ├─ MapPointCulling        (reference :280-327)
  │  ├─ CreateNewMapPoints     (reference :336-680) — one batched epipolar
  │  │    search over all covisible neighbors + host triangulation and gating
  │  ├─ SearchInNeighbors fuse (reference :688-832) — batched projection fuse
  │  └─ the local-BA window's snapshot (the fusion, the local BA and the
  │     keyframe culling wait for a later keyframe while others are queued)
  ├─ the local-BA solve       (optim.local_ba, Schur dense path; reads only
  │    the snapshot, so the worker runs it outside the map lock)
  ├─ the local-BA merge       (discarded if the map moved meanwhile)
  └─ finish_keyframe: KeyFrameCulling (reference :966-1082), then the loop
     closer (backend/loop_closing.py), or the keyframe indexer that keeps
     the keyframe database fed without one, when one is attached.

The matchers and the BA solves run on `device`; the bookkeeping is host
numpy, as in the JAX package. Each stage is timed by `timer`
(utils/timing.StageTimer), the local-BA solve per bucket. Only the JAX
package's default path is ported: the device keyframe store, the three
local-BA buckets and, for whole-map BA, the flat solver and, from
FLAT_GBA_MAX_EDGES edges on, the grouped one, sharded over the ranks of a
torch.distributed deployment (parallel/); `_fuse`, one keyframe at a
time, serves loop fusion.
"""
from __future__ import annotations

from typing import List, Set

import numpy as np
import torch
import torch.distributed as dist

from ..geometry.triangulate import triangulate_dlt_np
from ..interop import desc_to_torch
from ..ops import matching as M
from ..optim.global_ba import global_bundle_adjustment
from ..optim.global_ba_grouped import group_global_problem, solve_grouped
from ..optim.local_ba import BAProblem, local_bundle_adjustment
from ..state import native_ops
from ..state.map_store import MapStore
from ..utils import counters
from ..utils.config import SlamConfig
from ..utils.timing import StageTimer
from . import device_kf as DK

# static capacities of the local-BA problem (cameras, points, edges). A
# problem is padded to the smallest bucket that fits, so a window pays for
# its own size and not the worst case.
BA_BUCKETS = (
    (16, 4096, 12288),
    (32, 8192, 24576),
    (64, 16384, 49152),
)
BA_CAM_CAP, BA_PT_CAP, BA_EDGE_CAP = BA_BUCKETS[-1]
# whole-map BA: the flat solver builds (points x edges) one-hot sums; from
# this edge count on the grouped solver takes the map, as in the JAX package
FLAT_GBA_MAX_EDGES = 4096


def _gather_edges(mp: MapStore, pts: np.ndarray, cams, edge_cap: int):
    """Vectorized observation-edge assembly for a BA window.

    Returns (e_cam (E,) slot ids, e_pt (E,) point indices into `pts`,
    e_obs (E, 3) float32 (u, v, ur), e_oct (E,) int32, n_dropped) in
    point-major observation order.
    """
    slot_of = np.full(mp.KF_CAP, -1, np.int64)
    slot_of[np.asarray(cams, np.int64)] = np.arange(len(cams))
    obs_kf = mp.mp_obs_kf[pts]                       # (Np, O)
    obs_idx = mp.mp_obs_idx[pts]
    cslot = np.where(obs_kf >= 0, slot_of[np.maximum(obs_kf, 0)], -1)
    sel = (cslot >= 0).ravel()
    Np, O = obs_kf.shape
    pi = np.broadcast_to(np.arange(Np)[:, None], (Np, O)).ravel()[sel]
    e_cam = cslot.ravel()[sel].astype(np.int32)
    k_arr = obs_kf.ravel()[sel]
    i_arr = obs_idx.ravel()[sel]
    n_dropped = max(0, e_cam.size - edge_cap)
    if n_dropped:
        e_cam, pi = e_cam[:edge_cap], pi[:edge_cap]
        k_arr, i_arr = k_arr[:edge_cap], i_arr[:edge_cap]
    e_obs = np.stack([mp.kf_xy[k_arr, i_arr, 0], mp.kf_xy[k_arr, i_arr, 1],
                      mp.kf_ur[k_arr, i_arr]], -1).astype(np.float32)
    return (e_cam, pi.astype(np.int32), e_obs,
            mp.kf_octave[k_arr, i_arr].astype(np.int32), n_dropped)


def _problem(device, cam_Tcw, cam_free, cam_valid, points, point_valid,
             e_cam, e_pt, e_obs, e_oct, e_valid) -> BAProblem:
    """Host arrays -> a BAProblem of tensors on `device`."""
    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)
    return BAProblem(
        cam_Tcw=t(cam_Tcw, torch.float32), cam_free=t(cam_free, torch.bool),
        cam_valid=t(cam_valid, torch.bool), points=t(points, torch.float32),
        point_valid=t(point_valid, torch.bool), edge_cam=t(e_cam, torch.int32),
        edge_point=t(e_pt, torch.int32), edge_obs=t(e_obs, torch.float32),
        edge_octave=t(e_oct, torch.int32), edge_valid=t(e_valid, torch.bool))


def build_global_ba_problem(mp: MapStore, device="cuda"):
    """Assemble the whole-map BAProblem from the store. Returns
    (prob, kfs, pts) or None if the map is too small."""
    kfs = mp.keyframe_ids()
    pts = mp.points_of_keyframes(kfs)
    if pts.size == 0 or kfs.size < 2:
        return None
    cam_slot = {int(c): i for i, c in enumerate(kfs)}
    e_cam, e_pt, e_obs, e_oct, _ = _gather_edges(mp, pts, kfs, 1 << 62)
    E = len(e_cam)
    if E < 10:
        return None
    cam_free = np.ones(len(kfs), bool)
    cam_free[cam_slot.get(mp.origin_kf, 0)] = False
    prob = _problem(device, mp.kf_Tcw[kfs], cam_free, np.ones(len(kfs), bool),
                    mp.mp_pos[pts], np.ones(len(pts), bool), e_cam, e_pt, e_obs, e_oct,
                    np.ones(E, bool))
    return prob, kfs, pts


def solve_global_ba(prob: BAProblem, camera, inv_sigma2, n_iters: int = 10,
                    stop_check=None):
    """Solve a whole-map BAProblem, returning (cam_Tcw, points) as numpy.
    Below FLAT_GBA_MAX_EDGES edges the flat PCG solver takes it; from there
    on the grouped one (optim/global_ba_grouped.py), with the JAX package's
    schedule (50 CG iterations, damping 1e-5). In a torch.distributed
    deployment of more than one rank (every rank calls this, as every JAX
    process does) the grouped solve is sharded over the ranks
    (parallel/distributed_ba_grouped.py; JAX's `len(jax.devices()) > 1
    and E >= 4096`, a rank as the device), "dense" up to DENSE_MAX_CAMS
    cameras; it keeps the single-device route's 50 CG iterations where
    JAX's sharded route runs 40, so that a world of n solves the problem
    a world of one does.

    `stop_check`: a host callable polled before every
    optim.global_ba.STOP_POLL_EVERY LM iterations (the reference's
    mbStopGBA, LoopClosing.cc:699-712); when it fires the
    solve returns None and the caller discards it. Both layouts run one LM
    schedule across the polls, so a solve it never stops equals the
    unpolled one bit for bit (the JAX package's flat path restarts the
    schedule per chunk; ROADMAP.md C records the divergence). Sharded,
    the ranks agree on each poll, so all of them stop at the same one."""
    dev = prob.points.device
    inv_s2 = torch.as_tensor(np.asarray(inv_sigma2, np.float32)).to(dev)
    E = int(prob.edge_cam.shape[0])
    if E >= FLAT_GBA_MAX_EDGES and dist.is_initialized() and dist.get_world_size() > 1:
        from ..parallel.distributed_ba_grouped import (distributed_global_ba_grouped,
                                                       make_grouped_mesh)
        out = distributed_global_ba_grouped(prob, camera, inv_s2, make_grouped_mesh(dev),
                                            n_iters, 50, 1e-5, stop_check=stop_check)
    elif E >= FLAT_GBA_MAX_EDGES:
        gp = group_global_problem(prob)
        out = solve_grouped(gp, camera, inv_s2, n_iters, 50, 1e-5, stop_check)
    else:
        out = global_bundle_adjustment(prob, camera, inv_s2, n_iters=n_iters,
                                       stop_check=stop_check)
    if out is None:
        return None
    return out[0].cpu().numpy(), out[1].cpu().numpy()


class LocalMapper:
    def __init__(self, config: SlamConfig, map_store: MapStore, monocular: bool,
                 loop_closer=None, device="cuda"):
        self.config = config
        self.map = map_store
        self.monocular = monocular
        self.loop_closer = loop_closer    # a LoopCloser, a keyframe indexer or None
        self.device = torch.device(device)
        self.recent_points: List[int] = []  # candidates for culling
        self.scale_factors = np.array(
            [config.orb.scale_factor ** i for i in range(config.orb.n_levels)], np.float32)
        self.inv_sigma2 = (1.0 / self.scale_factors ** 2).astype(np.float32)
        self.log_scale = float(np.log(config.orb.scale_factor))
        self._scale_factors_t = self._t(self.scale_factors)
        self._inv_sigma2_t = self._t(self.inv_sigma2)
        self.timer = StageTimer()
        self._dev_kf = None
        self.kf_counter = 0
        # interruptible local BA (reference: mbAbortBA, set by
        # LocalMapping::InsertKeyFrame, LocalMapping.cc:954-957, and polled by
        # Optimizer::LocalBundleAdjustment between its 5- and 10-iteration
        # phases, Optimizer.cc:893-935): the asynchronous pipeline
        # (backend/async_pipeline.py) sets it to "a keyframe is waiting"
        self.abort_ba_check = None
        self.n_ba_aborted = 0
        self.n_kf_deferred = 0    # keyframes whose local BA and culling waited for a later one
        self._deferred = False
        # keyframes queued for this mapper and not yet taken up (the async
        # pipeline's queue): the reference's map holds a keyframe only from
        # LocalMapping::ProcessNewKeyFrame on, so the mapping steps do not
        # see them (no triangulation, fusion, local BA or culling with them)
        self.pending: Set[int] = set()
        # off-lock local-BA results discarded because a loop correction or a
        # global-BA merge moved the map during the solve (async mode)
        self.n_ba_stale = 0

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def _kf_store(self):
        if self._dev_kf is None:
            self._dev_kf = DK.DeviceKeyframeStore(self.config.orb.max_keypoints,
                                                  device=self.device)
        return self._dev_kf

    def reset(self):
        self.recent_points.clear()
        self.kf_counter = 0
        if self._dev_kf is not None:
            self._dev_kf.clear()

    # ------------------------------------------------------------------

    def on_new_keyframe(self, kf: int, run_ba: bool = True):
        built = self.prepare_keyframe(kf, run_ba)
        if built is not None:
            self._merge_local_ba(built, self._solve_local_ba(built))
        self.finish_keyframe(kf)

    def prepare_keyframe(self, kf: int, run_ba: bool = True):
        """The first half of the mapping step, which changes the map
        (culling, triangulation, fusion), and the local-BA window's
        snapshot. Returns the built problem or None; the asynchronous
        pipeline solves it outside the map lock."""
        self.kf_counter += 1
        # new points created at KF creation join the culling watchlist
        fresh = self.map.kf_mp[kf]
        fresh = fresh[fresh >= 0]
        fresh = fresh[self.map.mp_first_kf[fresh] == kf]
        self.recent_points.extend(int(m) for m in fresh)

        with self.timer.stage("point_culling"):
            self._map_point_culling(kf)
        with self.timer.stage("triangulation"):
            self._create_new_map_points(kf)
        # while other keyframes wait (only the asynchronous pipeline's queue
        # can hold them), the reference's LocalMapping::Run leaves the
        # neighbour fusion, and then the local BA and the keyframe culling,
        # to a later keyframe, so a mapper that falls behind catches up
        # (CheckNewKeyFrames, LocalMapping.cc:80-173)
        if not self._keyframes_waiting():
            with self.timer.stage("fusion"):
                self._search_in_neighbors(kf)
        self._deferred = self._keyframes_waiting()
        if self._deferred:
            self.n_kf_deferred += 1
        elif run_ba and self.map.n_keyframes() > 2:
            with self.timer.stage("local_ba_build"):
                return self._build_local_ba(kf)
        return None

    def finish_keyframe(self, kf: int):
        """The second half, after the local-BA merge: keyframe culling
        (unless prepare_keyframe deferred it), then the loop closer (or the
        keyframe indexer)."""
        if not self._deferred:
            with self.timer.stage("keyframe_culling"):
                self._keyframe_culling(kf)
        if self.loop_closer is not None:
            self.loop_closer.on_new_keyframe(kf)

    def _covisible(self, kf: int, n=None) -> np.ndarray:
        """The best covisible keyframes (MapStore.get_covisible) but those
        still queued for this mapper."""
        c = self.map.get_covisible(kf)
        if self.pending:
            c = c[~np.isin(c, np.fromiter(self.pending, np.int64))]
        return c[:n] if n is not None else c

    def _keyframes_waiting(self) -> bool:
        return self.abort_ba_check is not None and self.abort_ba_check()

    # ------------------------------------------------------------------

    def _map_point_culling(self, cur_kf: int):
        """reference: LocalMapping::MapPointCulling (LocalMapping.cc:280-327).

        The observation threshold compares the WEIGHTED count (stereo obs
        count 2, MapPoint.cc:193-197)."""
        th_obs = 2 if self.monocular else 3
        mp = self.map
        arr = np.unique(np.asarray(self.recent_points, np.int64)) \
            if self.recent_points else np.empty(0, np.int64)
        live = arr[mp.mp_valid[arr]] if arr.size else arr
        age = cur_kf - mp.mp_first_kf[live]
        fr = mp.mp_found[live] / np.maximum(mp.mp_visible[live], 1)
        erase = (fr < 0.25) | ((age >= 2) & (mp.mp_wobs[live] <= th_obs))
        keep = live[~erase & (age < 3)]
        for m in live[erase]:
            mp.erase_map_point(int(m))
        self.recent_points = [int(m) for m in keep]

    # ------------------------------------------------------------------

    def _create_new_map_points(self, kf: int):
        """reference: LocalMapping::CreateNewMapPoints (LocalMapping.cc:336-680)."""
        mp = self.map
        cfg = self.config
        cam = cfg.camera
        n_neighbors = 20 if self.monocular else 10
        neighbors = self._covisible(kf, n_neighbors)
        if neighbors.size == 0:
            return

        T1 = mp.kf_Tcw[kf]
        O1 = mp.kf_camera_center(kf)
        K = cam.K("cpu").numpy()
        has_mp1 = mp.kf_mp[kf] >= 0
        ratio_factor = 1.5 * cfg.orb.scale_factor
        sigma2 = (self.scale_factors ** 2).astype(np.float32)

        # host pass: per-neighbor eligibility + epipolar geometry (reference
        # :357-392); the epipolar search then runs as one batched call
        elig, F12s, epis = [], [], []
        for kf2 in neighbors:
            T2 = mp.kf_Tcw[kf2]
            O2 = mp.kf_camera_center(kf2)
            baseline = float(np.linalg.norm(O2 - O1))
            if not self.monocular:
                if baseline < cam.baseline:  # reference :370-377
                    continue
            else:
                # baseline vs scene depth (reference :380-392)
                mps2 = mp.kf_mp[kf2]
                mps2 = mps2[mps2 >= 0]
                mps2 = mps2[mp.mp_valid[mps2]]
                if mps2.size == 0:
                    continue
                z = (mp.mp_pos[mps2] @ T2[:3, :3].T + T2[:3, 3])[:, 2]
                med_depth = float(np.median(z))
                if med_depth <= 0 or baseline / med_depth < 0.01:
                    continue

            F12 = DK.compute_fundamental_np(
                T1.astype(np.float32), T2.astype(np.float32),
                K.astype(np.float32), K.astype(np.float32))
            # epipole of cam1 in image 2
            pc = T2[:3, :3] @ O1 + T2[:3, 3]
            if abs(pc[2]) < 1e-6:
                epipole = np.array([1e6, 1e6], np.float32)
            else:
                epipole = np.array([cam.fx * pc[0] / pc[2] + cam.cx,
                                    cam.fy * pc[1] / pc[2] + cam.cy], np.float32)
            elig.append(int(kf2))
            F12s.append(F12)
            epis.append(epipole)

        if not elig:
            mp.update_connections(kf)
            return
        matches = self._triangulation_matches(kf, elig, F12s, epis, has_mp1, sigma2)

        for t, kf2 in enumerate(elig):
            T2 = mp.kf_Tcw[kf2]
            O2 = mp.kf_camera_center(kf2)
            ok, idx2 = matches[t]
            if not ok.any():
                continue

            i1 = np.nonzero(ok)[0]
            i2 = idx2[i1]
            uv1 = mp.kf_xy[kf, i1]
            uv2 = mp.kf_xy[kf2, i2]

            # ray parallax (reference :470-514)
            r1 = np.stack([(uv1[:, 0] - cam.cx) / cam.fx, (uv1[:, 1] - cam.cy) / cam.fy,
                           np.ones(len(i1))], -1)
            r2 = np.stack([(uv2[:, 0] - cam.cx) / cam.fx, (uv2[:, 1] - cam.cy) / cam.fy,
                           np.ones(len(i2))], -1)
            r1w = r1 @ T1[:3, :3]
            r2w = r2 @ T2[:3, :3]
            cos_rays = np.sum(r1w * r2w, -1) / np.maximum(
                np.linalg.norm(r1w, axis=-1) * np.linalg.norm(r2w, axis=-1), 1e-9)

            d1 = mp.kf_depth[kf, i1]
            d2 = mp.kf_depth[kf2, i2]
            cos_stereo = np.full_like(cos_rays, 1.1)
            if not self.monocular:
                with np.errstate(all="ignore"):
                    cs1 = np.cos(2 * np.arctan2(cam.baseline / 2, np.where(d1 > 0, d1, 1e9)))
                    cs2 = np.cos(2 * np.arctan2(cam.baseline / 2, np.where(d2 > 0, d2, 1e9)))
                cos_stereo = np.minimum(cs1, cs2)

            use_tri = (cos_rays < cos_stereo) & (cos_rays > 0) & \
                      ((d1 > 0) | (d2 > 0) | (cos_rays < 0.9998))

            P1 = K @ T1[:3, :]
            P2 = K @ T2[:3, :]
            pts = triangulate_dlt_np(
                P1.astype(np.float32), P2.astype(np.float32),
                uv1.astype(np.float32), uv2.astype(np.float32))
            # fall back to stereo unprojection when rays are too parallel
            if not self.monocular:
                bp1 = self._unproject(kf, i1)
                bp2 = self._unproject(kf2, i2)
                pts = np.where(use_tri[:, None], pts,
                               np.where((d1 > 0)[:, None], bp1,
                                        np.where((d2 > 0)[:, None], bp2, pts)))
                accept = use_tri | (d1 > 0) | (d2 > 0)
            else:
                accept = use_tri.copy()  # &= below must not alias use_tri

            # cheirality + reprojection + scale consistency (reference :551-651)
            pc1 = pts @ T1[:3, :3].T + T1[:3, 3]
            pc2 = pts @ T2[:3, :3].T + T2[:3, 3]
            accept &= (pc1[:, 2] > 0) & (pc2[:, 2] > 0)
            o1 = mp.kf_octave[kf, i1]
            o2 = mp.kf_octave[kf2, i2]
            for pc, uv, oct_, kf_i, ii in ((pc1, uv1, o1, kf, i1), (pc2, uv2, o2, kf2, i2)):
                with np.errstate(all="ignore"):
                    pu = cam.fx * pc[:, 0] / pc[:, 2] + cam.cx
                    pv = cam.fy * pc[:, 1] / pc[:, 2] + cam.cy
                    err = (pu - uv[:, 0]) ** 2 + (pv - uv[:, 1]) ** 2
                    chi2 = err / sigma2[oct_]
                    is_st = mp.kf_ur[kf_i, ii] >= 0
                    pur = pu - cam.bf / np.maximum(pc[:, 2], 1e-6)
                    err_st = err + (pur - mp.kf_ur[kf_i, ii]) ** 2
                    chi2 = np.where(is_st, err_st / sigma2[oct_], chi2)
                accept &= np.where(is_st, chi2 <= 7.8, chi2 <= 5.991)

            dist1 = np.linalg.norm(pts - O1, axis=-1)
            dist2 = np.linalg.norm(pts - O2, axis=-1)
            with np.errstate(all="ignore"):
                ratio_dist = dist2 / np.maximum(dist1, 1e-9)
                ratio_oct = self.scale_factors[o1] / self.scale_factors[o2]
            accept &= (dist1 > 0) & (dist2 > 0)
            accept &= (ratio_dist < ratio_oct * ratio_factor) & (ratio_dist * ratio_factor > ratio_oct)

            fresh = accept & (mp.kf_mp[kf, i1] < 0) & (mp.kf_mp[kf2, i2] < 0)
            sel = np.nonzero(fresh)[0]
            new_ids = mp.add_map_points_batch(
                pts[sel].astype(np.float32), kf, i1[sel], first_kf=kf)
            mp.add_observations_batch(new_ids, int(kf2), i2[sel])
            self.recent_points.extend(int(m) for m in new_ids)
            if len(new_ids):
                mp.update_point_descriptors(np.asarray(new_ids))
                mp.update_normal_and_depth(np.asarray(new_ids))
        mp.update_connections(kf)

    def _triangulation_matches(self, kf: int, elig, F12s, epis, has_mp1, sigma2):
        """Epipolar search of `kf` against all eligible neighbors, one
        batched call over the device keyframe store. Returns
        [(ok (N,), idx (N,))] per eligible neighbor."""
        mp = self.map
        store = self._kf_store()
        row1 = store.row_of(mp, kf)
        rows2 = [store.row_of(mp, k) for k in elig]
        hm2 = np.stack([mp.kf_mp[k] >= 0 for k in elig])
        ok_b, idx_b = DK.triangulation_search_kernel(
            row1, self._t(has_mp1), rows2, self._t(hm2), self._t(np.stack(F12s)),
            self._t(np.stack(epis)), store, self._t(sigma2))
        ok_b = ok_b.cpu().numpy()
        idx_b = idx_b.cpu().numpy()
        return [(ok_b[i], idx_b[i]) for i in range(len(elig))]

    def _unproject(self, kf: int, idxs) -> np.ndarray:
        cam = self.config.camera
        mp = self.map
        z = mp.kf_depth[kf, idxs]
        x = (mp.kf_xy[kf, idxs, 0] - cam.cx) / cam.fx * z
        y = (mp.kf_xy[kf, idxs, 1] - cam.cy) / cam.fy * z
        pc = np.stack([x, y, z], -1)
        T = mp.kf_Tcw[kf]
        return (pc - T[:3, 3]) @ T[:3, :3]

    # ------------------------------------------------------------------

    def _search_in_neighbors(self, kf: int):
        """Two-level neighbor fuse (reference: LocalMapping::SearchInNeighbors,
        LocalMapping.cc:688-832). Forward: the current keyframe's points
        into every target; backward: the targets' points into the current
        keyframe. Matches come from one map snapshot per call;
        _apply_fuse_matches re-checks point and slot validity."""
        mp = self.map
        n1 = 20 if self.monocular else 10
        targets = []
        seen = {kf}
        for nb in self._covisible(kf, n1):
            if nb not in seen:
                targets.append(int(nb))
                seen.add(int(nb))
        for nb in list(targets):
            for nb2 in self._covisible(nb, 5):
                if nb2 not in seen:
                    targets.append(int(nb2))
                    seen.add(int(nb2))

        cur_pts = mp.kf_mp[kf]
        cur_pts = np.unique(cur_pts[cur_pts >= 0])
        cur_pts = cur_pts[mp.mp_valid[cur_pts]]
        fuse_pts = (mp.points_of_keyframes(np.asarray(targets, np.int64)) if targets
                    else np.empty(0, np.int64))
        if targets:
            self._fuse_batched(targets, cur_pts)
        self._fuse_batched([kf], fuse_pts)

        touched = mp.kf_mp[kf]
        touched = np.unique(touched[touched >= 0])
        touched = touched[mp.mp_valid[touched]]
        mp.update_point_descriptors(touched)
        mp.update_normal_and_depth(touched)
        mp.update_connections(kf)

    def _point_pad(self, mp_ids: np.ndarray):
        """The points to fuse, the best observed first, padded to 8192
        slots: (ids, valid)."""
        cap = 8192
        mp_ids = counters.keep_best_observed(mp_ids, self.map.mp_n_obs, cap, "local_mapping.fuse")
        pad = cap - mp_ids.size
        return np.pad(mp_ids, (0, pad)), np.pad(self.map.mp_valid[mp_ids], (0, pad))

    def _fuse(self, kf: int, mp_ids: np.ndarray, th: float = 3.0):
        """Project points into keyframe kf and merge duplicates (reference:
        ORBmatcher::Fuse, ORBmatcher.cc:1100-1279), one keyframe at a time
        from the store as it stands: loop fusion (backend/loop_closing.py)
        calls it per keyframe of the corrected group, and each call sees the
        points the previous ones merged."""
        mp = self.map
        if mp_ids.size == 0:
            return
        ids, pvalid = self._point_pad(mp_ids)
        proj = M.project_and_cull(
            self._t(mp.mp_pos[ids]), self._t(pvalid), self._t(mp.mp_normal[ids]),
            self._t(mp.mp_min_dist[ids]), self._t(mp.mp_max_dist[ids]),
            self._t(mp.kf_Tcw[kf]), self.config.camera, self.config.orb.n_levels,
            self.log_scale, view_cos_limit=0.5)
        m = M.search_by_projection(
            proj, desc_to_torch(mp.mp_desc[ids], self.device), self._t(mp.kf_xy[kf]),
            self._t(mp.kf_ur[kf]), desc_to_torch(mp.kf_desc[kf], self.device),
            self._t(mp.kf_kp_valid[kf]), self._t(mp.kf_octave[kf]), self._scale_factors_t,
            th=th / 4.0, max_dist=M.TH_LOW, ratio=0.0, check_stereo=not self.monocular)
        self._apply_fuse_matches(kf, ids, m.ok.cpu().numpy(), m.idx.cpu().numpy())

    def _fuse_batched(self, kfs, mp_ids: np.ndarray, th: float = 3.0):
        """Fuse one shared point pad into several target keyframes with one
        batched call over the device keyframe store (reference:
        ORBmatcher::Fuse, ORBmatcher.cc:1100-1279); the per-target
        bookkeeping stays on the host."""
        mp = self.map
        if mp_ids.size == 0 or not kfs:
            return
        ids, pvalid = self._point_pad(mp_ids)
        store = self._kf_store()
        rows = [store.row_of(mp, int(k)) for k in kfs]
        Tcws = self._t(mp.kf_Tcw[np.asarray(kfs)].astype(np.float32))
        ok_b, idx_b = DK.fuse_targets_kernel(
            rows, Tcws, store, self._t(mp.mp_pos[ids]), self._t(pvalid),
            self._t(mp.mp_normal[ids]), self._t(mp.mp_min_dist[ids]),
            self._t(mp.mp_max_dist[ids]), desc_to_torch(mp.mp_desc[ids], self.device),
            self._scale_factors_t, self.config.camera, self.config.orb.n_levels,
            self.log_scale, th / 4.0, M.TH_LOW, not self.monocular)
        ok_b = ok_b.cpu().numpy()
        idx_b = idx_b.cpu().numpy()
        for i, t in enumerate(kfs):
            self._apply_fuse_matches(int(t), ids, ok_b[i], idx_b[i])

    def _apply_fuse_matches(self, kf: int, ids: np.ndarray, ok: np.ndarray,
                            idx: np.ndarray):
        """Host bookkeeping of fuse matches: merge duplicates towards the
        higher weighted observation count, add plain associations
        (reference: ORBmatcher::Fuse, ORBmatcher.cc:1219-1279)."""
        mp = self.map
        okj = np.nonzero(ok)[0]
        src = ids[okj].astype(np.int64)
        tgt = idx[okj].astype(np.int64)
        existing = mp.kf_mp[kf, tgt]
        exist_valid = (existing >= 0) & mp.mp_valid[np.maximum(existing, 0)]
        # conflicts (duplicate merge, reference :1219-1231: keep the point
        # with the higher weighted observation count) first, scalar — rare
        for j in np.nonzero(exist_valid)[0]:
            s, e = int(src[j]), int(existing[j])
            if not mp.mp_valid[s] or e == s:
                continue
            if not mp.mp_valid[e]:
                # an earlier replace in this pass killed the existing point
                # and freed the target slot: a plain new association
                if mp.kf_mp[kf, int(tgt[j])] < 0:
                    mp.add_observation(s, kf, int(tgt[j]))
                continue
            if mp.mp_wobs[e] >= mp.mp_wobs[s]:
                mp.replace_map_point(s, e)
            else:
                mp.replace_map_point(e, s)
        # plain new associations, batched (a replace above may have killed
        # a source or claimed a target slot — re-check both)
        simple = np.nonzero(~exist_valid)[0]
        if simple.size:
            s, t = src[simple], tgt[simple]
            live = mp.mp_valid[s] & (mp.kf_mp[kf, t] < 0)
            mp.add_observations_batch(s[live], kf, t[live])

    # ------------------------------------------------------------------

    def local_ba(self, kf: int):
        """Build + solve + merge the local-BA window (reference:
        Optimizer::LocalBundleAdjustment, Optimizer.cc:631-1030)."""
        with self.timer.stage("local_ba_build"):
            built = self._build_local_ba(kf)
        if built is not None:
            self._merge_local_ba(built, self._solve_local_ba(built))

    def _build_local_ba(self, kf: int):
        """Snapshot the local window into a BAProblem. Returns None if the
        window is degenerate."""
        mp = self.map
        local = [kf] + [int(x) for x in self._covisible(kf)]
        local = local[:BA_CAM_CAP - 8]          # leave room for fixed cams
        local_set = set(local)

        pts = mp.points_of_keyframes(np.asarray(local, np.int64))
        pts = counters.keep_best_observed(pts, mp.mp_n_obs, BA_PT_CAP, "local_ba.point_cap")

        # fixed cameras: other observers of the local points
        fixed = []
        obs_kfs = np.unique(mp.mp_obs_kf[pts][mp.mp_obs_kf[pts] >= 0])
        for k in obs_kfs:
            if int(k) not in local_set and mp.kf_valid[k] and int(k) not in self.pending:
                fixed.append(int(k))
                if len(local) + len(fixed) >= BA_CAM_CAP:
                    break
        cams = local + fixed

        e_cam, e_pt, e_obs, e_oct, n_edges_dropped = _gather_edges(mp, pts, cams, BA_EDGE_CAP)
        counters.truncated("local_ba.edge_cap", n_edges_dropped)

        E = len(e_cam)
        if E < 10:
            return None
        # pick the smallest bucket that fits
        for C, P, E_CAP in BA_BUCKETS:
            if len(cams) <= C and len(pts) <= P and E <= E_CAP:
                break
        pad_e = E_CAP - E

        cam_Tcw = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
        cam_Tcw[:len(cams)] = mp.kf_Tcw[cams]
        cam_free = np.zeros(C, bool)
        cam_free[:len(local)] = True
        # gauge: the first two keyframes of the map stay fixed (reference
        # fixes KF id<=1 inside local BA too, Optimizer.cc:711-716)
        for i, c in enumerate(cams):
            if c <= self.map.origin_kf + 1:
                cam_free[i] = False
        # gauge anchoring: BA needs >= 2 fixed cameras — one fixed camera
        # pins 6 DoF but leaves the monocular SCALE gauge free, and a window
        # with a free scale inflates a little on every invocation. Pin the
        # oldest cameras until at least two are fixed.
        n_fixed = int((~cam_free[:len(cams)]).sum())
        if n_fixed < 2 and len(cams) > 2:
            for i in np.argsort(cams):
                if cam_free[i]:
                    cam_free[i] = False
                    n_fixed += 1
                if n_fixed >= 2:
                    break
        cam_valid = np.zeros(C, bool)
        cam_valid[:len(cams)] = True

        points = np.zeros((P, 3), np.float32)
        points[:len(pts)] = mp.mp_pos[pts]
        point_valid = np.zeros(P, bool)
        point_valid[:len(pts)] = True

        prob = _problem(
            self.device, cam_Tcw, cam_free, cam_valid, points, point_valid,
            np.pad(e_cam, (0, pad_e)), np.pad(e_pt, (0, pad_e)),
            np.pad(e_obs, ((0, pad_e), (0, 0))), np.pad(e_oct, (0, pad_e)),
            np.pad(np.ones(E, bool), (0, pad_e)))
        return {"prob": prob, "cams": cams, "local": local, "cam_free": cam_free,
                "pts": pts, "e_cam": e_cam, "e_pt": e_pt, "E": E,
                # staleness guards of a solve made outside the map lock: point
                # slots are recycled by the free list, and a loop correction or
                # a global-BA merge moves the whole map (pose_epoch)
                "pt_first_kf": mp.mp_first_kf[pts].copy(), "pose_epoch": mp.pose_epoch}

    def _solve_local_ba(self, built):
        """The reference's 5 + 10 iteration schedule on the window; the
        result comes back to the host as numpy. It reads only the built
        problem, never the map, so it may run outside the map lock.

        Without `abort_ba_check` the schedule is one call. With it, as the
        JAX package and the reference (Optimizer.cc:893-935): the 5 robust
        iterations, a poll, and the 10 plain ones only if no keyframe
        waits; an aborted solve still returns its first phase. The split
        renormalizes the poses and re-gates the edges between its two
        calls, so it is not the one call's function bit for bit
        (tests/test_torch_async.py)."""
        prob = built["prob"]
        cam, inv_s2 = self.config.camera, self._inv_sigma2_t
        with self.timer.stage(f"local_ba_solve_{prob.cam_Tcw.shape[0]}cams"):
            if self.abort_ba_check is None:
                out = local_bundle_adjustment(prob, cam, inv_s2)
            else:
                out = local_bundle_adjustment(prob, cam, inv_s2, n_iters_pre=5, n_iters_post=0)
                if self.abort_ba_check():
                    self.n_ba_aborted += 1
                else:
                    out = local_bundle_adjustment(prob._replace(cam_Tcw=out[0], points=out[1]),
                                                  cam, inv_s2, n_iters_pre=0, n_iters_post=10)
            return tuple(a.cpu().numpy() for a in out)

    def _merge_local_ba(self, built, result):
        """Write the solved window back and erase the outlier observations
        (reference: Optimizer.cc:940-1007), unless the map moved under an
        off-lock solve: a moved pose_epoch discards the whole result, a
        recycled point slot its own row."""
        mp = self.map
        with self.timer.stage("local_ba_merge"):
            if mp.pose_epoch != built["pose_epoch"]:
                # the window's linearization point is gone; the next keyframe
                # runs local BA on the corrected map
                self.n_ba_stale += 1
                return
            new_cams, new_pts, inlier = result
            cams, local, cam_free = built["cams"], built["local"], built["cam_free"]
            pts, e_cam, e_pt, E = built["pts"], built["e_cam"], built["e_pt"], built["E"]

            for i, c in enumerate(cams[:len(local)]):
                if cam_free[i] and mp.kf_valid[c]:
                    mp.kf_Tcw[c] = new_cams[i]
            same = mp.mp_valid[pts] & (mp.mp_first_kf[pts] == built["pt_first_kf"])
            mp.mp_pos[pts[same]] = new_pts[:len(pts)][same]

            for e in np.nonzero(~inlier[:E])[0]:
                pi = int(e_pt[e])
                if not same[pi]:
                    continue
                p = int(pts[pi])
                k = cams[e_cam[e]]
                if mp.mp_valid[p] and mp.kf_valid[k]:
                    mp.erase_observation(p, k)
            mp.update_normal_and_depth(pts[same & mp.mp_valid[pts]])

    def global_ba(self, n_iters: int = 10):
        """Whole-map BA (reference: Optimizer::GlobalBundleAdjustemnt)."""
        mp = self.map
        built = build_global_ba_problem(mp, self.device)
        if built is None:
            return
        prob, kfs, pts = built
        cam_free = prob.cam_free.cpu().numpy()
        with self.timer.stage("global_ba"):
            new_cams, new_pts = solve_global_ba(prob, self.config.camera, self.inv_sigma2,
                                                n_iters=n_iters)
        for i, c in enumerate(kfs):
            if cam_free[i]:
                mp.kf_Tcw[c] = new_cams[i]
        mp.mp_pos[pts] = new_pts
        mp.update_normal_and_depth(pts)
        mp.pose_epoch += 1

    # ------------------------------------------------------------------

    def _keyframe_culling(self, kf: int):
        """reference: LocalMapping::KeyFrameCulling (LocalMapping.cc:966-1082):
        a local keyframe is redundant if >= 90% of its points are seen by
        >= 3 other keyframes at the same or finer scale."""
        mp = self.map
        close_th = self.config.th_depth * self.config.camera.baseline \
            if self.config.camera.bf > 0 else 0.0
        for k in self._covisible(kf):
            k = int(k)
            if k == mp.origin_kf or not mp.kf_valid[k]:
                continue
            if mp.kf_not_erase[k]:
                continue
            # native fast path (native/map_ops.cpp count_redundant)
            res = native_ops.count_redundant(mp, k, close_th, not self.monocular)
            if res is not None:
                considered, redundant = res
                if considered > 0 and redundant > 0.9 * considered:
                    mp.erase_keyframe(k)
                continue
            feat_idx = np.nonzero(mp.kf_mp[k] >= 0)[0]
            mps = mp.kf_mp[k, feat_idx]
            ok = mp.mp_valid[mps]
            feat_idx, mps = feat_idx[ok], mps[ok]
            if not self.monocular:
                # only close points count (reference :1006-1011)
                d = mp.kf_depth[k, feat_idx]
                close = (d > 0) & (d < self.config.th_depth * self.config.camera.baseline)
                feat_idx, mps = feat_idx[close], mps[close]
            if mps.size == 0:
                continue
            n_redundant = 0
            for fi, m in zip(feat_idx, mps):
                lvl = mp.kf_octave[k, fi]
                n_better = 0
                for o in range(mp.mp_n_obs[m]):
                    ok2 = int(mp.mp_obs_kf[m, o])
                    if ok2 == k or ok2 < 0:
                        continue
                    lvl2 = mp.kf_octave[ok2, int(mp.mp_obs_idx[m, o])]
                    if lvl2 <= lvl + 1:
                        n_better += 1
                        if n_better >= 3:
                            break
                if n_better >= 3:
                    n_redundant += 1
            if n_redundant > 0.9 * mps.size:
                mp.erase_keyframe(k)
