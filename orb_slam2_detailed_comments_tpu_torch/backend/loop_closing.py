"""Loop closing stage.

Counterpart of orb_slam2_detailed_comments_tpu/backend/loop_closing.py,
the replacement of the LoopClosing thread (reference: src/LoopClosing.cc).
It runs per keyframe after local mapping, in the caller's thread or on the
asynchronous pipeline's worker (backend/async_pipeline.py):

  on_new_keyframe
  ├─ DetectLoop      (reference :156-388): BoW candidates from the keyframe
  │    database + covisibility-consistency chains (>= 3)
  ├─ ComputeSim3     (reference :406-665): descriptor match -> batched Horn
  │    Sim3 RANSAC -> Sim3 Gauss-Newton refinement -> projection check
  └─ CorrectLoop     (reference :676-973): Sim3 propagation to the covisible
       group, map-point correction, loop fusion, essential-graph pose
       optimization, loop edge insertion, global BA

The matchers and solvers run on `device`; the bookkeeping is host numpy,
with the JAX package's containers and its float32 / float64 boundaries
(a loop correction feeds a chaotic downstream). 4x4 Sim3 algebra runs on
CPU tensors. Each stage is timed by `timer` (utils/timing.StageTimer):
detect, sim3, correct (propagation, point correction and fusion),
essential_graph and global_ba.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..geometry.sim3 import make_sim3, sim3_inverse, sim3_to_se3
from ..interop import desc_to_torch
from ..ops import matching as M
from ..optim.pose_graph import PoseGraphProblem, optimize_pose_graph, pose_graph_backend
from ..optim.sim3_opt import optimize_sim3
from ..place.kf_database import KeyFrameDatabase
from ..solvers.sim3_solver import solve_sim3_ransac
from ..state.map_store import MapStore
from ..utils.config import SlamConfig
from ..utils.timing import StageTimer

CONSISTENCY_TH = 3  # reference: mnCovisibilityConsistencyTh (LoopClosing.cc:80)


def _cpu(fn, S: np.ndarray) -> np.ndarray:
    """A geometry/sim3.py function of float32 (..., 4, 4) matrices, on the CPU."""
    return fn(torch.from_numpy(np.asarray(S, np.float32))).numpy()


class LoopCloser:
    def __init__(self, config: SlamConfig, map_store: MapStore, voc, kfdb: KeyFrameDatabase,
                 fix_scale: bool, local_mapper=None, run_global_ba: bool = True,
                 gba_runner=None, device="cuda"):
        self.config = config
        self.map = map_store
        self.voc = voc
        self.kfdb = kfdb
        self.fix_scale = fix_scale
        self.local_mapper = local_mapper
        if run_global_ba and gba_runner is None:
            raise ValueError("run_global_ba needs a gba_runner (backend/gba_runner.py)")
        self.run_global_ba = run_global_ba
        # the global BA after a loop (backend/gba_runner.py)
        self.gba_runner = gba_runner
        self.device = torch.device(device)
        sf = config.orb.scale_factor
        self.scale_factors = np.array([sf ** i for i in range(config.orb.n_levels)], np.float32)
        self.sigma2 = (self.scale_factors ** 2).astype(np.float32)
        self.inv_sigma2 = (1.0 / self.sigma2).astype(np.float32)
        self.log_scale = float(np.log(sf))
        # consistency chains: list of (group_set, count)
        self.consistent_groups: List[Tuple[Set[int], int]] = []
        self.last_loop_kf = -1
        self.n_loops_closed = 0
        # per-keyframe bag of words, sparse (ids, weights), on every path
        # (the JAX package's online-vocabulary path stores dense vectors,
        # which _detect_loop cannot read: ROADMAP.md C.11)
        self.kf_bow: Dict[int, tuple] = {}
        self.timer = StageTimer()
        # the last essential graph solved: (backend, keyframes, edges)
        self.last_graph: Optional[Tuple[str, int, int]] = None

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def _desc(self, a) -> torch.Tensor:
        return desc_to_torch(a, self.device)

    def reset(self):
        self.consistent_groups.clear()
        self.kfdb.clear()
        self.kf_bow.clear()
        self.last_loop_kf = -1

    # ------------------------------------------------------------------

    def on_new_keyframe(self, kf: int) -> bool:
        """Returns True if a loop was detected and corrected."""
        with self.timer.stage("detect"):
            _, bow = self.voc.transform(self.map.kf_desc[kf], self.map.kf_kp_valid[kf])
            ids = np.nonzero(bow > 0)[0]
            self.kf_bow[kf] = (ids, bow[ids])
            candidates = self._detect_loop(kf, bow)
            # nothing below reads the database, and the candidate search
            # leaves kf out: indexing it now is indexing it last
            self.kfdb.add(kf, bow)
        if not candidates:
            return False
        with self.timer.stage("sim3"):
            result = self._compute_sim3(kf, candidates)
        if result is None:
            return False
        loop_kf, S_cl, loop_points = result
        self._correct_loop(kf, loop_kf, S_cl, loop_points)
        return True

    # ------------------------------------------------------------------

    def _detect_loop(self, kf: int, bow: np.ndarray) -> List[int]:
        """reference: LoopClosing::DetectLoop (LoopClosing.cc:156-388)."""
        # too close to the last loop or map too small (reference :165-175)
        if kf < 10 or (self.last_loop_kf >= 0 and kf < self.last_loop_kf + 10):
            self.consistent_groups.clear()
            return []

        covis = self.map.get_covisible(kf)
        min_score = 1.0
        for nb in covis:
            nb_bow = self.kf_bow.get(int(nb))
            if nb_bow is None:
                continue
            nb_ids, nb_vals = nb_bow
            s = float(np.minimum(bow[nb_ids], nb_vals).sum())
            min_score = min(min_score, s)

        cands = self.kfdb.detect_loop_candidates(kf, bow, min_score, covis, self.map)
        if not cands:
            self.consistent_groups.clear()
            return []

        # covisibility-consistency chains (reference :225-367); a group that
        # meets no previous one enters with count 0
        new_groups: List[Tuple[Set[int], int]] = []
        enough: List[int] = []
        for c in cands:
            group = {c} | {int(x) for x in self.map.get_covisible(c)}
            best_count = 0
            for prev_group, count in self.consistent_groups:
                if group & prev_group:
                    best_count = max(best_count, count + 1)
            new_groups.append((group, best_count))
            if best_count >= CONSISTENCY_TH:
                enough.append(c)
        self.consistent_groups = new_groups
        return enough

    # ------------------------------------------------------------------

    def _compute_sim3(self, kf: int, candidates: List[int]):
        """reference: LoopClosing::ComputeSim3 (LoopClosing.cc:406-665).
        Returns (loop_kf, S_cl mapping loop -> current camera, loop point
        ids) or None."""
        mp = self.map
        K = self.config.camera.K("cpu").numpy()
        for cand in candidates:
            if not mp.kf_valid[cand]:
                continue
            kf_has = mp.kf_mp[kf] >= 0
            cd_has = mp.kf_mp[cand] >= 0
            m = M.match_descriptors(
                self._desc(mp.kf_desc[kf]), self._t(mp.kf_kp_valid[kf] & kf_has),
                self._desc(mp.kf_desc[cand]), self._t(mp.kf_kp_valid[cand] & cd_has),
                angle_a=self._t(mp.kf_angle[kf]), angle_b=self._t(mp.kf_angle[cand]),
                max_dist=M.TH_LOW, ratio=0.75)
            ok = m.ok.cpu().numpy()
            idx = m.idx.cpu().numpy()
            if ok.sum() < 20:  # reference :476
                continue

            i_cur = np.nonzero(ok)[0]
            i_lp = idx[i_cur]
            mp_cur = mp.kf_mp[kf, i_cur]
            mp_lp = mp.kf_mp[cand, i_lp]
            good = ((mp_cur >= 0) & (mp_lp >= 0) & mp.mp_valid[np.maximum(mp_cur, 0)]
                    & mp.mp_valid[np.maximum(mp_lp, 0)])
            i_cur, i_lp, mp_cur, mp_lp = i_cur[good], i_lp[good], mp_cur[good], mp_lp[good]
            if len(i_cur) < 20:
                continue

            T1 = mp.kf_Tcw[kf]
            T2 = mp.kf_Tcw[cand]
            p1 = mp.mp_pos[mp_cur] @ T1[:3, :3].T + T1[:3, 3]   # camera frame of kf
            p2 = mp.mp_pos[mp_lp] @ T2[:3, :3].T + T2[:3, 3]    # camera frame of cand
            uv1 = mp.kf_xy[kf, i_cur]
            uv2 = mp.kf_xy[cand, i_lp]
            o1 = mp.kf_octave[kf, i_cur]
            o2 = mp.kf_octave[cand, i_lp]

            # RANSAC Sim3: maps cand camera -> kf camera (solves p2 -> p1)
            res = solve_sim3_ransac(p2, p1, uv2, uv1, np.ones(len(p1), bool), o2, o1,
                                    self.sigma2, K, self.fix_scale, min_inliers=20, seed=kf,
                                    device=self.device)
            if res is None:
                continue

            S0 = make_sim3(torch.from_numpy(res.R), torch.from_numpy(res.t),
                           torch.tensor(res.s, dtype=torch.float32)).numpy()
            opt = optimize_sim3(S0, p1, p2, uv1, uv2, res.inliers, self.inv_sigma2[o1],
                                self.inv_sigma2[o2], K, fix_scale=self.fix_scale,
                                device=self.device)
            if int(opt.n_inliers) < 20:  # reference :555
                continue
            S_cl = opt.S12.cpu().numpy()  # cand camera -> kf camera

            # final projection check: the loop neighbourhood's points
            # projected into the current keyframe with the corrected pose
            # (reference :594-655)
            loop_group = [cand] + [int(x) for x in mp.get_covisible(cand)]
            loop_points = mp.points_of_keyframes(np.asarray(loop_group, np.int64))
            if loop_points.size == 0:
                continue
            Scw = S_cl @ T2  # world -> current camera (Sim3-corrected)
            # the current keypoints whose Sim3 match survived the
            # refinement's chi2 pruning: the projection search skips them
            # and the >= 40 gate counts them (reference: Optimizer.cc:
            # 1556-1571, LoopClosing.cc:636-655)
            prematched = i_cur[opt.inliers.cpu().numpy()]
            n_total = self._count_projection_matches(kf, loop_points, Scw, prematched)
            if n_total >= 40:
                return cand, S_cl, loop_points
        return None

    def _count_projection_matches(self, kf: int, loop_points: np.ndarray, Scw: np.ndarray,
                                  prematched_kp: Optional[np.ndarray] = None) -> int:
        """Total loop-match count for the >= 40 acceptance gate (reference:
        LoopClosing.cc:594-655): keypoints already matched by the Sim3 stage
        are left out of the projection search (the reference's
        SearchByProjection skips filled slots, ORBmatcher.cc:422-568) and
        counted once beside the new projection matches."""
        mp = self.map
        cap = 8192
        ids = loop_points[:cap]
        pad = cap - ids.size
        ids_p = np.pad(ids, (0, pad))
        pvalid = np.pad(np.ones(ids.size, bool), (0, pad))
        # [sR | t] projects as [R | t/s]
        Tcw = _cpu(sim3_to_se3, Scw)
        kp_free = mp.kf_kp_valid[kf].copy()
        n_prematched = 0
        if prematched_kp is not None and prematched_kp.size:
            kp_free[prematched_kp] = False
            n_prematched = int(prematched_kp.size)
        proj = M.project_and_cull(
            self._t(mp.mp_pos[ids_p]), self._t(pvalid), self._t(mp.mp_normal[ids_p]),
            self._t(mp.mp_min_dist[ids_p]), self._t(mp.mp_max_dist[ids_p]), self._t(Tcw),
            self.config.camera, self.config.orb.n_levels, self.log_scale, view_cos_limit=0.5)
        m = M.search_by_projection(
            proj, self._desc(mp.mp_desc[ids_p]), self._t(mp.kf_xy[kf]), self._t(mp.kf_ur[kf]),
            self._desc(mp.kf_desc[kf]), self._t(kp_free), self._t(mp.kf_octave[kf]),
            self._t(self.scale_factors), th=10.0 / 4.0, max_dist=M.TH_HIGH, ratio=0.0)
        return int(m.ok.sum()) + n_prematched

    # ------------------------------------------------------------------

    def _correct_loop(self, kf: int, loop_kf: int, S_cl: np.ndarray, loop_points: np.ndarray):
        """reference: LoopClosing::CorrectLoop (LoopClosing.cc:676-973)."""
        mp = self.map
        with self.timer.stage("correct"):
            # a global BA of a previous loop is stale now (reference :699-712).
            # No join: this runs under the map lock in async mode, where the
            # solving thread may be waiting for that lock to merge; the
            # generation guard voids its merge instead
            if self.gba_runner is not None:
                self.gba_runner.request_stop(join=False)

            # S_cl maps the loop camera to the current one, so the corrected
            # world -> current transform chains the loop keyframe's pose
            Scw_corr = (S_cl @ mp.kf_Tcw[loop_kf]).astype(np.float32)

            # the current neighbourhood (current + covisible)
            group = [kf] + [int(x) for x in mp.get_covisible(kf)]
            T_w_cur = np.linalg.inv(mp.kf_Tcw[kf]).astype(np.float32)

            corrected: Dict[int, np.ndarray] = {}
            uncorrected: Dict[int, np.ndarray] = {}
            for g in group:
                T_g_w = mp.kf_Tcw[g]
                uncorrected[g] = T_g_w.copy()
                # the pose relative to the current keyframe stays rigid
                # (reference :755-792)
                corrected[g] = ((T_g_w @ T_w_cur) @ Scw_corr).astype(np.float32)

            # correct the map points the group sees (reference :799-840)
            moved: Set[int] = set()
            for g in group:
                S_new_inv = _cpu(sim3_inverse, corrected[g])
                S_old = uncorrected[g]
                pts = mp.kf_mp[g]
                pts = np.unique(pts[pts >= 0])
                pts = pts[mp.mp_valid[pts]]
                pts = np.asarray([p for p in pts if p not in moved], np.int64)
                if pts.size == 0:
                    continue
                pc = mp.mp_pos[pts] @ S_old[:3, :3].T + S_old[:3, 3]
                mp.mp_pos[pts] = pc @ S_new_inv[:3, :3].T + S_new_inv[:3, 3]
                moved.update(int(p) for p in pts)
                # the SE3 pose, scale folded into the translation
                mp.kf_Tcw[g] = _cpu(sim3_to_se3, corrected[g])

            mp.update_normal_and_depth(np.asarray(sorted(moved), np.int64))

            # covisible neighbours before fusion: the difference after it
            # names the new cross-loop connections (reference :900-911)
            prev_neighbors = {g: {int(x) for x in mp.get_covisible(g)} for g in group}

            # fuse the loop points into the corrected neighbourhood
            # (reference :861-887 and SearchAndFuse :983-1023)
            if self.local_mapper is not None:
                for g in group:
                    self.local_mapper._fuse(g, loop_points, th=4.0)
                touched = mp.points_of_keyframes(np.asarray(group, np.int64))
                mp.update_point_descriptors(touched)
                mp.update_normal_and_depth(touched)
            for g in group:
                mp.update_connections(g)

            # LoopConnections: links each group member gained through the
            # fusion, to the loop side; they carry loop-class (corrected-pose)
            # measurements in the essential graph (reference :913-927)
            group_set = set(group)
            loop_connections: Dict[int, Set[int]] = {}
            for g in group:
                new_links = {int(x) for x in mp.get_covisible(g)} - prev_neighbors[g] - group_set
                if new_links:
                    loop_connections[g] = new_links

        with self.timer.stage("essential_graph"):
            self._optimize_essential_graph(kf, loop_kf, corrected, uncorrected,
                                           loop_connections)
            mp.add_loop_edge(kf, loop_kf)
            mp.pose_epoch += 1
            self.last_loop_kf = kf
            self.n_loops_closed += 1

        if self.run_global_ba:
            with self.timer.stage("global_ba"):
                self.gba_runner.launch(n_iters=10)

    # ------------------------------------------------------------------

    def _optimize_essential_graph(self, kf: int, loop_kf: int,
                                  corrected: Dict[int, np.ndarray],
                                  uncorrected: Dict[int, np.ndarray],
                                  loop_connections: Optional[Dict[int, Set[int]]] = None):
        """Build and solve the essential graph (reference:
        Optimizer::OptimizeEssentialGraph, Optimizer.cc:1050-1381).

        loop_connections: {group keyframe -> cross-loop keyframes newly
        linked by the fusion}; these pairs get loop-class edges measured
        from the corrected poses (reference: Optimizer.cc:1137-1160), all
        others odometry-class edges (pre-correction measurements). The
        first edge of a pair wins, so the order edges are added in is part
        of the result."""
        mp = self.map
        kfs = mp.keyframe_ids()
        slot = {int(k): i for i, k in enumerate(kfs)}
        K = len(kfs)

        # vertex seeds: the corrected group from its full Sim3 (the measured
        # scale, the prior a monocular loop needs, reference:
        # Optimizer.cc:1099-1114), the others from their SE3 pose
        S_init = np.stack([corrected.get(int(k), mp.kf_Tcw[int(k)])
                           for k in kfs]).astype(np.float32)
        fixed = np.zeros(K, bool)
        fixed[slot[loop_kf]] = True  # the reference fixes the loop keyframe (:1090)
        if mp.origin_kf in slot:
            fixed[slot[mp.origin_kf]] = True

        e_i, e_j, e_S, e_w = [], [], [], []
        added = set()

        def add_edge(a: int, b: int, Sji: np.ndarray, w: float):
            key = (min(a, b), max(a, b))
            if key in added or a == b:
                return
            added.add(key)
            e_i.append(slot[a])
            e_j.append(slot[b])
            e_S.append(Sji)
            e_w.append(w)

        def rel(i: int, j: int) -> np.ndarray:
            """Odometry-class measurement Sji (error log(Sji Si Sj^-1)) from
            the pre-correction poses (reference: Optimizer.cc:1155-1296)."""
            Si = uncorrected.get(i, mp.kf_Tcw[i])
            Sj = uncorrected.get(j, mp.kf_Tcw[j])
            return (Sj @ np.linalg.inv(Si)).astype(np.float32)

        def rel_corrected(i: int, j: int) -> np.ndarray:
            """Loop-class measurement from the Sim3-corrected poses, the new
            information of the loop (reference: Optimizer.cc:1103-1152)."""
            Si = corrected.get(i, mp.kf_Tcw[i])
            Sj = corrected.get(j, mp.kf_Tcw[j])
            return (Sj @ np.linalg.inv(Si)).astype(np.float32)

        # loop-class edges first: the new kf <-> loop_kf edge and every
        # cross-loop connection of the fusion (reference: Optimizer.cc:
        # 1137-1160, the minFeat = 100 gate except for the primary pair)
        add_edge(kf, loop_kf, rel_corrected(kf, loop_kf), 1.0)
        for a, conns in (loop_connections or {}).items():
            for b in conns:
                if b not in slot:
                    continue
                if not ((a == kf and b == loop_kf) or mp.covis[a, b] >= 100):
                    continue
                add_edge(a, b, rel_corrected(a, b), 1.0)

        for k in kfs:
            k = int(k)
            parent = int(mp.parent[k])
            if parent >= 0 and parent in slot:
                add_edge(k, parent, rel(k, parent), 1.0)
            for (a, b) in mp.loop_edges:
                if a == k and b in slot:
                    add_edge(a, b, rel(a, b), 1.0)
            for nb in mp.get_covisible(k):
                nb = int(nb)
                if mp.covis[k, nb] >= 100 and nb in slot:
                    add_edge(k, nb, rel(k, nb), 1.0)

        if not e_i:
            return
        prob = PoseGraphProblem(
            S_init=S_init, vertex_fixed=fixed, vertex_valid=np.ones(K, bool),
            edge_i=np.asarray(e_i, np.int32), edge_j=np.asarray(e_j, np.int32),
            edge_Sji=np.stack(e_S), edge_valid=np.ones(len(e_i), bool),
            edge_weight=np.asarray(e_w, np.float32))
        self.last_graph = (pose_graph_backend(prob), K, len(e_i))
        S_opt = optimize_pose_graph(prob, n_iters=20, device=self.device).cpu().numpy()

        # SE3 poses back, and the map points moved through their reference
        # keyframe (reference: Optimizer.cc:1297-1345)
        old_poses = {int(k): mp.kf_Tcw[int(k)].copy() for k in kfs}
        new_se3 = dict(zip((int(k) for k in kfs), _cpu(sim3_to_se3, S_opt)))

        all_pts = mp.points_of_keyframes(kfs)
        ref = mp.mp_ref_kf[all_pts]
        for k in np.unique(ref):
            k = int(k)
            if k not in new_se3:
                continue
            sel = all_pts[ref == k]
            S_old = old_poses[k]
            # x_new = T_new^-1 * S_old * x_old (re-anchored on the ref KF)
            S_new_inv = np.linalg.inv(new_se3[k]).astype(np.float32)
            pc = mp.mp_pos[sel] @ S_old[:3, :3].T + S_old[:3, 3]
            mp.mp_pos[sel] = pc @ S_new_inv[:3, :3].T + S_new_inv[:3, 3]
        for k in kfs:
            mp.kf_Tcw[int(k)] = new_se3[int(k)]
        mp.update_normal_and_depth(all_pts)
