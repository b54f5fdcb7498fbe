"""Device-resident keyframe store + the batched mapping searches.

Counterpart of orb_slam2_detailed_comments_tpu/backend/device_kf.py:

  * per-keyframe keypoint arrays (xy, ur, desc, valid, octave, angle) are
    write-once at creation (state/map_store.py) and live in one
    device-resident (R, N, ...) buffer per field, written at first use;
  * fuse across all targets of a keyframe is one call over the target
    lanes (project + scale-window search per target);
  * triangulation search across all neighbors is likewise one call.

The JAX package maps over the lanes with jax.lax.map; here each call
loops over them, so one (P, N) distance matrix exists at a time. Both
compute the same function. Mutable per-call state (Tcw, per-keypoint
has-map-point flags) is small and uploaded each call; the keypoint pads
never leave the device.

Unlike the JAX package's store, growth keeps every row where it is: the
buffers double and the old rows are copied over, so row indices held by a
caller stay valid (the JAX package renumbers the live rows when it grows,
ROADMAP.md C.1).
"""
from __future__ import annotations

import numpy as np
import torch

from ..interop import desc_to_torch
from ..ops import matching as M


class DeviceKeyframeStore:
    """Write-once device mirror of per-keyframe keypoint arrays.

    Rows are assigned on first use (`row_of`) and never move; capacity
    doubles by copying the buffers (rare; growth is amortized)."""

    def __init__(self, kp_cap: int, capacity: int = 128, device="cuda"):
        self.N = kp_cap
        self.device = torch.device(device)
        self.kf_row: dict[int, int] = {}
        self._alloc(capacity)

    def _alloc(self, capacity):
        N, dev = self.N, self.device
        self.d_xy = torch.zeros((capacity, N, 2), dtype=torch.float32, device=dev)
        self.d_ur = torch.zeros((capacity, N), dtype=torch.float32, device=dev)
        self.d_desc = torch.zeros((capacity, N, 8), dtype=torch.int32, device=dev)
        self.d_valid = torch.zeros((capacity, N), dtype=torch.bool, device=dev)
        self.d_octave = torch.zeros((capacity, N), dtype=torch.int32, device=dev)
        self.d_angle = torch.zeros((capacity, N), dtype=torch.float32, device=dev)
        self.C = capacity

    _FIELDS = ("d_xy", "d_ur", "d_desc", "d_valid", "d_octave", "d_angle")

    def row_of(self, ms, kf: int) -> int:
        """Row index for keyframe `kf`, uploading its arrays on first use."""
        r = self.kf_row.get(kf)
        if r is not None:
            return r
        if len(self.kf_row) >= self.C:
            self._grow()
        r = len(self.kf_row)
        self.kf_row[kf] = r
        self._upload(ms, kf, r)
        return r

    def _upload(self, ms, kf: int, row: int):
        dev = self.device
        self.d_xy[row] = torch.from_numpy(np.asarray(ms.kf_xy[kf], np.float32)).to(dev)
        self.d_ur[row] = torch.from_numpy(np.asarray(ms.kf_ur[kf], np.float32)).to(dev)
        self.d_desc[row] = desc_to_torch(ms.kf_desc[kf], dev)
        self.d_valid[row] = torch.from_numpy(np.asarray(ms.kf_kp_valid[kf], bool)).to(dev)
        self.d_octave[row] = torch.from_numpy(np.asarray(ms.kf_octave[kf], np.int32)).to(dev)
        self.d_angle[row] = torch.from_numpy(np.asarray(ms.kf_angle[kf], np.float32)).to(dev)

    def _grow(self):
        old = {f: getattr(self, f) for f in self._FIELDS}
        n = self.C
        self._alloc(2 * n)
        for f, a in old.items():
            getattr(self, f)[:n] = a

    def clear(self):
        self.kf_row.clear()
        self._alloc(self.C)


# ---------------------------------------------------------------------------
# The batched searches over target lanes.
# ---------------------------------------------------------------------------


def fuse_targets_kernel(rows, Tcws, store: DeviceKeyframeStore,
                        mp_pos, mp_valid, mp_normal, mp_min, mp_max, mp_desc,
                        scale_factors, cam, n_levels: int, log_scale: float,
                        th: float, max_dist: int, check_stereo: bool):
    """Fuse one shared point pad into T target keyframes.

    rows (T,) store rows; Tcws (T, 4, 4) tensors. Returns (ok (T, P) bool,
    idx (T, P) int32) per-lane match results (reference: the per-target
    ORBmatcher::Fuse loop of LocalMapping::SearchInNeighbors,
    LocalMapping.cc:688-832)."""
    oks, idxs = [], []
    for row, Tcw in zip(rows, Tcws):
        proj = M.project_and_cull(mp_pos, mp_valid, mp_normal, mp_min, mp_max, Tcw, cam,
                                  n_levels, log_scale, view_cos_limit=0.5)
        m = M.search_by_projection(
            proj, mp_desc, store.d_xy[row], store.d_ur[row], store.d_desc[row],
            store.d_valid[row], store.d_octave[row], scale_factors, th=th,
            max_dist=max_dist, ratio=0.0, check_stereo=check_stereo)
        oks.append(m.ok)
        idxs.append(m.idx)
    return torch.stack(oks), torch.stack(idxs)


def triangulation_search_kernel(row1, has_mp1, rows2, has_mp2, F12s, epipoles,
                                store: DeviceKeyframeStore, sigma2):
    """Epipolar search of KF1 against T neighbor keyframes.

    row1: store row of the new keyframe; has_mp1 (N,) bool current
    associations; rows2 (T,) neighbor rows; has_mp2 (T, N); F12s (T,3,3);
    epipoles (T,2). Returns (ok (T,N), idx (T,N))."""
    xy1, desc1 = store.d_xy[row1], store.d_desc[row1]
    valid1, oct1, ang1 = store.d_valid[row1], store.d_octave[row1], store.d_angle[row1]
    oks, idxs = [], []
    for t, row2 in enumerate(rows2):
        m = M.search_for_triangulation(
            xy1, desc1, valid1, oct1, ang1, has_mp1,
            store.d_xy[row2], store.d_desc[row2], store.d_valid[row2],
            store.d_octave[row2], store.d_angle[row2], has_mp2[t],
            F12s[t], epipoles[t], sigma2)
        oks.append(m.ok)
        idxs.append(m.idx)
    return torch.stack(oks), torch.stack(idxs)


def compute_fundamental_np(Tcw1, Tcw2, K1, K2):
    """F12 from two world-to-camera poses, host 3x3 math (reference:
    LocalMapping::ComputeF12, src/LocalMapping.cc:835-855; the JAX
    package's ops.matching.compute_fundamental and its host twin)."""
    R1, t1 = Tcw1[:3, :3], Tcw1[:3, 3]
    R2, t2 = Tcw2[:3, :3], Tcw2[:3, 3]
    R12 = R1 @ R2.T
    t12 = -R12 @ t2 + t1
    tx = np.array([
        [0.0, -t12[2], t12[1]],
        [t12[2], 0.0, -t12[0]],
        [-t12[1], t12[0], 0.0],
    ], np.float32)
    K1i = np.linalg.inv(K1)
    K2i = np.linalg.inv(K2)
    return (K1i.T @ tx @ R12 @ K2i).astype(np.float32)
