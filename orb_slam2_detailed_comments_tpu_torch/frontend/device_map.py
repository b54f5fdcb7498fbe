"""Device-resident tracking local map.

Counterpart of orb_slam2_detailed_comments_tpu/frontend/device_map.py. The
tracker's local-map pad stays ON the device with a persistent slot layout,
and only a per-frame DELTA is uploaded:

  * slots are sticky: a map point keeps its pad slot while it remains in
    the tracking local map (the covisibility local-map set of consecutive
    frames overlaps almost completely), so set churn is small;
  * changed rows are detected by diffing against a host shadow of exactly
    what the device holds — correctness never depends on catching every
    MapStore mutation site;
  * rows are uploaded as ONE packed (rows, 8) float32 block
    [pos(3), normal(3), min_dist, max_dist] + a (rows, 8) int32 descriptor
    block (the bit-view of the map's uint32 words) + slot indices, padded to
    the same few bucket sizes as the JAX package's.

The JAX package scatters with row index P for the dead update slots and
mode="drop". Here the device buffers have P + 1 rows: the dead slots land
in the last row, which the pad views (`d_packed`, `d_desc`, `d_valid`, the
first P rows) never show, and no index is out of range.
"""
from __future__ import annotations

import numpy as np
import torch

from ..interop import desc_to_torch

UPDATE_BUCKETS = (64, 512, 4096)  # delta shapes; bigger -> full upload


class DeviceLocalMap:
    """Persistent device pad of the tracking local map with delta updates.

    Device state (all capacity P, views of P + 1-row buffers):
      d_packed (P, 8) f32: pos xyz, normal xyz, min_dist, max_dist
      d_desc   (P, 8) int32 bit-view of the uint32 descriptors
      d_valid  (P,) bool
    Host state: slot_mp (P,) int64 map-point id per slot (-1 free), plus a
    host shadow of packed/desc/valid for diffing.
    """

    def __init__(self, capacity: int, device="cuda"):
        self.P = capacity
        self.device = torch.device(device)
        self.slot_mp = np.full(capacity, -1, np.int64)
        self._shadow_packed = np.zeros((capacity, 8), np.float32)
        self._shadow_desc = np.zeros((capacity, 8), np.uint32)
        self._shadow_valid = np.zeros(capacity, bool)
        self._alloc()
        # telemetry: rows of the last delta, and full re-uploads
        self.last_rows_uploaded = 0
        self.full_uploads = 0

    def _alloc(self) -> None:
        P, dev = self.P, self.device
        self._buf_packed = torch.zeros((P + 1, 8), dtype=torch.float32, device=dev)
        self._buf_desc = torch.zeros((P + 1, 8), dtype=torch.int32, device=dev)
        self._buf_valid = torch.zeros(P + 1, dtype=torch.bool, device=dev)

    @property
    def d_packed(self) -> torch.Tensor:
        return self._buf_packed[: self.P]

    @property
    def d_desc(self) -> torch.Tensor:
        return self._buf_desc[: self.P]

    @property
    def d_valid(self) -> torch.Tensor:
        return self._buf_valid[: self.P]

    def refresh(self, ms, mp_ids: np.ndarray) -> None:
        """Make the device pad hold exactly `mp_ids` (<= P ids, assumed
        valid in `ms`), reusing slots of ids already present."""
        if mp_ids.size > self.P:
            raise ValueError(f"{mp_ids.size} map points do not fit a {self.P}-slot pad")
        # sticky slot assignment (vectorized set ops)
        keep = (self.slot_mp >= 0) & np.isin(self.slot_mp, mp_ids)
        new_ids = np.setdiff1d(mp_ids, self.slot_mp[keep])
        free = np.nonzero(~keep)[0]
        n_new = new_ids.size
        self.slot_mp[free[:n_new]] = new_ids
        self.slot_mp[free[n_new:]] = -1
        keep[free[:n_new]] = True

        # desired pad contents (host gather — cheap numpy)
        live = np.nonzero(keep)[0]
        ids = self.slot_mp[live]
        want_packed = np.zeros((self.P, 8), np.float32)
        want_desc = np.zeros((self.P, 8), np.uint32)
        want_valid = np.zeros(self.P, bool)
        if live.size:
            want_packed[live, 0:3] = ms.mp_pos[ids]
            want_packed[live, 3:6] = ms.mp_normal[ids]
            want_packed[live, 6] = ms.mp_min_dist[ids]
            want_packed[live, 7] = ms.mp_max_dist[ids]
            want_desc[live] = ms.mp_desc[ids]
            want_valid[live] = ms.mp_valid[ids]

        changed = (
            (want_valid != self._shadow_valid)
            | (want_valid & (
                (want_packed != self._shadow_packed).any(axis=1)
                | (want_desc != self._shadow_desc).any(axis=1)))
        )
        rows = np.nonzero(changed)[0]
        self.last_rows_uploaded = int(rows.size)
        if rows.size == 0:
            return
        if rows.size > UPDATE_BUCKETS[-1]:
            self.full_uploads += 1
        self._upload(rows, want_packed, want_desc, want_valid)
        self._shadow_packed = want_packed
        self._shadow_desc = want_desc
        self._shadow_valid = want_valid

    def _upload(self, rows: np.ndarray, want_packed: np.ndarray, want_desc: np.ndarray,
                want_valid: np.ndarray) -> None:
        """Write the changed `rows` of the wanted pad to the device: a
        bucketed delta, or the whole pad past the largest bucket."""
        dev = self.device
        if rows.size > UPDATE_BUCKETS[-1]:
            # rare (loop correction / GBA rewrote the map): full re-upload
            self.d_packed.copy_(torch.from_numpy(want_packed))
            self.d_desc.copy_(desc_to_torch(want_desc, "cpu"))
            self.d_valid.copy_(torch.from_numpy(want_valid))
        else:
            bucket = next(b for b in UPDATE_BUCKETS if rows.size <= b)
            rpad = np.full(bucket, self.P, np.int64)  # P = the dump row
            rpad[: rows.size] = rows
            up_packed = np.zeros((bucket, 8), np.float32)
            up_desc = np.zeros((bucket, 8), np.uint32)
            up_valid = np.zeros(bucket, bool)
            up_packed[: rows.size] = want_packed[rows]
            up_desc[: rows.size] = want_desc[rows]
            up_valid[: rows.size] = want_valid[rows]
            r = torch.from_numpy(rpad).to(dev)
            self._buf_packed.index_copy_(0, r, torch.from_numpy(up_packed).to(dev))
            self._buf_desc.index_copy_(0, r, desc_to_torch(up_desc, dev))
            self._buf_valid.index_copy_(0, r, torch.from_numpy(up_valid).to(dev))

    def invalidate(self) -> None:
        """Force a full re-upload on the next refresh (map reset)."""
        self.slot_mp[:] = -1
        self._shadow_valid[:] = False
        self._shadow_packed[:] = 0
        self._shadow_desc[:] = 0
        self._alloc()
