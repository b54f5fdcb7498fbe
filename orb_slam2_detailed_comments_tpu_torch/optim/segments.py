"""Sums of rows by a key known on the host, in a fixed order.

The JAX package adds rows into their keys with `.at[key].add`, a
scatter-add. On the card a scatter-add sums through atomics, in an order
that changes from run to run. Here the keys are laid out once on the host
as a (D, n_keys) grid of row indices (`ragged_grid`), and a sum is one
gather and a sum over D: the same bits every run, and no host sync.
"""
from __future__ import annotations

import numpy as np
import torch


def grid_dims(deg: np.ndarray, cap: int):
    """(D, Ds, U) of ragged_grid's layout for keys of these degrees: the
    grid's depth, and the depth and width of its spill."""
    D = int(min(max(int(deg.max()) if deg.size else 1, 1), cap))
    over = deg[deg > D] - D
    return D, int(over.max()) if over.size else 0, int(over.size)


def ragged_grid(order: np.ndarray, keys: np.ndarray, n_keys: int, cap: int,
                depth: int = 0, min_spill=(0, 0)):
    """Lay `order` (items sorted stably by `keys`, one key per item) out
    key-major: (D, n_keys) items, D = min(largest key degree, cap), and the
    items past D of each key in a (Ds, U) spill over the U keys that have
    them. Returns (sel, valid, spill_keys, spill_sel, spill_valid); invalid
    entries hold item 0.

    `depth` sets D and `min_spill` the least (Ds, U), so that layouts of
    different items can share one shape: a padding spill column is all
    invalid and takes a key of no other column, so the spill's keys stay
    distinct."""
    ar = np.arange(n_keys)
    start = np.searchsorted(keys, ar, side="left")
    deg = np.searchsorted(keys, ar, side="right") - start
    D = depth or grid_dims(deg, cap)[0]
    src = order if order.size else np.zeros(1, np.int64)
    d = np.arange(D)[:, None]
    valid = d < np.minimum(deg, D)[None, :]
    sel = np.where(valid, src[np.minimum(start[None, :] + d, src.size - 1)], 0)
    u = np.nonzero(deg > D)[0]
    if u.size < min_spill[1]:
        u = np.concatenate([u, np.setdiff1d(ar, u)[:min_spill[1] - u.size]])
    Ds = max(int((deg[u] - D).max()) if u.size else 0, min_spill[0])
    ds = np.arange(Ds)[:, None]
    s_valid = ds < (deg[u] - D)[None, :]
    s_sel = np.where(s_valid, src[np.minimum(start[u][None, :] + D + ds, src.size - 1)], 0)
    return sel, valid, u, s_sel, s_valid


class SegmentSum:
    """out[k] = sum of rows[i] over the i with keys[i] == k, for rows of
    any trailing shape; keys (host numpy) fixed at construction."""

    def __init__(self, keys: np.ndarray, n_keys: int, device):
        keys = np.asarray(keys, np.int64)
        self.n_keys = n_keys
        order = np.argsort(keys, kind="stable")
        sel, valid, _, _, _ = ragged_grid(order, keys[order], n_keys, 1 << 62)
        self.sel = torch.as_tensor(sel, dtype=torch.int64).to(device)
        self.valid = torch.as_tensor(valid).to(device)

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        if rows.shape[0] == 0:
            return rows.new_zeros((self.n_keys,) + rows.shape[1:])
        mask = self.valid.reshape(self.valid.shape + (1,) * (rows.dim() - 1))
        return torch.where(mask, rows[self.sel], 0.0).sum(0)
