"""Global truncation/saturation counters.

The engine uses fixed device capacities everywhere (static XLA shapes);
when live data exceeds a capacity the overflow is dropped by POLICY
(best-observed points kept) — but silently-dropped work is a debugging
trap on large maps, so every truncation increments a named counter here
and warns once per site. Inspect with `counters.snapshot()`; drivers print
non-zero counters at exit.

A copy of orb_slam2_detailed_comments_tpu/utils/counters.py.
"""
from __future__ import annotations

import collections
import warnings

_counts: "collections.Counter[str]" = collections.Counter()
_dropped: "collections.Counter[str]" = collections.Counter()
_warned: set = set()


def truncated(site: str, n_dropped: int) -> None:
    """Record a capacity truncation at `site` dropping n_dropped items."""
    if n_dropped <= 0:
        return
    _counts[site] += 1
    _dropped[site] += int(n_dropped)
    if site not in _warned:
        _warned.add(site)
        warnings.warn(
            f"capacity truncation at {site}: dropped {n_dropped} items "
            f"(best-observed kept; further occurrences counted silently — "
            f"see utils.counters.snapshot())", stacklevel=3)


def snapshot() -> dict:
    return {site: {"events": _counts[site], "dropped": _dropped[site]}
            for site in _counts}


def reset() -> None:
    _counts.clear()
    _dropped.clear()
    _warned.clear()


def keep_best_observed(mp_ids, n_obs_table, cap: int, site: str):
    """Order candidate map points by observation count (descending) and
    keep the first `cap` — the points most corroborated by the map are the
    ones worth a matching slot. Records the truncation."""
    import numpy as np
    if mp_ids.size <= cap:
        return mp_ids
    order = np.argsort(-n_obs_table[mp_ids], kind="stable")[:cap]
    truncated(site, mp_ids.size - cap)
    return mp_ids[np.sort(order)]
