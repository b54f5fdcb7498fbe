"""Per-stage wall-clock timing (the reference only times whole TrackX calls
in its example mains, mono_tum.cc:96-121; we build stage timing in from day
one per SURVEY.md section 5).

A copy of orb_slam2_detailed_comments_tpu/utils/timing.py.
"""
from __future__ import annotations

import collections
import contextlib
import time


class StageTimer:
    def __init__(self):
        self.totals = collections.defaultdict(float)
        self.counts = collections.defaultdict(int)
        self.samples = collections.defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.samples[name].append(dt)

    def summary(self) -> dict:
        out = {}
        for name in self.totals:
            s = sorted(self.samples[name])
            out[name] = {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1e3 * self.totals[name] / max(1, self.counts[name]),
                "median_ms": 1e3 * s[len(s) // 2] if s else 0.0,
            }
        return out

    def report(self) -> str:
        lines = []
        for name, st in sorted(self.summary().items()):
            lines.append(f"{name:32s} n={st['count']:6d} mean={st['mean_ms']:8.2f}ms median={st['median_ms']:8.2f}ms")
        return "\n".join(lines)
