#!/usr/bin/env python3
"""Where a grouped global-BA solve spends the card's time, and the same
solve with its batched matrix-vector einsums written as broadcast sums.

    python3 tools/grouped_ba_variants.py

Input: chip_smoke.py [14](b)'s problem (examples/bench_gba.py's default
size: 1408 cameras, 60,000 points, 360,448 edges), grouped once. Each
variant is optim/global_ba.py with textual changes, loaded as a module of
its own; its solve_lm runs the grouped layout's sums
(optim/global_ba_grouped.layout_reducer) with solve_global_ba's schedule
(10 LM iterations, 50 CG). The variants run in turns (committed, variant,
variant, committed); each turn is one solve between two CUDA events after
a warm-up. It prints the card's name and power limit, ms per solve, the
final robust cost, the largest difference from the committed solve, and
the ten CUDA kernels that take most device time in one LM iteration
(torch.profiler). The port itself runs only the committed source.
"""
from __future__ import annotations

import statistics
import sys
import types
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
SRC = REPO / "orb_slam2_detailed_comments_tpu_torch" / "optim" / "global_ba.py"

# name: [(old, new), ...] textual changes of optim/global_ba.py
MV = ("def _mv(M, x):\n    return (M * x[..., None, :]).sum(-1)\n\n\n"
      "def _mtv(M, x):\n    return (M * x[..., :, None]).sum(-2)\n\n\n"
      "def _outer(A, B, w):\n    return (A[:, :, :, None] * (w[:, None, None, None]"
      " * B[:, :, None, :])).sum(1)\n\n\n")
VARIANTS = {
    "committed": [],
    "broadcast sums": [
        ("def _robust_cost(", MV + "def _robust_cost("),
        ('torch.einsum("eri,erj,e->eij", Jc, Jc, w)', "_outer(Jc, Jc, w)"),
        ('torch.einsum("eri,erj,e->eij", Jp, Jp, w)', "_outer(Jp, Jp, w)"),
        ('torch.einsum("eri,erj,e->eij", Jc, Jp, w)', "_outer(Jc, Jp, w)"),
        ('torch.einsum("eri,er,e->ei", Jc, rw, w)', "_mtv(Jc, w[:, None] * rw)"),
        ('torch.einsum("eri,er,e->ei", Jp, rw, w)', "_mtv(Jp, w[:, None] * rw)"),
        ('torch.einsum("eij,ei->ej", Y, x[edge_cam])', "_mtv(Y, x[edge_cam])"),
        ('torch.einsum("eij,ej->ei", Y, wv[edge_point])', "_mv(Y, wv[edge_point])"),
        ('torch.einsum("eij,ej->ei", Y, hg[e_pt])', "_mv(Y, hg[e_pt])"),
        ('torch.einsum("eij,ei->ej", Y, dc[e_cam])', "_mtv(Y, dc[e_cam])"),
        ('torch.einsum("cij,cj->ci", Hcc_d, x)', "_mv(Hcc_d, x)"),
        ('torch.einsum("pij,pj->pi", Hpp_inv, v)', "_mv(Hpp_inv, v)"),
        ('torch.einsum("pij,pj->pi", Hpp_inv, g_p)', "_mv(Hpp_inv, g_p)"),
        ('torch.einsum("pij,pj->pi", Hpp_inv, g_p + atdc)', "_mv(Hpp_inv, g_p + atdc)"),
        ('torch.einsum("cij,cj->ci", Minv, r)', "_mv(Minv, r)")],
}


def load(name, changes):
    text = SRC.read_text()
    for old, new in changes:
        if old not in text:
            raise RuntimeError(f"{name}: the source no longer holds {old[:60]!r}")
        text = text.replace(old, new)
    mod = types.ModuleType(f"orb_slam2_detailed_comments_tpu_torch.optim._{len(name)}")
    mod.__package__ = "orb_slam2_detailed_comments_tpu_torch.optim"
    exec(compile(text, str(SRC), "exec"), mod.__dict__)
    return mod


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from orb_slam2_detailed_comments_tpu_torch.geometry.camera import PinholeCamera
    from orb_slam2_detailed_comments_tpu_torch.optim import global_ba_grouped as GBG
    from orb_slam2_detailed_comments_tpu_torch.optim.local_ba import BAProblem

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(cs._smi(), flush=True)
    d = cs.gba_bench_problem(**cs.GBA_BENCH)
    prob = BAProblem(**{k: torch.from_numpy(v).to(dev) for k, v in d.items()})
    gp = GBG.group_global_problem(prob)
    red = GBG.layout_reducer(gp)
    cam = PinholeCamera(**cs.GBA_CAM)
    inv_s2 = torch.from_numpy(cs.GBA_INV_S2).to(dev)
    mods = {name: load(name, ch) for name, ch in VARIANTS.items()}

    def solve(name, n_iters=10):
        return mods[name].solve_lm(gp.prob, cam, inv_s2, n_iters, 50, 1e-5, red)

    out, times = {}, {name: [] for name in mods}
    names = list(mods)
    for name in names:
        out[name] = solve(name)
    for name in names + names[::-1]:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        solve(name)
        b.record()
        torch.cuda.synchronize()
        times[name].append(a.elapsed_time(b))
    ref = out["committed"]
    for name in names:
        cams, pts, _ = out[name]
        cost = float(mods["committed"]._robust_cost(cams, pts, prob, prob.edge_valid,
                                                    (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf),
                                                    inv_s2, True))
        print(f"{name}: {statistics.median(times[name]):.3f} ms per solve "
              f"({', '.join(f'{t:.3f}' for t in times[name])}); robust cost {cost:.6g}; "
              f"from the committed solve: cameras {float((cams - ref[0]).abs().max()):.3e}, "
              f"points {float((pts - ref[1]).abs().max()):.3e}", flush=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            solve(name, n_iters=1)
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.key_averages() if e.device_time_total > 0),
                     key=lambda e: -e.device_time_total)
        total = sum(e.device_time_total for e in evs)
        print(f"    one LM iteration: {total / 1e3:.3f} ms of device time, "
              f"{sum(e.count for e in evs)} CUDA kernels; the largest:")
        for e in evs[:10]:
            print(f"    {100 * e.device_time_total / total:6.2f}% {e.count:6d} x "
                  f"{e.device_time_total / max(e.count, 1):9.3f} us  {e.key[:70]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
