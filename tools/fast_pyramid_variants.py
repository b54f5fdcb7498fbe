#!/usr/bin/env python3
"""What bounds the FAST pyramid kernel on the card: its device time beside
that of the same source without its arc score and without its stores.

    python3 tools/fast_pyramid_variants.py

Input: the KITTI stereo pyramid of chip_smoke.py (bench.py's 1241x376 pair,
2 images x 8 levels). Each ablation is csrc/fast_pyramid.cu with one
textual change, compiled by nvcc (the port's flags) into build/variants/;
each library is launched with the arguments the wrapper makes
(ops/fast_pyramid.py::launch_args), REPS times back to back between two
CUDA events, and the ms per launch is the median of ROUNDS such runs. The
committed source is checked bit for bit against fast_pyramid_plain. It
prints the card's name and power limit, ptxas's registers and spills, the
SM clock after the timing, and one line per library. The port itself
builds only the committed source.
"""
from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
SRC = REPO / "orb_slam2_detailed_comments_tpu_torch" / "csrc" / "fast_pyramid.cu"
OUT = REPO / "build" / "variants"
REPS, ROUNDS = 200, 5

# name: [(old, new), ...] textual changes of the source
VARIANTS = {
    "committed": [],
    "no arc score (loads, blur, NMS, stores)": [
        ("const float r = arc_score(p, win[c % 8][3]);", "const float r = p[0] + p[8];")],
    "no stores (the maps computed, not written)": [
        ("raw[off + yc * W + xc] = r;", "if (r == -1.f) raw[0] = r;"),
        ("nms[off + yo * W + xc] = (mid > 0.f && mid > earlier && mid >= later) ? mid : 0.f;",
         "if (mid > earlier && mid == -1.f) nms[0] = mid;"),
        ("blur[off + yo * W + xc] = v;", "if (v == -1.f) blur[0] = v;")],
}


def build(name, changes):
    from orb_slam2_detailed_comments_tpu_torch.ops import _kernels
    text = SRC.read_text()
    for old, new in changes:
        if old not in text:
            raise RuntimeError(f"{name}: the source no longer holds {old[:60]!r}")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    stem = re.sub(r"\W+", "_", name).strip("_")
    cu, so = OUT / f"{stem}.cu", OUT / f"{stem}.so"
    cu.write_text(text)
    res = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stderr}")
    regs, fn = [], ""
    for line in res.stderr.splitlines():     # ptxas: the pyramid kernel's registers, spills
        if "Function properties for" in line:
            fn = line
        elif "fast_pyramid_kernel" in fn and ("Used" in line or "spill" in line):
            regs.append(line.split(" : ", 1)[-1].strip())
    lib = ctypes.CDLL(str(so))
    lib.fast_pyramid_launch.argtypes = list(_kernels._SIGNATURES["fast_pyramid_launch"])
    lib.fast_pyramid_launch.restype = ctypes.c_int
    return lib, regs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fast_pyramid_variants: needs a CUDA card", file=sys.stderr)
        return 2
    from orb_slam2_detailed_comments_tpu_torch.models import slam_step as S
    from orb_slam2_detailed_comments_tpu_torch.ops import fast_pyramid as fp
    from orb_slam2_detailed_comments_tpu_torch.ops.pyramid import build_pyramid

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    (img_l, img_r, *_), orb, _ = S.make_stereo_inputs(device="cuda")
    levels = [lv.contiguous() for lv in
              build_pyramid(torch.stack([img_l, img_r]), orb.n_levels, orb.scale_factor)]
    th = float(orb.min_th_fast)
    ref = [torch.cat([m.reshape(-1) for m in maps]) for maps in fp.fast_pyramid_plain(levels, th)]
    for name, changes in VARIANTS.items():
        lib, regs = build(name, changes)
        out, args = fp.launch_args(levels, th)

        def launch():
            rc = lib.fast_pyramid_launch(*args)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")

        launch()
        torch.cuda.synchronize()
        exact = all(torch.equal(o, r) for o, r in zip(out, ref)) if not changes else None
        if exact is False:
            raise AssertionError(f"{name}: differs from fast_pyramid_plain")
        times = []
        for _ in range(ROUNDS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(REPS):
                launch()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / REPS)
        clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                               capture_output=True, text=True).stdout.strip()
        print(f"{name}: {statistics.median(times):.4f} ms per launch (median of {ROUNDS} x "
              f"{REPS}), bit-exact {exact}, SM clock after {clock}; " + "; ".join(regs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
