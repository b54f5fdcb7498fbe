#!/usr/bin/env python3
"""What bounds K5's kernel (csrc/fast_pyramid.cu::fast_nms_kernel) on the
card, and its time beside another version of the same source.

    python3 tools/fast_nms_variants.py [OTHER_FAST_PYRAMID_CU]

Inputs: the three K5 inputs of chip_smoke.py [3], at threshold 7: the
bench image (bench.py's 1241x376 left image), the 640x480 one, and frame 0
of the stereo tracker phase (a rendered textured frame at KITTI geometry).
Libraries: the committed source; variants of it, each one textual change
(the ablations, whose names start with "no", are not held to the plain
version: one of them changes the output);
and, when given, another fast_pyramid.cu as it is (for example a parent
commit's, unpacked with `git archive` into the git-ignored build/). Each is
compiled by nvcc with the port's flags into build/variants/ and launched
through fast_nms_launch REPS times back to back between two CUDA events;
the ms per launch is the median of ROUNDS such runs, the libraries taking
turns within each round. Every library but the ablations is held bit for
bit against fast_score_nms_plain. It prints the card's name and
power limit, ptxas's registers and spills for fast_nms_kernel, the early
test's rejected share per input, and the SM clock after the timing.
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
THRESHOLD = 7.0

# name: [(old, new), ...] textual changes of the committed source
VARIANTS = {
    "committed": [],
    "no early test (every pixel scored, through the list)": [
        ("const bool pass = in && may_pass(img_s, cy + HALO - 1, cx + HALO - 1, threshold);",
         "const bool pass = in;")],
    "no arc score (a survivor's score is its centre value)": [
        ("const float r = ring_score(img_s, cy + HALO - 1, cx + HALO - 1);",
         "const float r = img_s[cy + HALO - 1][cx + HALO - 1];")],
    "two blocks an SM (__launch_bounds__(NT): 49 registers)": [
        ("__launch_bounds__(NT, 3)\nfast_nms_kernel", "__launch_bounds__(NT)\nfast_nms_kernel")],
}


def build(name, text):
    from orb_slam2_detailed_comments_tpu_torch.ops import _kernels
    OUT.mkdir(parents=True, exist_ok=True)
    stem = re.sub(r"\W+", "_", name).strip("_")[:60]
    cu, so = OUT / f"{stem}.cu", OUT / f"{stem}.so"
    cu.write_text(text)
    res = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stderr}")
    regs, fn = [], ""
    for line in res.stderr.splitlines():     # ptxas: fast_nms_kernel's registers, spills
        if "Compiling entry function" in line or "Function properties for" in line:
            fn = line
        elif "fast_nms_kernel" in fn and ("Used" in line or "spill" in line):
            regs.append(line.split(" : ", 1)[-1].strip())
    lib = ctypes.CDLL(str(so))
    lib.fast_nms_launch.argtypes = list(_kernels._SIGNATURES["fast_nms_launch"])
    lib.fast_nms_launch.restype = ctypes.c_int
    return lib, regs


def libraries(other):
    text = SRC.read_text()
    out = {}
    for name, changes in VARIANTS.items():
        t = text
        for old, new in changes:
            if old not in t:
                raise RuntimeError(f"{name}: the source no longer holds {old[:60]!r}")
            t = t.replace(old, new)
        out[name] = (*build(name, t), not name.startswith("no "))
    if other:
        out[f"other: {other}"] = (*build("other", Path(other).read_text()), True)
    return out


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("fast_nms_variants: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from orb_slam2_detailed_comments_tpu_torch.models import slam_step as S
    from orb_slam2_detailed_comments_tpu_torch.ops.fast_pyramid import (
        fast_nms_survivors, fast_score_nms_plain)

    print(cs._smi(), flush=True)
    dev = torch.device("cuda", 0)
    (img_l, *_), _, _ = S.make_stereo_inputs(device=dev)
    (img_m, *_), _, _ = S.make_consistent_inputs(device=dev)
    frame = torch.from_numpy(cs.render_sequence("stereo")[1][0][0]).to(dev)
    inputs = {"bench 1241x376": img_l.contiguous(), "640x480": img_m.contiguous(),
              "tracker frame 0 1241x376": frame.contiguous()}
    for tag, img in inputs.items():
        keep = fast_nms_survivors(img, THRESHOLD)
        print(f"{tag}: the early test rejects {100 * (1 - keep.float().mean().item()):.2f}% of "
              f"the image + 1 px", flush=True)
    libs = libraries(argv[0] if argv else None)
    for name, (_, regs, _) in libs.items():
        print(f"{name}: " + "; ".join(regs), flush=True)

    stream = torch.cuda.current_stream(dev).cuda_stream
    times = {(n, t): [] for n in libs for t in inputs}
    for tag, img in inputs.items():
        H, W = img.shape
        ref = fast_score_nms_plain(img, THRESHOLD)
        for name, (lib, _, checked) in libs.items():
            out = torch.empty_like(img)
            if lib.fast_nms_launch(img.data_ptr(), H, W, THRESHOLD, out.data_ptr(), stream):
                raise RuntimeError(f"{name}: launch refused")
            torch.cuda.synchronize()
            if checked and not torch.equal(out, ref):
                raise AssertionError(f"{name} on {tag}: differs from fast_score_nms_plain")
    for _ in range(ROUNDS):
        for tag, img in inputs.items():
            H, W = img.shape
            out = torch.empty_like(img)
            for name, (lib, _, _) in libs.items():
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(REPS):
                    lib.fast_nms_launch(img.data_ptr(), H, W, THRESHOLD, out.data_ptr(), stream)
                b.record()
                torch.cuda.synchronize()
                times[name, tag].append(a.elapsed_time(b) / REPS)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    print(f"ms per launch, median of {ROUNDS} x {REPS}; SM clock after: {clock}")
    for name in libs:
        print(f"{name}: " + ", ".join(f"{tag} {statistics.median(times[name, tag]):.4f}"
                                      for tag in inputs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
