#!/usr/bin/env python3
"""CUDA kernels and the device's busy share in one fused stereo and one
fused mono frame of the port, for one or more checkouts of the repo.

    python3 tools/profile_frames.py [ROOT ...]

Each ROOT (default: this checkout) is the root of a checkout; its package
orb_slam2_detailed_comments_tpu_torch is imported in a process of its own,
builds its kernels into ROOT/build/kernels/ and runs the fused frames on
bench.py's inputs as chip_smoke.py [6] does, profiled by this checkout's
chip_smoke._profile_frame (one warmed-up frame each). To compare two
commits within one call, unpack the parent into a git-ignored directory
(`git archive`) and give the roots as parent, change, change, parent.
Needs a CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profile_root(root: Path) -> None:
    """Profile the fused frames of the package under `root` (this process)."""
    sys.path.insert(0, str(root))
    import torch
    from orb_slam2_detailed_comments_tpu_torch.models import slam_step as S
    if not Path(S.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {S.__file__}, not the package under {root}")
    cs = _chip_smoke()
    dev = torch.device("cuda", 0)
    (img_l, img_r, Tcw_s, *s_map), orb_s, cam_s = S.make_stereo_inputs(device=dev)
    (img_m, Tcw_m, *m_map), orb_m, cam_m = S.make_consistent_inputs(device=dev)
    s_pad, m_pad = cs.pad_map(*s_map), cs.pad_map(*m_map)
    pair = torch.stack([img_l, img_r])
    frames = {"fused_stereo_frame": lambda: S.fused_stereo_frame(
                  pair, Tcw_s, *s_pad, orb=orb_s, cam=cam_s, th_depth=40.0 * cam_s.baseline),
              "fused_mono_frame": lambda: S.fused_mono_frame(
                  img_m, Tcw_m, *m_pad, orb=orb_m, cam=cam_m)}
    for name, fn in frames.items():
        n_kernels, busy = cs._profile_frame(fn)
        print(f"{root}: {name}: " + ("no device activity traced (not measured)"
                                     if n_kernels is None else
                                     f"{n_kernels} CUDA kernels, device busy {100 * busy:.2f}%"),
              flush=True)


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        profile_root(Path(argv[1]))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("profile_frames: needs a CUDA card", file=sys.stderr)
        return 2
    print(_chip_smoke()._smi(), flush=True)
    rc = 0
    for root in argv or [str(REPO)]:
        root = str(Path(root).resolve())
        rc |= subprocess.run([sys.executable, __file__, "--one", root], cwd=root).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
