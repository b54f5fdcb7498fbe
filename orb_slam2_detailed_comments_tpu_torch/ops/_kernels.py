"""Builds the CUDA kernels in csrc/ with nvcc and loads them with ctypes.

The sources are compiled at first use into one shared library with a plain
C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/libslam_kernels_<hash>.so csrc/*.cu

`build/` sits at the root of the checkout and is ignored by git. The name
carries a hash of the sources and flags, so an edited source is rebuilt.
Every C entry point launches on the stream it is given and returns
cudaGetLastError(); `check` raises when that is not 0. One lock serializes
the first build and load, so two threads that reach a kernel first
neither compile twice nor race on the temporary file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # n_entries, src[], H[], W[], gauss[7], threshold, nms, raw, blur, stream
    "fast_pyramid_launch": (_I, _P, _P, _P, _P, _F, _P, _P, _P, _P),
    # img, H, W, threshold, nms, stream
    "fast_nms_launch": (_P, _I, _I, _F, _P, _P),
    # src, xy, out, n_stacks, C, H, W, B, ph, pw, stream
    "patch_gather_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # n_levels, img[], blur[], H[], W[], counts[], xy, valid, px, py, B, N, r,
    # angle, desc, stream
    "orb_desc_launch": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P),
    # img_l, img_r, H, W, xl, yl, xr, M, idx, N, u_r, best_sad, stream
    "stereo_sad_launch": (_P, _P, _I, _I, _P, _P, _P, _I, _P, _I, _P, _P, _P),
}
_BUILD_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libslam_kernels_{h.hexdigest()[:16]}.so"


def build() -> str:
    """Compile csrc/*.cu unless the library for these sources exists.
    Returns the compiler's diagnostics (ptxas register and shared-memory
    use per kernel), empty when nothing was built."""
    out = library_path()
    with _BUILD_LOCK:
        if out.exists():
            return ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)
        return res.stderr


_library = None


def library() -> ctypes.CDLL:
    global _library
    if _library is None:
        build()
        with _BUILD_LOCK:
            if _library is None:
                lib = ctypes.CDLL(str(library_path()))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                _library = lib
    return _library


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
