"""ctypes binding for the native host-runtime kernels (native/map_ops.cpp).

Loads native/libmap_ops.so if present (auto-built via `make -C native`);
callers fall back to the pure-numpy implementations when unavailable.

A copy of orb_slam2_detailed_comments_tpu/state/native_ops.py; both packages load the
same native/libmap_ops.so.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = os.path.join(_NATIVE_DIR, "libmap_ops.so")
    if not os.path.exists(so):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], capture_output=True,
                           timeout=120, check=False)
        except Exception:
            pass
    if os.path.exists(so):
        try:
            lib = ctypes.CDLL(so)
            lib.update_point_descriptors.restype = None
            lib.update_normal_and_depth.restype = None
            lib.count_redundant.restype = ctypes.c_int64
            _LIB = lib
        except OSError:
            _LIB = None
    return _LIB


def _ptr(arr: np.ndarray, t):
    return arr.ctypes.data_as(ctypes.POINTER(t))


def available() -> bool:
    return _load() is not None


def update_point_descriptors(ms, mp_ids: np.ndarray) -> bool:
    lib = _load()
    if lib is None:
        return False
    mp_ids = np.ascontiguousarray(np.atleast_1d(mp_ids), np.int64)
    if mp_ids.size == 0:
        return True
    lib.update_point_descriptors(
        _ptr(mp_ids, ctypes.c_int64), ctypes.c_int64(mp_ids.size),
        _ptr(ms.mp_obs_kf, ctypes.c_int32), _ptr(ms.mp_obs_idx, ctypes.c_int32),
        _ptr(ms.mp_n_obs, ctypes.c_int32), ctypes.c_int64(ms.OBS_CAP),
        _ptr(ms.kf_desc, ctypes.c_uint32),
        ctypes.c_int64(ms.KP_CAP * 8), ctypes.c_int64(8),
        _ptr(ms.mp_desc, ctypes.c_uint32))
    return True


def update_normal_and_depth(ms, mp_ids: np.ndarray, kf_centers: np.ndarray) -> bool:
    lib = _load()
    if lib is None:
        return False
    mp_ids = np.ascontiguousarray(np.atleast_1d(mp_ids), np.int64)
    if mp_ids.size == 0:
        return True
    kf_centers = np.ascontiguousarray(kf_centers, np.float32)
    lib.update_normal_and_depth(
        _ptr(mp_ids, ctypes.c_int64), ctypes.c_int64(mp_ids.size),
        _ptr(ms.mp_obs_kf, ctypes.c_int32), _ptr(ms.mp_obs_idx, ctypes.c_int32),
        _ptr(ms.mp_n_obs, ctypes.c_int32), ctypes.c_int64(ms.OBS_CAP),
        _ptr(ms.mp_pos, ctypes.c_float), _ptr(kf_centers, ctypes.c_float),
        _ptr(ms.kf_octave, ctypes.c_int32), ctypes.c_int64(ms.KP_CAP),
        _ptr(ms.mp_ref_kf, ctypes.c_int32),
        ctypes.c_float(ms.config.orb.scale_factor),
        ctypes.c_int(ms.config.orb.n_levels),
        _ptr(ms.mp_normal, ctypes.c_float), _ptr(ms.mp_min_dist, ctypes.c_float),
        _ptr(ms.mp_max_dist, ctypes.c_float))
    return True


def count_redundant(ms, kf: int, close_th: float, use_depth: bool):
    """Returns (considered, redundant) or None if native lib missing."""
    lib = _load()
    if lib is None:
        return None
    mp_valid_u8 = ms.mp_valid.view(np.uint8)
    out = lib.count_redundant(
        ctypes.c_int64(kf),
        _ptr(ms.kf_mp, ctypes.c_int32), ctypes.c_int64(ms.KP_CAP),
        _ptr(mp_valid_u8, ctypes.c_uint8),
        _ptr(ms.mp_obs_kf, ctypes.c_int32), _ptr(ms.mp_obs_idx, ctypes.c_int32),
        _ptr(ms.mp_n_obs, ctypes.c_int32), ctypes.c_int64(ms.OBS_CAP),
        _ptr(ms.kf_octave, ctypes.c_int32), ctypes.c_int64(ms.KP_CAP),
        _ptr(ms.kf_depth, ctypes.c_float), ctypes.c_float(close_th),
        ctypes.c_int(1 if use_depth else 0))
    return (out >> 32, out & 0xFFFFFFFF)
