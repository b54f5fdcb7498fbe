"""IC angle + rotated BRIEF of every keypoint of a pyramid, in one call.

`orb_desc(levels, blurs, xy, valid, counts)` takes the pyramid's (B, H_l,
W_l) float32 level images and blurred maps (fast_pyramid's blur), the
keypoints of all levels concatenated along the slot axis as (B, N, 2) int32
level coordinates (x, y) with a (B, N) bool valid mask, and the slots per
level (`counts`, summing to N: level l holds the next counts[l] slots). It
returns the angle (B, N) float32 and the descriptor (B, N, 8) int32.

It is the counterpart of the JAX package's ops/orb.py::
_fused_level_angles_descriptors (ORB_DESC_ONEHOT=0, the exact gather) and,
inside it, of the TPU kernel ops/pallas_patch.py::patch_gather at its ORB
call site. Each keypoint's window is the (2, 39, 39) [level, blur] window
of the edge-padded level at the keypoint (lax.dynamic_slice starts); the
angle is the intensity-centroid statistic of the level window (reference:
ORBextractor.cc:104-161) and bit j of word w compares the blurred samples
of pattern pair 32 w + j, rotated by the angle (reference :177-254).

The moments are summed in a fixed order, which the CUDA kernel repeats:
31 row steps of `acc + column * weight` over the 31 columns of the
radius-15 window, then a halving tree over the columns padded to 32. For
CUDA tensors `orb_desc` launches csrc/orb_desc.cu once for all images x
levels; it reads the maps in place and writes no patch. For CPU tensors it
runs `orb_desc_plain`, with which the kernel agrees bit for bit on the
card. `orb_desc.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _kernels
from .hamming import pack_bits
from .patch_gather import patch_gather_plain
from .pattern import HALF_PATCH, brief_pattern, ic_angle_offsets
from .pyramid import edge_pad

DESC_RADIUS = 19    # window radius that holds the rotated pattern (13 * sqrt(2) < 19)


@functools.lru_cache(maxsize=None)
def desc_constants(device: torch.device):
    """The IC weights u * mask and v * mask of the (31, 31) window (rows v,
    columns u), and the 512 pattern offsets px = [x0, x1], py = [y0, y1],
    float32 on `device`."""
    mask, xs, ys = ic_angle_offsets()
    p = brief_pattern(1234).astype(np.float32)
    px = np.concatenate([p[:, 0], p[:, 2]])
    py = np.concatenate([p[:, 1], p[:, 3]])
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
                 for a in (xs * mask, ys * mask, px, py))


def _column_tree(x):
    """(..., 31) column partials -> (...,): padded to 32, then 5 halving
    steps x[:h] + x[h:2h], h = 16, 8, 4, 2, 1 (the kernel's shuffle tree)."""
    x = torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)
    for h in (16, 8, 4, 2, 1):
        x = x[..., :h] + x[..., h:2 * h]
    return x[..., 0]


def ic_moments(win):
    """(m10, m01) of (..., 31, 31) windows (rows v = -15..15, columns u) in
    the fixed order: per column, acc = acc + row * weight down the rows,
    then the column tree."""
    wx, wy = desc_constants(win.device)[:2]
    m10 = win.new_zeros(win.shape[:-1])
    m01 = win.new_zeros(win.shape[:-1])
    for i in range(2 * HALF_PATCH + 1):
        m10 = m10 + win[..., i, :] * wx[i]
        m01 = m01 + win[..., i, :] * wy[i]
    return _column_tree(m10), _column_tree(m01)


def angle_descriptor(rawp, blurp):
    """Angle and packed descriptor of (..., 39, 39) level and blur windows."""
    px, py = desc_constants(rawp.device)[2:]
    r, c = DESC_RADIUS, DESC_RADIUS - HALF_PATCH
    m10, m01 = ic_moments(rawp[..., c:-c, c:-c])
    ang = torch.atan2(m01, m10)
    ca, sa = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    dx = torch.round(px * ca - py * sa).to(torch.int64)  # (..., 512)
    dy = torch.round(px * sa + py * ca).to(torch.int64)
    flat = blurp.flatten(-2)
    v = flat.gather(-1, (dy + r) * (2 * r + 1) + (dx + r))
    return ang, pack_bits(v[..., :256] < v[..., 256:])


def orb_desc_plain(levels, blurs, xy, valid, counts):
    """Plain PyTorch version: per level, the (2, 39, 39) windows of the
    edge-padded [level, blur] stack (patch_gather_plain), then
    angle_descriptor; invalid slots 0."""
    r = DESC_RADIUS
    angs, descs, s = [], [], 0
    for img, blur, n in zip(levels, blurs, counts):
        padded = edge_pad(torch.stack([img, blur], dim=1), r, r)
        p = patch_gather_plain(padded, xy[:, s:s + n], 2 * r + 1, 2 * r + 1)
        ang, desc = angle_descriptor(p[:, :, 0], p[:, :, 1])
        angs.append(ang)
        descs.append(desc)
        s += n
    ang, desc = torch.cat(angs, dim=1), torch.cat(descs, dim=1)
    return torch.where(valid, ang, 0.0), torch.where(valid[..., None], desc, 0)


@functools.lru_cache(maxsize=None)
def _level_table(shapes, counts):
    """H, W and the slot count of each level as C arrays."""
    n = len(shapes)
    return ((ctypes.c_int * n)(*(h for h, _ in shapes)), (ctypes.c_int * n)(*(w for _, w in shapes)),
            (ctypes.c_int * n)(*counts))


def _check_inputs(levels, blurs, xy, valid, counts):
    if not levels or len(levels) != len(blurs) or len(levels) != len(counts):
        raise ValueError("orb_desc takes one blur map and one slot count per level")
    B, dev = levels[0].shape[0], levels[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"orb_desc runs on cpu or cuda, not {dev}")
    for lv, bl in zip(levels, blurs):
        if lv.dtype != torch.float32 or bl.dtype != torch.float32:
            raise TypeError(f"orb_desc takes float32 maps, got {lv.dtype} and {bl.dtype}")
        if lv.dim() != 3 or lv.shape[0] != B or bl.shape != lv.shape:
            raise ValueError("orb_desc takes (B, H, W) levels and blur maps of the same shape")
        if lv.device != dev or bl.device != dev:
            raise ValueError("orb_desc takes its maps on one device")
        if not (lv.is_contiguous() and bl.is_contiguous()):
            raise ValueError("orb_desc takes contiguous maps")
    if xy.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError(f"orb_desc takes int32 xy and bool valid, got {xy.dtype} and {valid.dtype}")
    N = sum(counts)
    if tuple(xy.shape) != (B, N, 2) or tuple(valid.shape) != (B, N) or min(counts) < 0:
        raise ValueError(f"orb_desc shapes: xy {tuple(xy.shape)}, valid {tuple(valid.shape)}, "
                         f"{B} images, counts {tuple(counts)}")
    if xy.device != dev or valid.device != dev:
        raise ValueError("xy and valid lie on another device than the maps")
    if not (xy.is_contiguous() and valid.is_contiguous()):
        raise ValueError("orb_desc takes contiguous xy and valid")


def orb_desc(levels, blurs, xy, valid, counts):
    """(angle (B, N) float32, desc (B, N, 8) int32) of the concatenated
    keypoints of all levels; see the module doc."""
    levels, blurs, counts = list(levels), list(blurs), tuple(int(n) for n in counts)
    _check_inputs(levels, blurs, xy, valid, counts)
    if xy.device.type == "cpu":
        return orb_desc_plain(levels, blurs, xy, valid, counts)
    B, N = valid.shape
    dev = xy.device
    n = len(levels)
    Hs, Ws, ns = _level_table(tuple((lv.shape[1], lv.shape[2]) for lv in levels), counts)
    img = (ctypes.c_void_p * n)(*(lv.data_ptr() for lv in levels))
    blur = (ctypes.c_void_p * n)(*(bl.data_ptr() for bl in blurs))
    px, py = desc_constants(dev)[2:]
    angle = torch.empty((B, N), dtype=torch.float32, device=dev)
    desc = torch.empty((B, N, 8), dtype=torch.int32, device=dev)
    rc = _kernels.library().orb_desc_launch(
        n, img, blur, Hs, Ws, ns, xy.data_ptr(), valid.data_ptr(), px.data_ptr(), py.data_ptr(),
        B, N, DESC_RADIUS, angle.data_ptr(), desc.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(rc, "orb_desc")
    orb_desc.launches += 1
    return angle, desc


orb_desc.launches = 0
