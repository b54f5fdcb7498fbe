"""FAST score + NMS (+ raw score + blur) maps: the counterparts of the
Pallas kernels of ops/pallas_fast.py.

`fast_pyramid(levels, threshold)` takes the pyramid as a list of
(B, H_l, W_l) float32 tensors (B images, one tensor per level) and returns
per-level (nms, raw, blur) lists of the same shapes:

  nms   the FAST-9/16 score where > threshold, 0 in the 3-px border, after
        3x3 NMS with the scan-order tie-break (ops/fast.py::nms_3x3);
  raw   the unthresholded arc score (sub-pixel refinement input), its ring
        read from a BORDER_REFLECT_101 pad at the image edge;
  blur  the 7x7 sigma=2 Gaussian blur, BORDER_REFLECT_101 (descriptor image),
        taps summed k0..k6.

It is the counterpart of both whole-pyramid kernels, fast_pyramid_pallas_roll
(K1) and fast_pyramid_pallas (K3): they compute the same three maps and
differ only in the order in which they sum the blur taps (K1 the centre tap
first, then symmetric pairs; K3 k0..k6). The port keeps K3's order, which is
also XLA's. `fast_score_nms_raw(img, threshold)` is the same function for
one (H, W) image (K4, fast_score_nms_raw_pallas).

`fast_score_nms(img, threshold)` is K5, fast_score_nms_pallas, which has
semantics of its own: the ring is read from an EDGE pad, the thresholded
score is not zeroed in the 3-px border before the NMS (so a border score
can suppress a pixel of the ring y in {3, H-4}, x in {3, W-4}), the border
is zeroed after it, and there is no raw or blur output. Its kernel
decides before the score which pixels can pass the threshold
(`fast_nms_survivors`, an exact test on four ring samples) and computes the
score only for those.

For CUDA tensors each launches a kernel of csrc/fast_pyramid.cu (the
pyramid kernel once for all images x levels, or the NMS-only kernel); for
CPU tensors each runs its plain PyTorch version, with which it agrees bit
for bit. `fast_pyramid.launches`, `fast_score_nms_raw.launches` and
`fast_score_nms.launches` count kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _kernels
from .fast import RING_OFFSETS, fast_score_dense, fast_score_map, nms_3x3
from .pyramid import _gauss_kernel_1d, edge_pad, gaussian_blur, reflect101_index

RING_R = 3                # FAST ring radius


def _reflect_pad(img, r: int):
    H, W = img.shape[-2:]
    x = img.index_select(-2, reflect101_index(H, r, img.device))
    return x.index_select(-1, reflect101_index(W, r, img.device))


def raw_score_plain(img):
    """Unthresholded arc score of a (..., H, W) image with the ring read
    from a reflect-101 pad, as the kernels read it from their halo."""
    r = RING_R
    return fast_score_dense(_reflect_pad(img, r))[..., r:-r, r:-r]


def fast_pyramid_plain(levels, threshold: float):
    """Plain PyTorch version: ops/fast.py + gaussian_blur per level."""
    nms = [nms_3x3(fast_score_map(lv, threshold)) for lv in levels]
    raw = [raw_score_plain(lv) for lv in levels]
    blur = [gaussian_blur(lv) for lv in levels]
    return nms, raw, blur


def fast_score_nms_raw_plain(img, threshold: float):
    """Plain version of fast_score_nms_raw: one (H, W) image."""
    return tuple(m[0][0] for m in fast_pyramid_plain([img[None]], threshold))


def fast_score_nms_plain(img, threshold: float):
    """Plain version of fast_score_nms (K5 semantics, see the module doc):
    the score over the image plus 1 px from a 4-px edge pad, thresholded but
    not border-masked, NMS'd, then the 3-px border zeroed."""
    H, W = img.shape
    halo = RING_R + 1
    score = fast_score_dense(edge_pad(img, halo, halo))[RING_R:H + halo + 1, RING_R:W + halo + 1]
    score = torch.where(score > threshold, score, 0.0)
    nms = nms_3x3(score)[1:-1, 1:-1]
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    inb = (ys >= RING_R) & (ys < H - RING_R) & (xs >= RING_R) & (xs < W - RING_R)
    return torch.where(inb, nms, 0.0)


CARDINALS = (0, 4, 8, 12)   # ring indices of K5's early test


def fast_nms_survivors(img, threshold: float):
    """K5's early test, the pixels whose score its kernel computes: of the
    image plus a 1-px ring, (H + 2, W + 2), with the ring read from the 4-px
    edge pad as fast_score_nms_plain reads it, those where two adjacent
    cardinal ring samples (indices 0/4, 4/8, 8/12, 12/0) both have
    fl(p - c) > threshold, or both fl(p - c) < -threshold. Every arc of 9
    contiguous ring samples holds such a pair, so every other pixel has a
    score <= threshold: its thresholded score is exactly 0."""
    H, W = img.shape
    halo = RING_R + 1
    pad = edge_pad(img, halo, halo)
    c = pad[RING_R:H + halo + 1, RING_R:W + halo + 1]
    d = [pad[RING_R + dy:H + halo + 1 + dy, RING_R + dx:W + halo + 1 + dx] - c
         for dy, dx in RING_OFFSETS[list(CARDINALS)]]
    out = torch.zeros_like(c, dtype=torch.bool)
    for k in range(4):
        a, b = d[k], d[(k + 1) % 4]
        out |= ((a > threshold) & (b > threshold)) | ((a < -threshold) & (b < -threshold))
    return out


_GAUSS = (ctypes.c_float * 7)(*map(float, _gauss_kernel_1d(7, 2.0)))


@functools.lru_cache(maxsize=None)
def _entry_shapes(shapes, B: int):
    """H and W of each (image, level) entry as C arrays: entry b + B * l is
    image b of level l."""
    hw = [s for s in shapes for _ in range(B)]
    n = len(hw)
    return (ctypes.c_int * n)(*(h for h, _ in hw)), (ctypes.c_int * n)(*(w for _, w in hw))


def _check_levels(levels):
    if not levels:
        raise ValueError("fast_pyramid needs at least one level")
    B, dev = levels[0].shape[0], levels[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fast_pyramid runs on cpu or cuda, not {dev}")
    for lv in levels:
        if lv.dtype != torch.float32:
            raise TypeError(f"fast_pyramid takes float32 levels, got {lv.dtype}")
        if lv.dim() != 3 or lv.shape[0] != B or lv.device != dev:
            raise ValueError("fast_pyramid takes (B, H, W) levels of one batch on one device")
        if min(lv.shape[1:]) < 5:
            raise ValueError(f"level {tuple(lv.shape)} is smaller than the 4-px halo allows")
        if not lv.is_contiguous():
            raise ValueError("fast_pyramid takes contiguous levels")


def launch_args(levels, threshold: float):
    """(out, args): a (3, total) float32 buffer for the flat nms, raw and
    blur maps, entry after entry, and the arguments of
    csrc/fast_pyramid.cu::fast_pyramid_launch that fill it, reading each
    level where it lies. The launch makes the tiling and refuses more
    entries than one launch takes."""
    dev, B = levels[0].device, levels[0].shape[0]
    Hs, Ws = _entry_shapes(tuple((lv.shape[1], lv.shape[2]) for lv in levels), B)
    src = (ctypes.c_void_p * len(Hs))(*(lv.data_ptr() + 4 * b * lv.shape[1] * lv.shape[2]
                                         for lv in levels for b in range(B)))
    total = sum(lv.numel() for lv in levels)
    out = torch.empty((3, total), dtype=torch.float32, device=dev)
    p = out.data_ptr()
    return out, (len(Hs), src, Hs, Ws, _GAUSS, float(threshold), p, p + 4 * total,
                 p + 8 * total, torch.cuda.current_stream(dev).cuda_stream)


def _launch_pyramid(levels, threshold: float):
    """One launch of the pyramid kernel over all images x levels; the maps
    are views of one (3, total) buffer."""
    out, args = launch_args(levels, threshold)
    _kernels.check(_kernels.library().fast_pyramid_launch(*args), "fast_pyramid")
    maps = ([], [], [])
    for chunk, lv in zip(out.split([lv.numel() for lv in levels], dim=1), levels):
        for m, x in zip(maps, chunk.view(3, *lv.shape).unbind(0)):
            m.append(x)
    return maps


def fast_pyramid(levels, threshold: float):
    """Per-level (nms, raw, blur) maps of a (B, H_l, W_l) float32 pyramid."""
    levels = list(levels)
    _check_levels(levels)
    if levels[0].device.type == "cpu":
        return fast_pyramid_plain(levels, threshold)
    maps = _launch_pyramid(levels, threshold)
    fast_pyramid.launches += 1
    return maps


def _check_image(img, name):
    if img.dtype != torch.float32:
        raise TypeError(f"{name} takes a float32 image, got {img.dtype}")
    if img.dim() != 2 or not img.is_contiguous():
        raise ValueError(f"{name} takes one contiguous (H, W) image, got {tuple(img.shape)}")
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {img.device}")


def fast_score_nms_raw(img, threshold: float):
    """(nms, raw, blur) maps of one (H, W) float32 image: the pyramid
    kernel's table with one image and one level."""
    _check_image(img, "fast_score_nms_raw")
    _check_levels([img[None]])
    if img.device.type == "cpu":
        return fast_score_nms_raw_plain(img, threshold)
    maps = _launch_pyramid([img[None]], threshold)
    fast_score_nms_raw.launches += 1
    return tuple(m[0][0] for m in maps)


def fast_score_nms(img, threshold: float):
    """The NMS'd FAST score of one (H, W) float32 image, K5 semantics."""
    _check_image(img, "fast_score_nms")
    if img.device.type == "cpu":
        return fast_score_nms_plain(img, threshold)
    H, W = img.shape
    out = torch.empty_like(img)
    rc = _kernels.library().fast_nms_launch(
        img.data_ptr(), H, W, float(threshold), out.data_ptr(),
        torch.cuda.current_stream(img.device).cuda_stream)
    _kernels.check(rc, "fast_score_nms")
    fast_score_nms.launches += 1
    return out


fast_pyramid.launches = 0
fast_score_nms_raw.launches = 0
fast_score_nms.launches = 0
