"""The 11x11 SAD refinement of the stereo matcher, in one call.

`stereo_sad(img_l, img_r, xl, yl, xr, idx)` takes the (H, W) float32 left
and right images, the N left keypoints' x and y and the M right keypoints'
x as float32 level-0 coordinates, and each left slot's coarse right match
`idx` (N,) int32. It returns `(u_r, best_sad)`, two (N,) float32 tensors:
the sub-pixel right coordinate (before any ok mask) and the minimum SAD. A
slot whose idx lies outside [0, M) gets NaN in both.

It is the counterpart of the SAD stage of the JAX package's ops/stereo.py::
_stereo_match (reference: Frame.cc:1000-1083) and, inside it, of the TPU
kernel ops/pallas_patch.py::patch_gather at its SAD call site. Per slot:

  - xl_i, yl_i = round(xl), round(yl) and xr_i = round(xr[idx]), clamped
    to the image (round half to even);
  - the 11x11 template of img_l around (xl_i, yl_i) and the 11x21 strip of
    img_r around (xr_i, yl_i), read at clamp(x + d) and clamp(y + d): the
    windows of the edge-padded images at those centres;
  - each minus its centre pixel (Frame.cc:1020-1033);
  - the 11 SADs of the template against the strip at offsets 0..10;
  - the first minimum, and the parabola through the minimum's neighbours
    (the minimum kept off the ends), delta clamped to +-1:
    u_r = xr_i + (best - 5) + delta.

The SADs are summed in a fixed order, which the CUDA kernel repeats: per
template column, `acc + |t - s|` down the 11 rows, then a halving tree over
the columns padded to 16. For CUDA tensors `stereo_sad` launches
csrc/stereo_sad.cu once; it reads the images in place and writes no window.
For CPU tensors it runs `stereo_sad_plain`, with which the kernel agrees bit
for bit on the card. `stereo_sad.launches` counts kernel launches.
"""
from __future__ import annotations

import torch

from . import _kernels

SAD_HALF = 5   # 11x11 window (reference: Frame.cc w=5)
SLIDE = 5      # +-5 px search (reference: Frame.cc L=5)
TREE = 16      # template columns padded to a power of 2 for the column tree


def round_clamp(x, n: int):
    """Pixel index of float coordinates: round half to even, clamp to [0, n)."""
    return torch.clamp(torch.round(x).to(torch.int32), 0, n - 1)


def sad_windows(img_l, img_r, xl_i, yl_i, xr_i):
    """The (N, 11, 11) template of img_l around (xl_i, yl_i) and the
    (N, 11, 21) strip of img_r around (xr_i, yl_i), read at edge-clamped
    indices, not normalised."""
    H, W = img_l.shape
    d = torch.arange(-SAD_HALF, SAD_HALF + 1, device=img_l.device)
    ds = torch.arange(-SAD_HALF - SLIDE, SAD_HALF + SLIDE + 1, device=img_l.device)
    rows = (yl_i[:, None] + d).clamp(0, H - 1)[:, :, None]
    tmpl = img_l[rows, (xl_i[:, None] + d).clamp(0, W - 1)[:, None, :]]
    strip = img_r[rows, (xr_i[:, None] + ds).clamp(0, W - 1)[:, None, :]]
    return tmpl, strip


def sad_curve(tmpl, strip):
    """(N, 11) SADs of centre-normalised windows at offsets 0..10, in the
    fixed order: per template column, acc = acc + |t - s| down the rows,
    then the halving tree x[:h] + x[h:2h], h = 8, 4, 2, 1, over the columns
    padded to 16 (the kernel's lane sums and shuffle tree)."""
    n = 2 * SAD_HALF + 1
    t = tmpl - tmpl[:, SAD_HALF:SAD_HALF + 1, SAD_HALF:SAD_HALF + 1]
    s = strip - strip[:, SAD_HALF:SAD_HALF + 1, SAD_HALF + SLIDE:SAD_HALF + SLIDE + 1]
    diffs = torch.stack([torch.abs(t - s[:, :, o:o + n]) for o in range(2 * SLIDE + 1)], -1)
    acc = torch.zeros_like(diffs[:, 0])                     # (N, column, offset)
    for r in range(n):
        acc = acc + diffs[:, r]
    acc = torch.cat([acc, acc.new_zeros((acc.shape[0], TREE - n, acc.shape[2]))], dim=1)
    h = TREE // 2
    while h >= 1:
        acc = acc[:, :h] + acc[:, h:2 * h]
        h //= 2
    return acc[:, 0]


def parabola(sads, xr_i):
    """(u_r, best_sad) from (N, 11) SADs: the first minimum, and the
    parabola through its neighbours (reference: Frame.cc:1070-1083)."""
    best_off = torch.argmin(sads, dim=-1)          # first minimum, as jnp.argmin
    best_sad = sads.gather(1, best_off[:, None])[:, 0]
    om = torch.clamp(best_off, 1, 2 * SLIDE - 1)
    s_m1 = sads.gather(1, (om - 1)[:, None])[:, 0]
    s_0 = sads.gather(1, om[:, None])[:, 0]
    s_p1 = sads.gather(1, (om + 1)[:, None])[:, 0]
    denom = s_m1 + s_p1 - 2.0 * s_0
    delta = torch.where(torch.abs(denom) > 1e-6,
                        (s_m1 - s_p1) / (2.0 * torch.clamp(denom, min=1e-6)), 0.0)
    delta = torch.clamp(delta, -1.0, 1.0)
    u_r = xr_i.to(torch.float32) + (om - SLIDE).to(torch.float32) + delta
    return u_r, best_sad


def stereo_sad_plain(img_l, img_r, xl, yl, xr, idx):
    """Plain PyTorch version: sad_windows, sad_curve, parabola."""
    H, W = img_l.shape
    M = xr.shape[0]
    bad = (idx < 0) | (idx >= M)
    xr_i = round_clamp(xr[idx.clamp(0, M - 1).long()], W)
    tmpl, strip = sad_windows(img_l, img_r, round_clamp(xl, W), round_clamp(yl, H), xr_i)
    u_r, best_sad = parabola(sad_curve(tmpl, strip), xr_i)
    return torch.where(bad, float("nan"), u_r), torch.where(bad, float("nan"), best_sad)


def _check_inputs(img_l, img_r, xl, yl, xr, idx):
    for name, x in (("img_l", img_l), ("img_r", img_r), ("xl", xl), ("yl", yl), ("xr", xr)):
        if x.dtype != torch.float32:
            raise TypeError(f"stereo_sad takes float32 {name}, got {x.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"stereo_sad takes int32 idx, got {idx.dtype}")
    if img_l.dim() != 2 or img_r.shape != img_l.shape or min(img_l.shape) < 1:
        raise ValueError(f"stereo_sad takes two (H, W) images of one shape, got "
                         f"{tuple(img_l.shape)} and {tuple(img_r.shape)}")
    N = xl.shape[0] if xl.dim() == 1 else -1
    if N < 0 or tuple(yl.shape) != (N,) or tuple(idx.shape) != (N,) or xr.dim() != 1 \
            or xr.shape[0] < 1:
        raise ValueError(f"stereo_sad shapes: xl {tuple(xl.shape)}, yl {tuple(yl.shape)}, "
                         f"xr {tuple(xr.shape)}, idx {tuple(idx.shape)}")
    dev = img_l.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"stereo_sad runs on cpu or cuda, not {dev}")
    tensors = (img_l, img_r, xl, yl, xr, idx)
    if any(x.device != dev for x in tensors):
        raise ValueError("stereo_sad takes its tensors on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("stereo_sad takes contiguous tensors")


def stereo_sad(img_l, img_r, xl, yl, xr, idx):
    """(u_r, best_sad), each (N,) float32; see the module doc."""
    _check_inputs(img_l, img_r, xl, yl, xr, idx)
    if img_l.device.type == "cpu":
        return stereo_sad_plain(img_l, img_r, xl, yl, xr, idx)
    H, W = img_l.shape
    N, dev = xl.shape[0], img_l.device
    u_r = torch.empty((N,), dtype=torch.float32, device=dev)
    best_sad = torch.empty((N,), dtype=torch.float32, device=dev)
    rc = _kernels.library().stereo_sad_launch(
        img_l.data_ptr(), img_r.data_ptr(), H, W, xl.data_ptr(), yl.data_ptr(), xr.data_ptr(),
        xr.shape[0], idx.data_ptr(), N, u_r.data_ptr(), best_sad.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(rc, "stereo_sad")
    stereo_sad.launches += 1
    return u_r, best_sad


stereo_sad.launches = 0
