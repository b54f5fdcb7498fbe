"""Batched ORB feature extraction (pyramid FAST + IC angle + rotated BRIEF).

Counterpart of orb_slam2_detailed_comments_tpu/ops/orb.py, the replacement
of ORBextractor::operator() (reference: src/ORBextractor.cc:1961-2084):
dense FAST score maps per level, stratified round-robin per-cell top-k in
place of the quadtree, sub-pixel refinement on the raw arc score, the
intensity-centroid angle and a rotated 256-pair BRIEF sampled from the f32
blurred level.

Extraction is batched over a leading image axis: the FAST/NMS/raw/blur
maps of all images x levels come from ONE launch of the fast_pyramid
kernel, and the per-keypoint (2, 39, 39) [raw, blur] patches from the
patch_gather kernel. Descriptors are sampled by an exact gather from the
patch (the JAX package's ORB_DESC_ONEHOT=0 form, its specification; the
one-hot MXU contraction is a TPU device and is not ported).

Tie-breaks are part of the result: lax.top_k and jnp.argsort prefer the
lower index, so both selections here are stable sorts, and the sort key
rank * 1e6 - score is formed in float32 exactly as the JAX package forms it.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.config import OrbConfig
from .fast_pyramid import fast_pyramid
from .hamming import pack_bits
from .patch_gather import patch_gather
from .pattern import brief_pattern, ic_angle_offsets, HALF_PATCH
from .pyramid import build_pyramid, edge_pad, features_per_level, pyramid_shapes

# Patch radius that safely contains the rotated BRIEF pattern
# (pattern offsets are clipped to radius 13; 13*sqrt(2) < 19).
DESC_RADIUS = 19
CELL_TOPK = 16  # max candidates kept per FAST grid cell


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set (octave coords are level-0), optionally
    with a leading image axis. desc holds the 8 uint32 words of each
    256-bit descriptor as an int32 bit-view."""
    xy: torch.Tensor        # (..., N, 2) float32, level-0 pixel coords (x, y)
    response: torch.Tensor  # (..., N) float32 FAST score
    octave: torch.Tensor    # (..., N) int32 pyramid level
    angle: torch.Tensor     # (..., N) float32 radians
    desc: torch.Tensor      # (..., N, 8) int32 packed 256-bit descriptors
    valid: torch.Tensor     # (..., N) bool


def _select_level_keypoints(score, budget: int, cell: int):
    """Stratified round-robin selection of `budget` keypoints per image from
    a (B, H, W) NMS'd score map: every cell's best corner before any cell's
    second. Returns (xy int64 (B, n, 2) as (x, y), response, valid)."""
    B, H, W = score.shape
    dev = score.device
    ch, cw = -(-H // cell), -(-W // cell)
    s = F.pad(score, (0, cw * cell - W, 0, ch * cell - H))
    cells = (s.reshape(B, ch, cell, cw, cell).permute(0, 1, 3, 2, 4)
             .reshape(B, ch * cw, cell * cell))
    k = min(CELL_TOPK, cell * cell)
    vals, idx = torch.sort(cells, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    cell_ids = torch.arange(ch * cw, device=dev)[:, None]
    ranks = torch.arange(k, device=dev).expand(ch * cw, k).reshape(-1)
    ys = ((cell_ids // cw) * cell + idx // cell).reshape(B, -1)
    xs = ((cell_ids % cw) * cell + idx % cell).reshape(B, -1)
    vals = vals.reshape(B, -1)
    cand_valid = vals > 0.0

    # order: (rank asc, score desc); invalid last. scores < 1e6.
    key = ranks.to(torch.float32) * 1e6 - vals
    key = torch.where(cand_valid, key, float("inf"))
    order = torch.sort(key, dim=-1, stable=True).indices[:, :budget]
    return (torch.stack([xs.gather(1, order), ys.gather(1, order)], dim=-1),
            vals.gather(1, order), cand_valid.gather(1, order))


@functools.lru_cache(maxsize=None)
def _desc_constants(device: torch.device):
    """IC-angle weights zero-padded to the 39x39 patch, and the 512 pattern
    offsets (px, py) = ([x0, x1], [y0, y1]), on `device`."""
    mask, xs, ys = ic_angle_offsets()
    pad = DESC_RADIUS - HALF_PATCH
    wx = np.pad(xs * mask, pad).astype(np.float32)
    wy = np.pad(ys * mask, pad).astype(np.float32)
    p = brief_pattern(1234).astype(np.float32)
    px = np.concatenate([p[:, 0], p[:, 2]])
    py = np.concatenate([p[:, 1], p[:, 3]])
    return tuple(torch.from_numpy(a).to(device) for a in (wx, wy, px, py))


def _fused_level_angles_descriptors(raw_img, blurred_img, xy, valid):
    """Orientation + rotated BRIEF for one level's keypoints in one pass.

    raw_img, blurred_img: (B, H, W); xy: (B, n, 2) integer level coords;
    valid: (B, n). Each keypoint takes one (2, 39, 39) [raw, blur] patch
    (patch_gather); the angle is the IC statistic of channel 0 (reference:
    ORBextractor.cc:104-161) and the 256 bits compare gathered channel-1
    samples (reference :177-254)."""
    wx39, wy39, px, py = _desc_constants(raw_img.device)
    r = DESC_RADIUS
    psize = 2 * r + 1
    padded = edge_pad(torch.stack([raw_img, blurred_img], dim=1), r, r).contiguous()
    patches = patch_gather(padded, xy.to(torch.int32).contiguous(), psize)  # (B, n, 2, 39, 39)
    rawp, blurp = patches[:, :, 0], patches[:, :, 1]
    m10 = torch.sum(rawp * wx39, dim=(-2, -1))
    m01 = torch.sum(rawp * wy39, dim=(-2, -1))
    ang = torch.atan2(m01, m10)
    ca, sa = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    dx = torch.round(px * ca - py * sa).to(torch.int64)  # (B, n, 512)
    dy = torch.round(px * sa + py * ca).to(torch.int64)
    v = blurp.reshape(blurp.shape[:2] + (-1,)).gather(-1, (dy + r) * psize + (dx + r))
    desc = pack_bits(v[..., :256] < v[..., 256:])
    ang = torch.where(valid, ang, 0.0)
    desc = torch.where(valid[..., None], desc, 0)
    return ang, desc


def extract_orb(img, config: OrbConfig, n_features: int = 0) -> Keypoints:
    """Extract ORB features from a (H, W) float32 grayscale image in
    [0, 255]; capacity config.max_keypoints (padded, masked). `n_features`
    overrides config.n_features when nonzero (the reference doubles the
    budget during monocular initialization, Tracking.cc:180-182)."""
    return Keypoints(*[a[0] for a in extract_orb_batch(img[None], config, n_features)])


def extract_orb_batch(imgs, config: OrbConfig, n_features: int = 0) -> Keypoints:
    """Batched extraction over a leading image axis: (B, H, W) -> Keypoints
    with (B, ...) leading dims. The stereo frontend feeds the L/R pair as
    B=2 (the reference runs two extraction threads, Frame.cc:158-164).
    `n_features` as in extract_orb."""
    imgs = imgs.to(torch.float32)
    B, H0, W0 = imgs.shape
    dev = imgs.device
    n_levels = config.n_levels
    min_border = config.edge_threshold - 3  # reference: ORBextractor.cc:1430

    levels = [lv.contiguous() for lv in build_pyramid(imgs, n_levels, config.scale_factor)]
    budgets = features_per_level(n_features or config.n_features, n_levels, config.scale_factor)
    shapes = pyramid_shapes(H0, W0, n_levels, config.scale_factor)
    nms_all, raw_all, blur_all = fast_pyramid(levels, float(config.min_th_fast))

    outs = []
    for lv in range(n_levels):
        H, W = shapes[lv]
        budget = int(budgets[lv])
        if budget <= 0:
            continue
        # exclude the descriptor-unsafe border (edge-replicate padding)
        ys2 = torch.arange(H, device=dev)[:, None]
        xs2 = torch.arange(W, device=dev)[None, :]
        inb = ((ys2 >= min_border) & (ys2 < H - min_border)
               & (xs2 >= min_border) & (xs2 < W - min_border))
        score = torch.where(inb, nms_all[lv], 0.0)
        xy_i, resp, valid = _select_level_keypoints(score, budget, config.cell_size)

        # sub-pixel refinement: 1D quadratic fits on the raw arc-score map.
        # Indices are clamped as jnp's gather clamps them (only invalid
        # slots from the cell-grid pad region reach past the image).
        raw_pad = F.pad(raw_all[lv], (1, 1, 1, 1)).reshape(B, -1)
        xs_c = xy_i[..., 0] + 1
        ys_c = xy_i[..., 1] + 1

        def at(yy, xx):
            yy = yy.clamp(0, H + 1)
            xx = xx.clamp(0, W + 1)
            return raw_pad.gather(1, yy * (W + 2) + xx)

        s0 = at(ys_c, xs_c)
        sl = at(ys_c, xs_c - 1)
        sr = at(ys_c, xs_c + 1)
        su = at(ys_c - 1, xs_c)
        sd = at(ys_c + 1, xs_c)
        denx = sl - 2.0 * s0 + sr
        deny = su - 2.0 * s0 + sd
        okx = torch.abs(denx) > 1e-6
        oky = torch.abs(deny) > 1e-6
        dx = torch.where(okx, 0.5 * (sl - sr) / torch.where(okx, denx, 1.0), 0.0)
        dy = torch.where(oky, 0.5 * (su - sd) / torch.where(oky, deny, 1.0), 0.0)
        subpix = torch.stack([dx.clamp(-0.5, 0.5), dy.clamp(-0.5, 0.5)], dim=-1)

        ang, desc = _fused_level_angles_descriptors(
            levels[lv], blur_all[lv], xy_i, valid)

        # half-pixel-correct mapping to level-0 coordinates (pixel centers
        # align under the bilinear resize): x0 = (xl + 0.5) * (W0/Wl) - 0.5
        sxy = torch.tensor([W0 / W, H0 / H], dtype=torch.float32, device=dev)
        n = xy_i.shape[1]
        outs.append((
            (xy_i.to(torch.float32) + subpix + 0.5) * sxy - 0.5,
            resp,
            torch.full((B, n), lv, dtype=torch.int32, device=dev),
            ang,
            desc,
            valid,
        ))

    xy, resp, oct_, ang, desc, valid = (torch.cat([o[i] for o in outs], dim=1)
                                        for i in range(6))
    cap = config.max_keypoints
    n = xy.shape[1]
    if n < cap:
        xy, resp, oct_, ang, desc, valid = (
            torch.cat([a, a.new_zeros((B, cap - n) + a.shape[2:])], dim=1)
            for a in (xy, resp, oct_, ang, desc, valid))
    else:
        xy, resp, oct_, ang, desc, valid = (
            a[:, :cap] for a in (xy, resp, oct_, ang, desc, valid))
    return Keypoints(xy=xy, response=resp, octave=oct_, angle=ang, desc=desc, valid=valid)
