"""Batched ORB feature extraction (pyramid FAST + IC angle + rotated BRIEF).

Counterpart of orb_slam2_detailed_comments_tpu/ops/orb.py, the replacement
of ORBextractor::operator() (reference: src/ORBextractor.cc:1961-2084):
dense FAST score maps per level, stratified round-robin per-cell top-k in
place of the quadtree, sub-pixel refinement on the raw arc score, the
intensity-centroid angle and a rotated 256-pair BRIEF sampled from the f32
blurred level.

Extraction is batched over a leading image axis: the FAST/NMS/raw/blur
maps of all images x levels come from ONE launch of the fast_pyramid
kernel, and the angles and descriptors of all their keypoints from ONE
launch of the orb_desc kernel, which samples the level and blur maps in
place (no patch tensor). Descriptors are sampled exactly, as the JAX
package's ORB_DESC_ONEHOT=0 form, its specification, samples them; the
one-hot MXU contraction is a TPU device and is not ported.

Tie-breaks are part of the result: lax.top_k and jnp.argsort prefer the
lower index, so both selections here are stable sorts, and the sort key
rank * 1e6 - score is formed in float32 exactly as the JAX package forms it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..utils.config import OrbConfig
from .fast_pyramid import fast_pyramid
from .orb_desc import orb_desc
from .pyramid import build_pyramid, features_per_level, pyramid_shapes

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


def extract_orb(img, config: OrbConfig, n_features: int = 0) -> Keypoints:
    """Extract ORB features from a (H, W) float32 grayscale image in
    [0, 255]; capacity config.max_keypoints (padded, masked). `n_features`
    overrides config.n_features when nonzero (the reference doubles the
    budget during monocular initialization, Tracking.cc:180-182)."""
    return Keypoints(*[a[0] for a in extract_orb_batch(img[None], config, n_features)])


class Detections(NamedTuple):
    """The keypoints of all levels before their angles and descriptors,
    concatenated level by level (level l holds the next counts[l] slots)
    and cut to config.max_keypoints, with the maps orb_desc reads."""
    levels: list            # (B, H_l, W_l) float32 level images
    blur: list              # (B, H_l, W_l) float32 blurred levels (fast_pyramid)
    xy_level: torch.Tensor  # (B, N, 2) int32 level coords (x, y)
    xy: torch.Tensor        # (B, N, 2) float32 level-0 coords, sub-pixel
    response: torch.Tensor  # (B, N) float32
    octave: torch.Tensor    # (B, N) int32
    valid: torch.Tensor     # (B, N) bool
    counts: tuple           # slots per level


def detect_keypoints(imgs, config: OrbConfig, n_features: int = 0) -> Detections:
    """Pyramid, FAST maps (one fast_pyramid launch for all images x
    levels), per-level selection and sub-pixel refinement of a (B, H, W)
    batch. `n_features` as in extract_orb."""
    imgs = imgs.to(torch.float32)
    B, H0, W0 = imgs.shape
    dev = imgs.device
    n_levels = config.n_levels
    min_border = config.edge_threshold - 3  # reference: ORBextractor.cc:1430

    levels = [lv.contiguous() for lv in build_pyramid(imgs, n_levels, config.scale_factor)]
    budgets = features_per_level(n_features or config.n_features, n_levels, config.scale_factor)
    shapes = pyramid_shapes(H0, W0, n_levels, config.scale_factor)
    nms_all, raw_all, blur_all = fast_pyramid(levels, float(config.min_th_fast))

    outs, counts = [], []
    for lv in range(n_levels):
        H, W = shapes[lv]
        budget = int(budgets[lv])
        if budget <= 0:
            counts.append(0)
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

        # half-pixel-correct mapping to level-0 coordinates (pixel centers
        # align under the bilinear resize): x0 = (xl + 0.5) * (W0/Wl) - 0.5
        sxy = torch.tensor([W0 / W, H0 / H], dtype=torch.float32, device=dev)
        n = xy_i.shape[1]
        counts.append(n)
        outs.append((
            xy_i.to(torch.int32),
            (xy_i.to(torch.float32) + subpix + 0.5) * sxy - 0.5,
            resp,
            torch.full((B, n), lv, dtype=torch.int32, device=dev),
            valid,
        ))

    # the slots past max_keypoints are cut before their descriptors
    cap, kept = config.max_keypoints, []
    for n in counts:
        kept.append(min(n, cap - sum(kept)))
    xy_lv, xy, resp, oct_, valid = (torch.cat([o[i] for o in outs], dim=1)[:, :cap].contiguous()
                                    for i in range(5))
    return Detections(levels, blur_all, xy_lv, xy, resp, oct_, valid, tuple(kept))


def extract_orb_batch(imgs, config: OrbConfig, n_features: int = 0) -> Keypoints:
    """Batched extraction over a leading image axis: (B, H, W) -> Keypoints
    with (B, ...) leading dims. The stereo frontend feeds the L/R pair as
    B=2 (the reference runs two extraction threads, Frame.cc:158-164).
    `n_features` as in extract_orb. The angles and descriptors of all
    images x levels come from one orb_desc call."""
    d = detect_keypoints(imgs, config, n_features)
    ang, desc = orb_desc(d.levels, d.blur, d.xy_level, d.valid, d.counts)
    xy, resp, oct_, valid = d.xy, d.response, d.octave, d.valid
    B, n = valid.shape
    cap = config.max_keypoints
    if n < cap:
        xy, resp, oct_, ang, desc, valid = (
            torch.cat([a, a.new_zeros((B, cap - n) + a.shape[2:])], dim=1)
            for a in (xy, resp, oct_, ang, desc, valid))
    return Keypoints(xy=xy, response=resp, octave=oct_, angle=ang, desc=desc, valid=valid)
