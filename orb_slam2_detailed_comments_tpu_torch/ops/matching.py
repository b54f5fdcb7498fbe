"""Projection-guided descriptor matching.

Counterpart of orb_slam2_detailed_comments_tpu/ops/matching.py without
its unused helpers: the replacements of ORBmatcher::SearchByProjection
(reference: src/ORBmatcher.cc:69-184), of SearchByBoW's role (brute-force
matching, :248-419), of SearchForInitialization (:570-722) and of
SearchForTriangulation (:879-1096). The full masked Hamming matrix, every
candidate policy expressed as a boolean mask, best/second-best with the
ratio test, the rotation histogram, and one source per target. Ties go to
the lower index, as jnp.argmin and lax.top_k break them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .hamming import hamming_distance_matrix

INF_DIST = 1 << 20
TH_LOW = 50     # reference: ORBmatcher.cc:49
TH_HIGH = 100   # reference: ORBmatcher.cc:50
HISTO_BINS = 30  # reference: ORBmatcher.cc:51


class MatchResult(NamedTuple):
    idx: torch.Tensor   # (A,) int32 best match in B for each A (undefined if !ok)
    dist: torch.Tensor  # (A,) int32 best Hamming distance
    ok: torch.Tensor    # (A,) bool


def masked_best_match(dist, mask, max_dist: int, ratio: float = 0.0,
                      ratio_same_level_only=None, octave_b=None):
    """Best + second-best search over a masked (A, B) int32 distance matrix.
    argmin takes the first index on ties, as jnp.argmin does. ratio > 0
    requires best < ratio * second (ORBmatcher.cc:560-566); with
    ratio_same_level_only and octave_b only when best and second share an
    octave (ORBmatcher.cc:165-171)."""
    d = torch.where(mask, dist, INF_DIST)
    rows = torch.arange(d.shape[0], device=d.device)
    best_idx = torch.argmin(d, dim=1)
    best = d[rows, best_idx]
    d2 = d.clone()
    d2[rows, best_idx] = INF_DIST
    second_idx = torch.argmin(d2, dim=1)
    second = d2[rows, second_idx]

    ok = best <= max_dist
    if ratio > 0.0:
        pass_ratio = best.to(torch.float32) < ratio * second.to(torch.float32)
        if ratio_same_level_only and octave_b is not None:
            same_level = octave_b[best_idx] == octave_b[second_idx]
            pass_ratio = pass_ratio | ~same_level | (second >= INF_DIST)
        else:
            pass_ratio = pass_ratio | (second >= INF_DIST)
        ok = ok & pass_ratio
    return MatchResult(idx=best_idx.to(torch.int32), dist=best.to(torch.int32), ok=ok)


def resolve_duplicate_targets(match: MatchResult, n_targets: int):
    """Keep at most one source per target: the one with the smallest
    distance, ties broken by source index (key = dist * A + src, dist
    clipped to 257 so the key fits int32). A deterministic scatter-amin."""
    a = match.idx.shape[0]
    src_ids = torch.arange(a, dtype=torch.int32, device=match.idx.device)
    big = 1 << 30
    key = torch.where(match.ok, torch.clamp(match.dist, max=257) * a + src_ids, big)
    tgt = match.idx.long()
    best_key = torch.full((n_targets,), big, dtype=key.dtype, device=key.device)
    best_key = best_key.scatter_reduce(0, tgt, key, reduce="amin")
    keep = match.ok & (key == best_key[tgt])
    return MatchResult(idx=match.idx, dist=match.dist, ok=keep)


def rotation_consistency(angle_a, angle_b_of_match, ok, top_k: int = 3):
    """Rotation-histogram filter (reference: ORBmatcher::ComputeThreeMaxima,
    ORBmatcher.cc:2026-2068): keep only matches whose angle difference falls
    in the top-3 most-populated of 30 bins; bins 2-3 are dropped when they
    hold < 10% of the max bin. Equal bins rank by lower index (a stable
    descending sort), as lax.top_k ranks them."""
    two_pi = 2.0 * math.pi
    diff = torch.remainder(angle_a - angle_b_of_match, two_pi)
    bins = torch.clamp((diff * (HISTO_BINS / two_pi)).to(torch.int32), 0, HISTO_BINS - 1).long()
    hist = torch.zeros(HISTO_BINS, dtype=torch.int32, device=bins.device)
    hist = hist.index_add(0, bins, ok.to(torch.int32))
    top_vals, top_idx = torch.sort(hist, descending=True, stable=True)
    keep_bin = torch.zeros(HISTO_BINS, dtype=torch.bool, device=bins.device)
    keep_bin[top_idx[0]] = True
    for i in range(1, top_k):
        keep_bin[top_idx[i]] = (top_vals[i].to(torch.float32)
                                >= 0.1 * top_vals[0].to(torch.float32))
    return ok & keep_bin[bins]


def match_descriptors(desc_a, valid_a, desc_b, valid_b, angle_a=None, angle_b=None,
                      max_dist: int = TH_LOW, ratio: float = 0.75):
    """Generic all-pairs matcher A->B with ratio + rotation filters (the
    rotation filter where both angle sets are given). Returns MatchResult
    over A (deduplicated per target in B)."""
    dist = hamming_distance_matrix(desc_a, desc_b)
    mask = valid_a[:, None] & valid_b[None, :]
    m = masked_best_match(dist, mask, max_dist, ratio)
    if angle_a is not None and angle_b is not None:
        m = MatchResult(m.idx, m.dist,
                        rotation_consistency(angle_a, angle_b[m.idx.long()], m.ok))
    return resolve_duplicate_targets(m, desc_b.shape[0])


def search_for_initialization(xy_a, desc_a, valid_a, octave_a, angle_a,
                              xy_b, desc_b, valid_b, octave_b, angle_b,
                              window: float = 100.0, ratio: float = 0.9):
    """Windowed level-0 matching for monocular initialization
    (reference: ORBmatcher::SearchForInitialization, ORBmatcher.cc:570-722:
    radius-100 window around the level-0 keypoints, ratio 0.9, TH_LOW,
    rotation check)."""
    du = torch.abs(xy_a[:, None, 0] - xy_b[None, :, 0])
    dv = torch.abs(xy_a[:, None, 1] - xy_b[None, :, 1])
    mask = (
        valid_a[:, None] & valid_b[None, :]
        & (octave_a[:, None] == 0) & (octave_b[None, :] == 0)
        & (du <= window) & (dv <= window)
    )
    dist = hamming_distance_matrix(desc_a, desc_b)
    m = masked_best_match(dist, mask, TH_LOW, ratio)
    m = MatchResult(m.idx, m.dist, rotation_consistency(angle_a, angle_b[m.idx.long()], m.ok))
    return resolve_duplicate_targets(m, desc_b.shape[0])


def predict_scale_level(dist, max_dist, n_levels: int, log_scale: float):
    """MapPoint::PredictScale (reference: src/MapPoint.cc:676-721):
    level = ceil(log(max_dist / dist) / log(scaleFactor)), clipped."""
    ratio = max_dist / torch.clamp(dist, min=1e-9)
    lvl = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / log_scale).to(torch.int32)
    return torch.clamp(lvl, 0, n_levels - 1)


class ProjectedPoints(NamedTuple):
    uv: torch.Tensor          # (P, 2) projected pixel coords
    ur: torch.Tensor          # (P,) right-image u (stereo) or 0
    depth: torch.Tensor       # (P,) camera-frame z
    pred_level: torch.Tensor  # (P,) predicted octave
    view_cos: torch.Tensor    # (P,) cos(viewing angle)
    visible: torch.Tensor     # (P,) bool frustum + scale + viewcos test


def project_and_cull(pts_w, valid, normals, min_dist, max_dist, Tcw, cam,
                     n_levels: int, log_scale: float, view_cos_limit: float = 0.5):
    """Frame::isInFrustum for a batch of map points
    (reference: src/Frame.cc:529-620; by default the viewing angle must be
    under 60 degrees, view_cos_limit=0.5)."""
    R = Tcw[:3, :3]
    t = Tcw[:3, 3]
    pc = pts_w @ R.T + t
    z = pc[:, 2]
    zc = torch.clamp(z, min=1e-9)
    uv = torch.stack([cam.fx * pc[:, 0] / zc + cam.cx,
                      cam.fy * pc[:, 1] / zc + cam.cy], dim=-1)
    ur = uv[:, 0] - cam.bf / zc
    Ow = -R.T @ t
    po = pts_w - Ow
    dist = torch.linalg.norm(po, dim=-1)
    view_cos = torch.sum(po * normals, dim=-1) / torch.clamp(dist, min=1e-9)
    visible = (
        valid
        & (z > 0.0)
        & (uv[:, 0] >= 0.0) & (uv[:, 0] < cam.width)
        & (uv[:, 1] >= 0.0) & (uv[:, 1] < cam.height)
        & (dist >= 0.8 * min_dist) & (dist <= 1.2 * max_dist)
        & (view_cos > view_cos_limit)
    )
    lvl = predict_scale_level(dist, max_dist, n_levels, log_scale)
    return ProjectedPoints(uv=uv, ur=ur, depth=z, pred_level=lvl,
                           view_cos=view_cos, visible=visible)


def search_by_projection(proj: ProjectedPoints, desc_p, kp_xy, kp_ur, desc_k,
                         valid_k, octave_k, scale_factors, th: float = 1.0,
                         max_dist: int = TH_HIGH, ratio: float = 0.8,
                         check_stereo: bool = False):
    """Match projected map points to frame keypoints within a scale-dependent
    window (ORBmatcher.cc:69-184): radius 2.5 if viewCos > 0.998 else 4.0
    (RadiusByViewingCos, :190-199), times th, times the predicted level's
    scale factor, and octaves within one of the predicted level. Returns
    MatchResult over points P (targets = keypoints, deduplicated)."""
    base_r = torch.where(proj.view_cos > 0.998, 2.5, 4.0) * th
    r = base_r * scale_factors[proj.pred_level.long()]  # (P,)
    du = torch.abs(proj.uv[:, None, 0] - kp_xy[None, :, 0])
    dv = torch.abs(proj.uv[:, None, 1] - kp_xy[None, :, 1])
    lvl_lo = proj.pred_level - 1
    lvl_hi = proj.pred_level + 1
    mask = (
        proj.visible[:, None] & valid_k[None, :]
        & (du <= r[:, None]) & (dv <= r[:, None])
        & (octave_k[None, :] >= lvl_lo[:, None]) & (octave_k[None, :] <= lvl_hi[:, None])
    )
    if check_stereo:
        dur = torch.abs(proj.ur[:, None] - kp_ur[None, :])
        has_stereo = kp_ur[None, :] >= 0
        mask = mask & (torch.where(has_stereo, dur, 0.0) <= r[:, None])
    dist = hamming_distance_matrix(desc_p, desc_k)
    m = masked_best_match(dist, mask, max_dist, ratio, ratio_same_level_only=True,
                          octave_b=octave_k)
    return resolve_duplicate_targets(m, kp_xy.shape[0])


# ---------------------------------------------------------------------------
# Epipolar-constrained matching for triangulation
# (reference: ORBmatcher::SearchForTriangulation, ORBmatcher.cc:879-1096,
#  with CheckDistEpipolarLine :206-233).
# ---------------------------------------------------------------------------

def search_for_triangulation(xy1, desc1, valid1, octave1, angle1, has_mp1,
                             xy2, desc2, valid2, octave2, angle2, has_mp2,
                             F12, epipole2_uv, sigma2_levels):
    """Match unmatched keypoints of KF1 to KF2 along the epipolar line,
    with the rotation check (the JAX package's check_rotation=True, the
    value every caller uses).

    F12: (3,3) fundamental matrix mapping KF1 pixels to epipolar lines in
    KF2. epipole2_uv: (2,) projection of KF1's center in KF2 (candidates
    too close to it are rejected, reference :975-984).
    sigma2_levels: (n_levels,) per-level sigma^2.
    """
    ones = torch.ones_like(xy1[:, :1])
    x1h = torch.cat([xy1, ones], dim=-1)  # (N1, 3)
    lines = x1h @ F12.T  # (N1, 3) epipolar lines in image 2
    a, b, c = lines[:, 0:1], lines[:, 1:2], lines[:, 2:3]
    num = a * xy2[None, :, 0] + b * xy2[None, :, 1] + c  # (N1, N2)
    den2 = a * a + b * b
    dsq = num * num / torch.clamp(den2, min=1e-12)
    # chi2 threshold 3.84 * sigma^2 of the observation level (reference :228-232)
    s2 = sigma2_levels[octave2.long()]
    epi_ok = dsq < 3.84 * s2[None, :]
    # reject kp2 near the epipole (reference :981: 100 sigma^2 on the
    # squared distance)
    de = torch.sum((xy2 - epipole2_uv[None, :]) ** 2, dim=-1)
    far_from_epipole = de >= 100.0 * s2

    mask = (
        valid1[:, None] & valid2[None, :]
        & (~has_mp1)[:, None] & (~has_mp2)[None, :]
        & epi_ok & far_from_epipole[None, :]
    )
    dist = hamming_distance_matrix(desc1, desc2)
    m = masked_best_match(dist, mask, TH_LOW, 0.0)
    m = MatchResult(m.idx, m.dist, rotation_consistency(angle1, angle2[m.idx.long()], m.ok))
    return resolve_duplicate_targets(m, xy2.shape[0])
